"""Forward and backward trellis kernel (one body, two grid rows) vs core.

Interpret mode on the CPU; ``chip_smoke.py`` checks the compiled kernel
on the GPU at real widths.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_hmm_tpu import ops
from pytorch_hmm_tpu.core.fb import forward_backward
from pytorch_hmm_tpu.ops import auto_forward_backward
from pytorch_hmm_tpu.ops.trellis import trellis_forward_backward

fbsum_smallk = functools.partial(trellis_forward_backward, interpret=True)


def _problem(rng, B, T, S):
    lo = jnp.asarray(rng.normal(size=(B, T, S)), jnp.float32)
    la = jax.nn.log_softmax(
        jnp.asarray(rng.normal(size=(S, S)), jnp.float32), axis=-1
    )
    lpi = jax.nn.log_softmax(jnp.asarray(rng.normal(size=(S,)), jnp.float32))
    return lo, la, lpi


@pytest.mark.parametrize(
    "B,T,S",
    [(3, 257, 5), (16, 250, 12), (2, 128, 4), (1, 50, 3), (4, 129, 16),
     (2, 300, 16)],
)
def test_fbsum_matches_core(rng, B, T, S):
    lo, la, lpi = _problem(rng, B, T, S)
    a1, b1, z1 = fbsum_smallk(lo, la, lpi)
    _, a0, b0, z0 = forward_backward(lo, la, lpi)
    np.testing.assert_allclose(a1, a0, atol=2e-4)
    np.testing.assert_allclose(b1, b0, atol=2e-4)
    np.testing.assert_allclose(z1, z0, atol=2e-4)


@pytest.mark.parametrize(
    "B,T,S,lens",
    [
        (3, 257, 5, (257, 100, 31)),
        (4, 130, 12, (130, 128, 64, 1)),
        (2, 300, 16, (299, 177)),
    ],
)
def test_fbsum_ragged_matches_core(rng, B, T, S, lens):
    """Ragged rows freeze past their end: valid frames and per-row log_z
    match the core masked scan, and the frozen frames match it too."""
    lo, la, lpi = _problem(rng, B, T, S)
    lengths = jnp.asarray(lens, jnp.int32)
    a1, b1, z1 = fbsum_smallk(lo, la, lpi, lengths)
    _, a0, b0, z0 = forward_backward(lo, la, lpi, lengths)
    np.testing.assert_allclose(z1, z0, atol=2e-4)
    np.testing.assert_allclose(a1, a0, atol=2e-4)
    np.testing.assert_allclose(b1, b0, atol=2e-4)


def test_fbsum_ragged_equals_unragged_at_full_length(rng):
    """lengths == T reproduces the unragged call bit-for-bit (same
    recursion, the freeze never fires)."""
    B, T, S = 2, 129, 8
    lo, la, _ = _problem(rng, B, T, S)
    lpi = jnp.full((S,), -jnp.log(float(S)))
    a0, b0, z0 = fbsum_smallk(lo, la, lpi)
    a1, b1, z1 = fbsum_smallk(lo, la, lpi, jnp.full((B,), T, jnp.int32))
    np.testing.assert_array_equal(np.asarray(a0), np.asarray(a1))
    np.testing.assert_array_equal(np.asarray(b0), np.asarray(b1))
    np.testing.assert_allclose(z0, z1, atol=1e-6)


def test_ragged_ll_grad_matches_core(rng, kernel_dispatch):
    """auto_log_likelihood with lengths (the kernel's closed-form VJP)
    must match core grads."""
    from pytorch_hmm_tpu.core import log_likelihood as core_ll

    B, T, K = 3, 90, 6
    lo, la, _ = _problem(rng, B, T, K)
    lpi = jnp.full((K,), -jnp.log(float(K)))
    lengths = jnp.asarray([90, 60, 17], jnp.int32)
    g1 = jax.grad(
        lambda x: jnp.sum(ops.auto_log_likelihood(x, la, lpi, lengths))
    )(lo)
    g0 = jax.grad(
        lambda x: jnp.sum(core_ll(x, la, lpi, lengths))
    )(lo)
    np.testing.assert_allclose(g1, g0, atol=1e-4)


def test_forward_only_row_matches_both_rows(rng):
    """``backward=False`` runs only the forward grid row; its alpha is
    the same as with both rows."""
    lo, la, lpi = _problem(rng, 3, 77, 6)
    a1, b1, z1 = fbsum_smallk(lo, la, lpi, backward=False)
    a2, _, z2 = fbsum_smallk(lo, la, lpi)
    assert b1 is None
    np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
    np.testing.assert_array_equal(np.asarray(z1), np.asarray(z2))


def test_fbsum_under_outer_jit(rng, kernel_dispatch):
    """The auto path stays jit-composable with closed-over transitions."""
    lo, la, _ = _problem(rng, 2, 64, 4)
    lpi = jnp.full((4,), -jnp.log(4.0))

    @jax.jit
    def f(x):
        lg, a, b, z = auto_forward_backward(x, la, lpi)
        return jnp.sum(lg) + jnp.sum(z)

    assert np.isfinite(float(f(lo)))


@pytest.mark.parametrize("B,T,K", [(2, 256, 16), (3, 384, 64), (2, 130, 32)])
def test_fb_matches_core_wider_states(rng, B, T, K):
    lo, la, lpi = _problem(rng, B, T, K)
    a1, b1, z1 = fbsum_smallk(lo, la, lpi)
    _, a0, b0, z0 = forward_backward(lo, la, lpi)
    np.testing.assert_allclose(a1, a0, atol=2e-3)
    np.testing.assert_allclose(b1, b0, atol=2e-3)
    np.testing.assert_allclose(z1, z0, atol=2e-3)


def test_ll_grad_long_context_matches_short_formula(rng, kernel_dispatch):
    """The kernel VJP's gradient (posteriors) equals the core gradient."""
    from pytorch_hmm_tpu.core import log_likelihood as core_ll

    B, T, K = 2, 64, 6
    lo, la, _ = _problem(rng, B, T, K)
    lpi = jnp.full((K,), -jnp.log(float(K)))
    g1 = jax.grad(lambda x: jnp.sum(ops.auto_log_likelihood(x, la, lpi)))(lo)
    g0 = jax.grad(lambda x: jnp.sum(core_ll(x, la, lpi)))(lo)
    np.testing.assert_allclose(g1, g0, atol=1e-4)


def test_ll_grad_weighted_cotangent(rng, kernel_dispatch):
    """A non-uniform cotangent reaches every row's gradient (the VJP
    scales gamma and xi by g per sequence), for all three inputs."""
    from pytorch_hmm_tpu.core import log_likelihood as core_ll

    lo, la, lpi = _problem(rng, 3, 40, 5)
    w = jnp.asarray([1.0, -2.0, 0.5])
    lengths = jnp.asarray([40, 21, 3], jnp.int32)
    g1 = jax.grad(
        lambda *x: jnp.sum(w * ops.auto_log_likelihood(*x, lengths)),
        argnums=(0, 1, 2))(lo, la, lpi)
    g0 = jax.grad(
        lambda *x: jnp.sum(w * core_ll(*x, lengths)),
        argnums=(0, 1, 2))(lo, la, lpi)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.mark.parametrize("offset", [0.0, -300.0])
def test_em_statistics_match_float64(rng, kernel_dispatch, offset):
    """The kernel E-step (``auto_em_statistics``) against a float64
    forward-backward. An offset of -300 per frame takes raw log-alpha to
    ~-1e5, as at speech shapes; the per-frame shift keeps gamma and xi at
    float32 precision there."""
    from oracle import backward as oracle_backward
    from oracle import forward as oracle_forward

    B, T, K = 2, 300, 6
    lo, la, lpi = _problem(rng, B, T, K)
    lo = lo + offset
    lg, xi, lz = ops.auto_em_statistics(lo, la, lpi)
    la64, lpi64 = np.asarray(la, np.float64), np.asarray(lpi, np.float64)
    for b in range(B):
        lo64 = np.asarray(lo[b], np.float64)
        a, z = oracle_forward(lo64, la64, lpi64)
        beta = oracle_backward(lo64, la64)
        gamma = np.exp(a + beta - z)
        xi64 = np.exp(a[:-1, :, None] + la64 + (lo64 + beta)[1:, None, :]
                      - z).sum(axis=0)
        np.testing.assert_allclose(np.exp(lg[b]), gamma, atol=5e-5)
        np.testing.assert_allclose(xi[b], xi64, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(lz[b], z, rtol=1e-6, atol=1e-3)
