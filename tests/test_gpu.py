"""Trellis kernels compiled for the GPU (no interpret mode) vs ``core``.

These need a card: each skips here with a reason, decided in the ``gpu``
fixture. On a machine with one, run them with
``JAX_PLATFORMS=cuda python -m pytest -n 0 -m gpu tests/test_gpu.py``;
``python chip_smoke.py`` checks the same kernels at full width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_hmm_tpu import core, ops

from oracle import posteriors as oracle_posteriors

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the Triton kernels have no CPU compile")


def _problem(B, T, K, seed=0):
    rng = np.random.default_rng(seed)
    lo = jnp.asarray(rng.normal(size=(B, T, K)) * 3 - 50, jnp.float32)
    la = jnp.asarray(np.log(rng.dirichlet(np.ones(K), size=K)), jnp.float32)
    lp = jnp.asarray(np.log(rng.dirichlet(np.ones(K))), jnp.float32)
    lengths = jnp.asarray(rng.integers(1, T + 1, size=B), jnp.int32)
    return lo, la, lp, lengths


@pytest.mark.parametrize("K", [12, 64, 128])
def test_compiled_viterbi_is_exact(gpu, K):
    lo, la, lp, lengths = _problem(8, 300, K)
    for lens in (None, lengths):
        s, sc = ops.trellis_viterbi(lo, la, lp, lens)
        s0, sc0 = core.viterbi(lo, la, lp, lens)
        np.testing.assert_array_equal(s, s0)
        np.testing.assert_array_equal(sc, sc0)


@pytest.mark.parametrize("K", [12, 64, 128])
def test_compiled_forward_backward(gpu, K):
    lo, la, lp, lengths = _problem(8, 300, K)
    a, b, z = ops.trellis_forward_backward(lo, la, lp, lengths)
    a0, z0 = core.forward_log(lo, la, lp, lengths)
    b0 = core.backward_log(lo, la, lengths)
    np.testing.assert_allclose(a, a0, rtol=1e-5)
    np.testing.assert_allclose(b, b0, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(z, z0, rtol=1e-5)


def test_compiled_likelihood_gradient(gpu):
    """d log Z / d log_obs is the posterior: against the float64 oracle
    at 1e-4, and against autodiff through the float32 scan (which is
    itself ~4e-4 off the oracle at this shape) at 1e-3."""
    lo, la, lp, lengths = _problem(4, 200, 12)
    g = jax.grad(lambda x: jnp.sum(ops.auto_log_likelihood(x, la, lp,
                                                           lengths)))(lo)
    g0 = jax.grad(lambda x: jnp.sum(core.log_likelihood(x, la, lp,
                                                        lengths)))(lo)
    g64 = np.zeros(lo.shape)
    for b, n in enumerate(np.asarray(lengths)):
        g64[b, :n] = oracle_posteriors(
            *(np.asarray(x, np.float64) for x in (lo[b, :n], la, lp)))[0]
    np.testing.assert_allclose(g, g64, atol=1e-4)
    np.testing.assert_allclose(g, g0, atol=1e-3)


def test_compiled_em_statistics(gpu):
    """The E-step's gamma and xi at raw log-alpha ~-1e5 against a float64
    forward-backward. The per-frame shift leaves the recursions at ~5e3,
    where gamma is ~3e-4 off; from raw log-alphas (``core``) gamma is
    ~6e-3 off and xi ~1e-1 (CPU, same shape)."""
    from oracle import backward as oracle_backward
    from oracle import forward as oracle_forward

    lo, la, lp, _ = _problem(4, 2000, 12)
    lg, xi, lz = ops.auto_em_statistics(lo, la, lp)
    la64, lp64 = np.asarray(la, np.float64), np.asarray(lp, np.float64)
    for b in range(lo.shape[0]):
        lo64 = np.asarray(lo[b], np.float64)
        a, z = oracle_forward(lo64, la64, lp64)
        beta = oracle_backward(lo64, la64)
        xi64 = np.exp(a[:-1, :, None] + la64 + (lo64 + beta)[1:, None, :]
                      - z).sum(axis=0)
        np.testing.assert_allclose(np.exp(lg[b]), np.exp(a + beta - z),
                                   atol=1e-3)
        np.testing.assert_allclose(xi[b], xi64, rtol=1e-3)
        np.testing.assert_allclose(lz[b], z, rtol=1e-6)
