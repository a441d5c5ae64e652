"""Trellis kernels (``ops.trellis``) and their dispatch (``ops``).

The Pallas-Triton kernels run here in interpret mode on the CPU; the same
kernel bodies compile for the GPU, where ``chip_smoke.py`` checks them at
real widths. ``kernel_dispatch`` makes the ``ops.auto_*`` entry points
choose the kernels as they do on the GPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_hmm_tpu import core, ops
from pytorch_hmm_tpu.ops import auto_forward, auto_viterbi
from pytorch_hmm_tpu.ops.trellis import (
    padded_states,
    trellis_forward_backward,
    trellis_viterbi,
)

from oracle import forward as oracle_forward
from oracle import viterbi as oracle_viterbi

pallas_viterbi = functools.partial(trellis_viterbi, interpret=True)
pallas_fb = functools.partial(trellis_forward_backward, interpret=True)


def pallas_forward(lo, la, lp, lengths=None, **kw):
    a, _, lz = pallas_fb(lo, la, lp, lengths, backward=False, **kw)
    return a, lz


def pallas_backward(lo, la, lengths=None, **kw):
    K = lo.shape[-1]
    lp = jnp.zeros((K,), jnp.float32)
    return pallas_fb(lo, la, lp, lengths, **kw)[1]


@pytest.fixture(
    scope="module",
    params=[(5, 300, 11), (20, 257, 64), (3, 64, 5), (2, 48, 128)],
)
def problem(request):
    B, T, K = request.param
    rng = np.random.default_rng(B * T)
    lo = jnp.asarray(rng.normal(size=(B, T, K)), jnp.float32)
    la = jnp.asarray(np.log(rng.dirichlet(np.ones(K), size=K)), jnp.float32)
    lp = jnp.asarray(np.log(rng.dirichlet(np.ones(K))), jnp.float32)
    return lo, la, lp


@pytest.fixture(scope="module")
def ragged_problem():
    B, T, K = 5, 90, 9
    rng = np.random.default_rng(7)
    lo = jnp.asarray(rng.normal(size=(B, T, K)), jnp.float32)
    la = jnp.asarray(np.log(rng.dirichlet(np.ones(K), size=K)), jnp.float32)
    lp = jnp.asarray(np.log(rng.dirichlet(np.ones(K))), jnp.float32)
    lengths = jnp.asarray([90, 31, 64, 1, 77], jnp.int32)
    return lo, la, lp, lengths


def test_pallas_forward_matches_core(problem):
    lo, la, lp = problem
    a_p, lz_p = pallas_forward(lo, la, lp)
    a0, lz0 = core.forward_log(lo, la, lp)
    np.testing.assert_allclose(a_p, a0, atol=5e-4)
    np.testing.assert_allclose(lz_p, lz0, atol=5e-4)


def test_pallas_backward_matches_core(problem):
    lo, la, lp = problem
    b_p = pallas_backward(lo, la)
    b0 = core.backward_log(lo, la)
    np.testing.assert_allclose(b_p, b0, atol=5e-4)


def test_pallas_viterbi_matches_core(problem):
    lo, la, lp = problem
    s_p, sc_p = pallas_viterbi(lo, la, lp)
    s0, sc0 = core.viterbi(lo, la, lp)
    assert bool(jnp.all(s_p == s0)), "kernel Viterbi path differs"
    np.testing.assert_array_equal(sc_p, sc0)


def test_pallas_log_likelihood_grads(kernel_dispatch):
    rng = np.random.default_rng(9)
    B, T, K = 3, 100, 7
    lo = jnp.asarray(rng.normal(size=(B, T, K)), jnp.float32)
    la = jnp.asarray(np.log(rng.dirichlet(np.ones(K), size=K)), jnp.float32)
    lp = jnp.asarray(np.log(rng.dirichlet(np.ones(K))), jnp.float32)

    val_p, grads_p = jax.value_and_grad(
        lambda *a: jnp.sum(ops.auto_log_likelihood(*a)), argnums=(0, 1, 2)
    )(lo, la, lp)
    val_0, grads_0 = jax.value_and_grad(
        lambda *a: jnp.sum(core.log_likelihood(*a)), argnums=(0, 1, 2)
    )(lo, la, lp)
    np.testing.assert_allclose(val_p, val_0, atol=1e-3)
    for gp, g0 in zip(grads_p, grads_0):
        np.testing.assert_allclose(gp, g0, atol=1e-3)


def test_auto_dispatch_runs(problem):
    lo, la, lp = problem
    a, lz = auto_forward(lo, la, lp)
    s, sc = auto_viterbi(lo, la, lp)
    assert a.shape == lo.shape and s.shape == lo.shape[:2]


def test_pallas_large_k_supported():
    """The largest K the dispatch sends to the kernels (its cap)."""
    B, T, K = 2, 40, ops.TRELLIS_MAX_K
    rng = np.random.default_rng(3)
    lo = jnp.asarray(rng.normal(size=(B, T, K)), jnp.float32)
    la = jnp.asarray(np.log(rng.dirichlet(np.ones(K), size=K)), jnp.float32)
    lp = jnp.asarray(np.log(rng.dirichlet(np.ones(K))), jnp.float32)
    a_p, lz_p = pallas_forward(lo, la, lp)
    a0, lz0 = core.forward_log(lo, la, lp)
    np.testing.assert_allclose(a_p, a0, atol=5e-4)
    np.testing.assert_allclose(lz_p, lz0, atol=5e-4)
    s_p, sc_p = pallas_viterbi(lo, la, lp)
    s0, sc0 = core.viterbi(lo, la, lp)
    assert bool(jnp.all(s_p == s0))


# ---------------------------------------------------------------------------
# Ragged batches: padded results must equal per-sequence unpadded results.
# ---------------------------------------------------------------------------

def test_pallas_forward_lengths(ragged_problem):
    lo, la, lp, lengths = ragged_problem
    a_p, lz_p = pallas_forward(lo, la, lp, lengths)
    a0, lz0 = core.forward_log(lo, la, lp, lengths)
    np.testing.assert_allclose(a_p, a0, atol=5e-4)
    np.testing.assert_allclose(lz_p, lz0, atol=5e-4)
    for b, n in enumerate(np.asarray(lengths)):
        _, lz_solo = core.forward_log(lo[b:b + 1, :n], la, lp)
        np.testing.assert_allclose(lz_p[b], lz_solo[0], atol=5e-4)


def test_pallas_backward_lengths(ragged_problem):
    lo, la, lp, lengths = ragged_problem
    b_p = pallas_backward(lo, la, lengths)
    b0 = core.backward_log(lo, la, lengths)
    np.testing.assert_allclose(b_p, b0, atol=5e-4)
    for b, n in enumerate(np.asarray(lengths)):
        b_solo = core.backward_log(lo[b:b + 1, :n], la)
        np.testing.assert_allclose(b_p[b, :n], b_solo[0], atol=5e-4)


def test_pallas_viterbi_lengths(ragged_problem):
    lo, la, lp, lengths = ragged_problem
    s_p, sc_p = pallas_viterbi(lo, la, lp, lengths)
    s0, sc0 = core.viterbi(lo, la, lp, lengths)
    assert bool(jnp.all(s_p == s0)), "padded kernel path differs from core"
    np.testing.assert_array_equal(sc_p, sc0)
    for b, n in enumerate(np.asarray(lengths)):
        s_solo, sc_solo = core.viterbi(lo[b:b + 1, :n], la, lp)
        assert bool(jnp.all(s_p[b, :n] == s_solo[0]))
        np.testing.assert_allclose(sc_p[b], sc_solo[0], atol=5e-4)


def test_pallas_ll_masked_grads(ragged_problem, kernel_dispatch):
    lo, la, lp, lengths = ragged_problem
    val_p, grads_p = jax.value_and_grad(
        lambda *a: jnp.sum(ops.auto_log_likelihood(*a, lengths)),
        argnums=(0, 1, 2),
    )(lo, la, lp)
    val_0, grads_0 = jax.value_and_grad(
        lambda *a: jnp.sum(core.log_likelihood(*a, lengths)),
        argnums=(0, 1, 2),
    )(lo, la, lp)
    np.testing.assert_allclose(val_p, val_0, atol=1e-3)
    for gp, g0 in zip(grads_p, grads_0):
        np.testing.assert_allclose(gp, g0, atol=1e-3)


def test_pallas_viterbi_tie_break_matches_core():
    """Equal-scoring paths must pick the same (lowest-index) states as
    ``core.viterbi``."""
    K = 6
    lo = jnp.zeros((2, 30, K), jnp.float32)         # all ties
    la = jnp.full((K, K), -jnp.log(float(K)))       # uniform
    lp = jnp.full((K,), -jnp.log(float(K)))
    s_p, sc_p = pallas_viterbi(lo, la, lp)
    s0, sc0 = core.viterbi(lo, la, lp)
    assert bool(jnp.all(s_p == s0))
    np.testing.assert_allclose(sc_p, sc0, atol=1e-5)


# ---------------------------------------------------------------------------
# GMM-HMM decode: emission scoring + trellis kernel (the flagship path).
# ---------------------------------------------------------------------------

from pytorch_hmm_tpu.emissions import gmm_log_probs


def _gmm_problem(B, T, S, C, D, seed=1):
    rng = np.random.default_rng(seed)
    means = jnp.asarray(rng.normal(size=(S, C, D)), jnp.float32)
    log_vars = jnp.asarray(0.1 * rng.normal(size=(S, C, D)), jnp.float32)
    log_w = jnp.asarray(
        np.log(rng.dirichlet(np.ones(C), size=S)), jnp.float32)
    feats = jnp.asarray(rng.normal(size=(B, T, D)), jnp.float32)
    la = jnp.asarray(np.log(rng.dirichlet(np.ones(S), size=S)), jnp.float32)
    lp = jnp.asarray(np.log(rng.dirichlet(np.ones(S))), jnp.float32)
    return feats, means, log_vars, log_w, la, lp


@pytest.mark.parametrize("shape", [(4, 256, 12, 4, 80), (3, 130, 5, 3, 13)])
def test_gmm_viterbi_matches_unfused(shape, kernel_dispatch):
    B, T, S, C, D = shape
    feats, means, log_vars, log_w, la, lp = _gmm_problem(B, T, S, C, D)
    st_f, sc_f = ops.auto_gmm_viterbi(feats, means, log_vars, log_w, la, lp)
    lo = gmm_log_probs(feats, means, log_vars, log_w, "diag")
    st_u, sc_u = core.viterbi(lo, la, lp)
    assert bool(jnp.all(st_f == st_u))
    np.testing.assert_allclose(sc_f, sc_u, rtol=1e-4, atol=5e-3)


def test_gmm_viterbi_lengths(kernel_dispatch):
    B, T, S, C, D = 5, 200, 8, 2, 40
    feats, means, log_vars, log_w, la, lp = _gmm_problem(B, T, S, C, D, 9)
    lengths = jnp.asarray([200, 31, 130, 1, 64], jnp.int32)
    st_f, sc_f = ops.auto_gmm_viterbi(
        feats, means, log_vars, log_w, la, lp, lengths)
    lo = gmm_log_probs(feats, means, log_vars, log_w, "diag")
    st_u, sc_u = core.viterbi(lo, la, lp, lengths)
    assert bool(jnp.all(st_f == st_u))
    np.testing.assert_allclose(sc_f, sc_u, rtol=1e-4, atol=5e-3)
    for b, n in enumerate(np.asarray(lengths)):
        st_solo, sc_solo = core.viterbi(lo[b:b + 1, :n], la, lp)
        assert bool(jnp.all(st_f[b, :n] == st_solo[0]))


@pytest.mark.parametrize("cov", ["diag", "tied", "spherical", "full"])
def test_gmm_viterbi_every_covariance_family(cov, kernel_dispatch):
    from pytorch_hmm_tpu.emissions import flat_dim

    B, T, S, C, D = 2, 40, 5, 2, 6
    rng = np.random.default_rng(5)
    feats, means, _, log_w, la, lp = _gmm_problem(B, T, S, C, D, 5)
    cov_params = {
        "diag": 0.1 * rng.normal(size=(S, C, D)),
        "tied": 0.1 * rng.normal(size=(D,)),
        "spherical": 0.1 * rng.normal(size=(S, C)),
        "full": 0.1 * rng.normal(size=(S, C, flat_dim(D))),
    }[cov]
    cov_params = jnp.asarray(cov_params, jnp.float32)
    st, sc = ops.auto_gmm_viterbi(
        feats, means, cov_params, log_w, la, lp, covariance_type=cov)
    lo = gmm_log_probs(feats, means, cov_params, log_w, cov)
    st0, sc0 = core.viterbi(lo, la, lp)
    np.testing.assert_array_equal(st, st0)
    np.testing.assert_allclose(sc, sc0, rtol=1e-6)


# ---------------------------------------------------------------------------
# Small K, many shapes: the flagship regime.
# ---------------------------------------------------------------------------

def _k_problem(B, T, K, seed=None):
    rng = np.random.default_rng(B * T if seed is None else seed)
    lo = jnp.asarray(rng.normal(size=(B, T, K)), jnp.float32)
    la = jnp.asarray(np.log(rng.dirichlet(np.ones(K), size=K)), jnp.float32)
    lp = jnp.asarray(np.log(rng.dirichlet(np.ones(K))), jnp.float32)
    return lo, la, lp


@pytest.mark.parametrize(
    "shape", [(5, 300, 11), (3, 64, 5), (4, 128, 32), (1, 1, 3), (2, 500, 12)]
)
def test_smallk_viterbi_matches_core(shape):
    lo, la, lp = _k_problem(*shape)
    s_p, sc_p = pallas_viterbi(lo, la, lp)
    s_0, sc_0 = core.viterbi(lo, la, lp)
    assert bool(jnp.all(s_p == s_0))
    np.testing.assert_array_equal(sc_p, sc_0)


def test_smallk_viterbi_ties_match_argmax():
    K = 6
    lo = jnp.zeros((2, 40, K), jnp.float32)
    la = jnp.full((K, K), -jnp.log(float(K)))
    lp = jnp.full((K,), -jnp.log(float(K)))
    s_p, _ = pallas_viterbi(lo, la, lp)
    s_0, _ = core.viterbi(lo, la, lp)
    assert bool(jnp.all(s_p == s_0))


def test_smallk_viterbi_bracketed_ties_match_argmax():
    """Ties among {1..K-1} with a -inf diagonal: the argmax must return
    the globally lowest predecessor index."""
    K = 4
    a = np.full((K, K), 1.0 / (K - 1))
    np.fill_diagonal(a, 0.0)
    la = jnp.asarray(np.log(a + 1e-300), jnp.float32)
    lp = jnp.full((K,), -jnp.log(float(K)))
    lo = jnp.zeros((2, 50, K), jnp.float32)
    s_p, _ = pallas_viterbi(lo, la, lp)
    s_0, _ = core.viterbi(lo, la, lp)
    assert bool(jnp.all(s_p == s_0))


def test_smallk_viterbi_lengths():
    lo, la, lp = _k_problem(5, 300, 9, seed=3)
    lengths = jnp.asarray([300, 31, 164, 1, 129], jnp.int32)
    s_p, sc_p = pallas_viterbi(lo, la, lp, lengths)
    s_0, sc_0 = core.viterbi(lo, la, lp, lengths)
    assert bool(jnp.all(s_p == s_0))
    np.testing.assert_array_equal(sc_p, sc_0)
    for b, n in enumerate(np.asarray(lengths)):
        s_solo, _ = core.viterbi(lo[b:b + 1, :n], la, lp)
        assert bool(jnp.all(s_p[b, :n] == s_solo[0]))


@pytest.mark.parametrize("B,T,K", [(9, 129, 100), (2, 300, 128),
                                   (5, 257, 64), (1, 128, 16)])
def test_kernels_edge_shapes(B, T, K):
    """Odd batch/time/state sizes, one sequence and the cap exercise state
    padding (to Kp) and the one-program-per-sequence grid of both
    kernels."""
    rng = np.random.default_rng(B + T + K)
    lo = jnp.asarray(rng.normal(size=(B, T, K)) * 2.0, jnp.float32)
    la = jnp.asarray(np.log(rng.dirichlet(np.ones(K), size=K)), jnp.float32)
    lp = jnp.asarray(np.log(rng.dirichlet(np.ones(K))), jnp.float32)
    a0, lz0 = core.forward_log(lo, la, lp)
    b0 = core.backward_log(lo, la)
    a_p, b_p, lz_p = pallas_fb(lo, la, lp)
    np.testing.assert_allclose(a_p, a0, atol=3e-3)
    np.testing.assert_allclose(lz_p, lz0, atol=3e-3)
    np.testing.assert_allclose(b_p, b0, atol=3e-3)
    s_p, sc_p = pallas_viterbi(lo, la, lp)
    s0, sc0 = core.viterbi(lo, la, lp)
    np.testing.assert_array_equal(s_p, s0)
    np.testing.assert_array_equal(sc_p, sc0)


# ---------------------------------------------------------------------------
# The wrapper: padding, the grid, the cap, the choice of kernel or core.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,Kp", [(1, 16), (12, 16), (16, 16), (17, 32),
                                  (64, 64), (100, 128), (128, 128)])
def test_padded_states(K, Kp):
    assert padded_states(K) == Kp


@pytest.mark.parametrize("batch", [1, 2, 3, 5, 16])
def test_batch_tile_does_not_change_results(batch):
    """One program per sequence: a row's result is the same whatever the
    batch it runs in (one row, odd B, ragged rows)."""
    lo, la, lp = _k_problem(16, 60, 12, seed=11)
    lengths = jnp.asarray(np.random.default_rng(11).integers(1, 61, 16),
                          jnp.int32).at[0].set(60)
    lo, lengths = lo[:batch], lengths[:batch]
    s, sc = pallas_viterbi(lo, la, lp, lengths)
    s0, sc0 = core.viterbi(lo, la, lp, lengths)
    np.testing.assert_array_equal(s, s0)
    np.testing.assert_array_equal(sc, sc0)
    a, b, lz = pallas_fb(lo, la, lp, lengths)
    np.testing.assert_allclose(lz, core.forward_log(lo, la, lp, lengths)[1],
                               atol=5e-4)
    np.testing.assert_allclose(b, core.backward_log(lo, la, lengths),
                               atol=5e-4)
    s1, sc1 = pallas_viterbi(lo[-1:], la, lp, lengths[-1:])
    np.testing.assert_array_equal(s1[0], s[-1])
    np.testing.assert_array_equal(sc1[0], sc[-1])


def test_per_sequence_initial_distribution():
    """``log_pi`` may be ``(B, K)``, as ``core`` allows."""
    lo, la, _ = _k_problem(3, 50, 7, seed=12)
    rng = np.random.default_rng(12)
    lp = jnp.asarray(np.log(rng.dirichlet(np.ones(7), size=3)), jnp.float32)
    s, sc = pallas_viterbi(lo, la, lp)
    s0, sc0 = core.viterbi(lo, la, lp)
    np.testing.assert_array_equal(s, s0)
    a, _, lz = pallas_fb(lo, la, lp)
    np.testing.assert_allclose(lz, core.forward_log(lo, la, lp)[1],
                               atol=5e-4)


def test_left_to_right_minus_inf_transitions():
    """Hard-zero (-inf) transitions and unreachable states: the -inf
    padding must never win a max or make a NaN."""
    K = 6
    a = np.zeros((K, K))
    for i in range(K):
        a[i, i] = 0.6
        a[i, min(i + 1, K - 1)] += 0.4
    la = jnp.asarray(np.log(a), jnp.float32)          # -inf off the band
    lp = jnp.asarray(np.log(np.eye(K)[0]), jnp.float32)
    lo, _, _ = _k_problem(2, 40, K, seed=13)
    s, sc = pallas_viterbi(lo, la, lp)
    s0, sc0 = core.viterbi(lo, la, lp)
    np.testing.assert_array_equal(s, s0)
    np.testing.assert_array_equal(sc, sc0)
    al, be, lz = pallas_fb(lo, la, lp)
    al0, lz0 = core.forward_log(lo, la, lp)
    assert not np.isnan(np.asarray(al)).any()
    np.testing.assert_array_equal(np.isinf(al), np.isinf(al0))
    fin = np.isfinite(np.asarray(al0))
    np.testing.assert_allclose(np.asarray(al)[fin], np.asarray(al0)[fin],
                               atol=5e-4)
    np.testing.assert_allclose(lz, lz0, atol=5e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernels_match_float64_oracle(seed):
    lo, la, lp = _k_problem(2, 25, 5, seed=seed)
    a, _, lz = pallas_fb(lo, la, lp)
    s, sc = pallas_viterbi(lo, la, lp)
    for b in range(2):
        la_o, lz_o = oracle_forward(
            np.asarray(lo[b], np.float64), np.asarray(la, np.float64),
            np.asarray(lp, np.float64))
        np.testing.assert_allclose(a[b], la_o, atol=1e-4)
        np.testing.assert_allclose(lz[b], lz_o, atol=1e-4)
        path, score = oracle_viterbi(
            np.asarray(lo[b], np.float64), np.asarray(la, np.float64),
            np.asarray(lp, np.float64))
        np.testing.assert_array_equal(s[b], path)
        np.testing.assert_allclose(sc[b], score, atol=1e-4)


@pytest.mark.parametrize("fn", [trellis_viterbi, trellis_forward_backward])
def test_kernel_off_gpu_without_interpret_raises(fn):
    lo, la, lp = _k_problem(2, 10, 4, seed=14)
    with pytest.raises(RuntimeError, match="interpret=True"):
        fn(lo, la, lp)


@pytest.mark.parametrize("backend,K,expect", [
    ("gpu", 12, True), ("gpu", 128, True), ("gpu", 129, False),
    ("gpu", 1, True), ("cpu", 12, False),
])
def test_trellis_applies(monkeypatch, backend, K, expect):
    monkeypatch.setattr(ops.jax, "default_backend", lambda: backend)
    assert ops.trellis_applies(K, jnp.zeros((K, K))) is expect
    # Time-varying transitions always take the core scans.
    assert ops.trellis_applies(K, jnp.zeros((1, 2, K, K))) is False


_ENTRY_POINTS = {
    "auto_viterbi": lambda lo, la, lp: ops.auto_viterbi(lo, la, lp),
    "auto_forward": lambda lo, la, lp: ops.auto_forward(lo, la, lp),
    "auto_forward_backward":
        lambda lo, la, lp: ops.auto_forward_backward(lo, la, lp),
    "auto_log_likelihood":
        lambda lo, la, lp: ops.auto_log_likelihood(lo, la, lp),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_dispatch_picks_core_off_gpu(monkeypatch, name):
    def boom(*a, **k):
        raise AssertionError("kernel called off the GPU")

    monkeypatch.setattr(ops, "trellis_viterbi", boom)
    monkeypatch.setattr(ops, "trellis_forward_backward", boom)
    lo, la, lp = _k_problem(2, 20, 5, seed=15)
    _ENTRY_POINTS[name](lo, la, lp)


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_dispatch_picks_kernel_on_gpu(monkeypatch, name):
    calls = []

    def spy(fn):
        def wrapped(*a, **k):
            calls.append(fn.func.__name__)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ops.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(ops, "trellis_viterbi", spy(pallas_viterbi))
    monkeypatch.setattr(ops, "trellis_forward_backward", spy(pallas_fb))
    lo, la, lp = _k_problem(2, 20, 5, seed=16)
    _ENTRY_POINTS[name](lo, la, lp)
    assert calls, f"{name} did not call a kernel"


@pytest.mark.parametrize("ragged", [False, True])
def test_auto_forward_backward_matches_core(kernel_dispatch, ragged):
    """Large-magnitude emissions (speech-like log-probs near -1e3 per
    frame): the per-frame shift keeps posteriors accurate (checked against
    the float64 oracle, which the raw-magnitude core scan is not) and the
    raw alpha/beta/log_z are restored."""
    from oracle import posteriors as oracle_posteriors

    lo, la, lp = _k_problem(3, 120, 8, seed=17)
    lo = lo * 20.0 - 900.0
    lengths = jnp.asarray([120, 57, 2], jnp.int32) if ragged else None
    g, a, b, z = ops.auto_forward_backward(lo, la, lp, lengths)
    g0, a0, b0, z0 = core.forward_backward(lo, la, lp, lengths)
    n = np.asarray(lengths) if ragged else [120] * 3
    for i, L in enumerate(n):
        gamma, _, _, lz = oracle_posteriors(
            np.asarray(lo[i, :L], np.float64), np.asarray(la, np.float64),
            np.asarray(lp, np.float64))
        np.testing.assert_allclose(np.exp(g[i, :L]), gamma, atol=1e-4)
        np.testing.assert_allclose(z[i], lz, rtol=1e-6)
        np.testing.assert_allclose(a[i, :L], a0[i, :L], rtol=1e-5)
        np.testing.assert_allclose(b[i, :L], b0[i, :L], rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(z, z0, rtol=1e-6)


def test_auto_forward_matches_core(kernel_dispatch, ragged_problem):
    lo, la, lp, lengths = ragged_problem
    a, z = ops.auto_forward(lo, la, lp, lengths)
    a0, z0 = core.forward_log(lo, la, lp, lengths)
    np.testing.assert_allclose(a, a0, atol=5e-4)
    np.testing.assert_allclose(z, z0, atol=5e-4)


def test_auto_log_likelihood_under_jit(kernel_dispatch):
    lo, la, lp = _k_problem(2, 64, 4, seed=18)
    f = jax.jit(jax.value_and_grad(
        lambda x: jnp.sum(ops.auto_log_likelihood(x, la, lp))))
    v, g = f(lo)
    v0, g0 = jax.value_and_grad(
        lambda x: jnp.sum(core.log_likelihood(x, la, lp)))(lo)
    np.testing.assert_allclose(v, v0, rtol=1e-6)
    np.testing.assert_allclose(g, g0, atol=1e-4)
