"""HSMM segment DP (``core.hsmm``) vs brute-force enumeration of every
segmentation: Viterbi paths and scores, log Z, posteriors, minimum
durations, ragged batches and the closed-form gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oracle import hsmm_brute
from pytorch_hmm_tpu.core.hsmm import (
    hsmm_backward,
    hsmm_forward,
    hsmm_log_z,
    hsmm_posteriors,
    hsmm_viterbi,
)


def _problem(B, T, S, D, seed, min_duration=1):
    rng = np.random.default_rng(seed)
    lo = jnp.asarray(rng.normal(size=(B, T, S)), jnp.float32)
    a = rng.dirichlet(np.ones(S), size=S)
    np.fill_diagonal(a, 0.0)
    a = a / a.sum(axis=1, keepdims=True)
    la = jnp.asarray(np.log(a + 1e-12), jnp.float32)
    lp = jnp.asarray(np.log(rng.dirichlet(np.ones(S))), jnp.float32)
    dur = rng.dirichlet(np.ones(D), size=S)
    ld = np.log(dur + 1e-12)
    if min_duration > 1:
        ld[:, : min_duration - 1] = -np.inf
    return lo, la, lp, jnp.asarray(ld, jnp.float32)


def _brute(lo, la, lp, ld, b, L=None):
    L = lo.shape[1] if L is None else L
    f64 = lambda x: np.asarray(x, np.float64)
    return hsmm_brute(f64(lo[b, :L]), f64(la), f64(lp), f64(ld))


_SHAPES = [
    (2, 6, 3, 4, 0),      # T > D
    (2, 5, 2, 7, 1),      # D > T (durations clipped by the sequence)
    (1, 1, 3, 3, 2),      # single frame
    (2, 7, 2, 1, 3),      # D = 1: a plain HMM without self-loops
    (3, 6, 3, 2, 4),
    (1, 8, 2, 3, 5),
]


@pytest.mark.parametrize("B,T,S,D,seed", _SHAPES)
def test_hsmm_viterbi_matches_brute_force(B, T, S, D, seed):
    lo, la, lp, ld = _problem(B, T, S, D, seed)
    st, sc = hsmm_viterbi(lo, la, lp, ld)
    for b in range(B):
        path, score, _, _ = _brute(lo, la, lp, ld, b)
        np.testing.assert_array_equal(np.asarray(st[b]), path)
        np.testing.assert_allclose(float(sc[b]), score, rtol=1e-5)


@pytest.mark.parametrize("B,T,S,D,seed", _SHAPES)
def test_hsmm_log_z_matches_brute_force(B, T, S, D, seed):
    lo, la, lp, ld = _problem(B, T, S, D, seed)
    _, lz = hsmm_forward(lo, la, lp, ld)
    lz_cf = hsmm_log_z(lo, la, lp, ld)
    for b in range(B):
        _, _, ref, _ = _brute(lo, la, lp, ld, b)
        np.testing.assert_allclose(float(lz[b]), ref, rtol=1e-5)
        np.testing.assert_allclose(float(lz_cf[b]), ref, rtol=1e-5)


@pytest.mark.parametrize("B,T,S,D,seed", _SHAPES[:3])
def test_hsmm_posteriors_match_brute_force(B, T, S, D, seed):
    lo, la, lp, ld = _problem(B, T, S, D, seed)
    post = hsmm_posteriors(lo, la, lp, ld)
    gamma = np.asarray(post["gamma"])
    for b in range(B):
        _, _, _, ref = _brute(lo, la, lp, ld, b)
        np.testing.assert_allclose(gamma[b], ref, atol=1e-5)


def test_hsmm_min_duration_matches_brute_force():
    lo, la, lp, ld = _problem(2, 8, 2, 5, 7, min_duration=3)
    st, sc = hsmm_viterbi(lo, la, lp, ld)
    _, lz = hsmm_forward(lo, la, lp, ld)
    for b in range(2):
        path, score, ref_lz, _ = _brute(lo, la, lp, ld, b)
        np.testing.assert_array_equal(np.asarray(st[b]), path)
        np.testing.assert_allclose(float(sc[b]), score, rtol=1e-5)
        np.testing.assert_allclose(float(lz[b]), ref_lz, rtol=1e-5)
        # Every segment is at least 3 frames long.
        runs = np.diff(np.flatnonzero(np.diff(np.r_[-1, path, -1])))
        assert (runs >= 3).all()


def test_hsmm_tie_breaks_are_deterministic():
    """Uniform emissions and durations force exact score ties: the decode
    is a valid segmentation scoring the brute-force maximum."""
    B, T, S, D = 2, 6, 3, 3
    lo = jnp.zeros((B, T, S), jnp.float32)
    a = np.full((S, S), 1.0 / (S - 1))
    np.fill_diagonal(a, 0.0)
    la = jnp.asarray(np.log(a + 1e-12), jnp.float32)
    lp = jnp.asarray(np.full(S, -np.log(S)), jnp.float32)
    ld = jnp.asarray(np.full((S, D), -np.log(D)), jnp.float32)
    st, sc = hsmm_viterbi(lo, la, lp, ld)
    st2, _ = hsmm_viterbi(lo, la, lp, ld)
    np.testing.assert_array_equal(np.asarray(st), np.asarray(st2))
    _, score, _, _ = _brute(lo, la, lp, ld, 0)
    np.testing.assert_allclose(np.asarray(sc), score, rtol=1e-5)


@pytest.mark.parametrize("T,lengths", [(8, [8, 3]), (7, [5, 7])])
def test_hsmm_ragged_matches_brute_force(T, lengths):
    lo, la, lp, ld = _problem(2, T, 3, 4, 11)
    lens = jnp.asarray(lengths, jnp.int32)
    st, sc = hsmm_viterbi(lo, la, lp, ld, lens)
    lz = hsmm_log_z(lo, la, lp, ld, lens)
    for b, L in enumerate(lengths):
        path, score, ref_lz, _ = _brute(lo, la, lp, ld, b, L)
        np.testing.assert_array_equal(np.asarray(st[b, :L]), path)
        assert (np.asarray(st[b, L:]) == path[-1]).all()
        np.testing.assert_allclose(float(sc[b]), score, rtol=1e-5)
        np.testing.assert_allclose(float(lz[b]), ref_lz, rtol=1e-5)


def test_hsmm_ragged_matches_unpadded():
    """Each ragged row's decoded prefix equals its standalone decode, at
    a benchmark-like shape."""
    lo, la, lp, ld = _problem(3, 180, 7, 10, 13)
    lens = [180, 77, 133]
    st, sc = hsmm_viterbi(lo, la, lp, ld, jnp.asarray(lens))
    for b, L in enumerate(lens):
        st1, sc1 = hsmm_viterbi(lo[b : b + 1, :L], la, lp, ld)
        np.testing.assert_array_equal(np.asarray(st)[b, :L],
                                      np.asarray(st1)[0])
        np.testing.assert_allclose(np.asarray(sc)[b], np.asarray(sc1)[0],
                                   rtol=1e-6)
        assert (np.asarray(st)[b, L:] == np.asarray(st)[b, L - 1]).all()


def test_hsmm_log_z_closed_form_grads_match_autodiff():
    """hsmm_log_z's custom VJP (posterior-expectation cotangents) must
    match differentiating through the forward scan, ragged included."""
    B, T, S, D = 3, 60, 6, 9
    lo, la, lp, ld = _problem(B, T, S, D, 21, min_duration=3)
    w = jnp.asarray([1.0, 2.0, -0.5])
    for lens in (None, jnp.asarray([60, 23, 3], jnp.int32)):
        def f_auto(lo, la, lp, ld):
            return jnp.sum(hsmm_forward(lo, la, lp, ld, lens)[1] * w)

        def f_cf(lo, la, lp, ld):
            return jnp.sum(hsmm_log_z(lo, la, lp, ld, lens) * w)

        np.testing.assert_allclose(
            f_auto(lo, la, lp, ld), f_cf(lo, la, lp, ld), rtol=1e-6
        )
        ga = jax.grad(f_auto, argnums=(0, 1, 2, 3))(lo, la, lp, ld)
        gc = jax.grad(f_cf, argnums=(0, 1, 2, 3))(lo, la, lp, ld)
        for name, x, y in zip(("obs", "a", "pi", "dur"), ga, gc):
            np.testing.assert_allclose(
                np.asarray(x), np.asarray(y), atol=2e-5, err_msg=name
            )


def test_hsmm_backward_completes_forward():
    """beta* at the start of each segment combined with the entry scores
    gives the same log Z as the forward pass."""
    lo, la, lp, ld = _problem(2, 40, 4, 6, 23)
    _, lz = hsmm_forward(lo, la, lp, ld)
    bstar, bstart = hsmm_backward(lo, la, ld)
    lz0 = jax.scipy.special.logsumexp(lp[None] + bstart[:, 0], axis=-1)
    np.testing.assert_allclose(np.asarray(lz0), np.asarray(lz), rtol=1e-5)
