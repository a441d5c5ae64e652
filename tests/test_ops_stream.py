"""Streaming chunk decoders (``streaming._greedy_step``/``_beam_step``) vs
a frame-by-frame NumPy oracle: padding tails, carried history, tie-breaks
and chunk chaining."""

import jax.numpy as jnp
import numpy as np
import pytest

from oracle import beam_stream, greedy_stream
from pytorch_hmm_tpu.streaming import _beam_finalize, _beam_step, _greedy_step


def _problem(T, S, seed):
    rng = np.random.default_rng(seed)
    la = jnp.asarray(
        np.log(rng.dirichlet(np.ones(S), size=S) + 1e-8), jnp.float32
    )
    lo = jnp.asarray(
        np.log(rng.dirichlet(np.ones(S), size=T) + 1e-8), jnp.float32
    )
    return la, lo


def _beam_carry(W, H, S, plen, seed):
    rng = np.random.default_rng(seed)
    sc = jnp.asarray(-np.sort(rng.random(W)) * 3, jnp.float32)
    ls = jnp.asarray(rng.integers(0, S, W), jnp.int32)
    pt = jnp.asarray(rng.integers(0, S, (W, H)), jnp.int32)
    return sc, ls, pt, jnp.int32(plen)


@pytest.mark.parametrize("T,S,nv,seed", [
    (160, 12, 160, 0),
    (192, 12, 160, 1),     # padding tail (invalid frames)
    (40, 5, 40, 2),
    (8, 3, 3, 3),          # mostly-invalid chunk
])
@pytest.mark.parametrize("has_prev", [False, True])
def test_greedy_chunk_matches_oracle(T, S, nv, seed, has_prev):
    la, lo = _problem(T, S, seed)
    carry = (jnp.int32(seed % S), jnp.asarray(has_prev))
    (p, h), st, cf = _greedy_step(la, lo, jnp.int32(nv), carry)
    p0, h0, st0, sc0 = greedy_stream(la, lo, nv, seed % S, has_prev)
    assert int(p) == p0 and bool(h) == h0
    np.testing.assert_array_equal(np.asarray(st), st0)
    np.testing.assert_allclose(np.asarray(cf), np.exp(sc0), rtol=1e-6)


@pytest.mark.parametrize("T,S,W,H,nv,plen,seed", [
    (160, 12, 8, 165, 160, 0, 0),     # first chunk (bench shape)
    (160, 12, 8, 165, 160, 165, 1),   # steady state
    (64, 5, 4, 70, 60, 30, 2),        # partial history
    (16, 6, 6, 40, 9, 0, 3),          # invalid tail on first chunk
])
def test_beam_chunk_matches_oracle(T, S, W, H, nv, plen, seed):
    la, lo = _problem(T, S, seed)
    carry = _beam_carry(W, H, S, plen, seed)
    (sc, ls, pt, pl), st, cf = _beam_step(la, lo, jnp.int32(nv), carry)
    sc0, ls0, pt0, pl0 = beam_stream(la, lo, nv, *carry[:3], plen)
    np.testing.assert_array_equal(np.asarray(ls), ls0)
    np.testing.assert_array_equal(np.asarray(pt), pt0)
    assert int(pl) == pl0
    # The step renormalizes the carried scores (max subtracted).
    np.testing.assert_allclose(np.asarray(sc), sc0 - sc0.max(), atol=1e-4)
    # Decoded states: the last nv entries of the best hypothesis.
    best = pt0[int(np.argmax(sc0))]
    np.testing.assert_array_equal(np.asarray(st)[:nv], best[H - nv:])


def test_beam_chunk_tie_breaks():
    """Uniform everything: the per-frame top-k and parent argmax run on
    exact ties and must order them by lowest index."""
    T, S, W, H = 32, 6, 4, 40
    la = jnp.full((S, S), -np.log(float(S)), jnp.float32)
    lo = jnp.full((T, S), -np.log(float(S)), jnp.float32)
    carry = _beam_carry(W, H, S, 0, 0)
    (sc, ls, pt, pl), st, _ = _beam_step(la, lo, jnp.int32(T), carry)
    sc0, ls0, pt0, pl0 = beam_stream(la, lo, T, *carry[:3], 0)
    np.testing.assert_array_equal(np.asarray(ls), ls0)
    np.testing.assert_array_equal(np.asarray(pt), pt0)


def test_chunk_chaining_matches_oracle():
    """Three consecutive chunks: the carry round-trips like one long
    oracle decode of the same frames."""
    S, W, H = 7, 5, 50
    la, _ = _problem(4, S, 9)
    carry = _beam_carry(W, H, S, 0, 9)
    ref = (carry[0], carry[1], carry[2], 0)
    for i in range(3):
        _, lo = _problem(40, S, 20 + i)
        carry, st, _ = _beam_step(la, lo, jnp.int32(40), carry)
        ref = beam_stream(la, lo, 40, *ref)
        np.testing.assert_array_equal(np.asarray(carry[2]), ref[2])
    np.testing.assert_array_equal(np.asarray(carry[1]), ref[1])
    assert int(carry[3]) == ref[3]


def test_beam_finalize_confidence():
    """Per-span confidence is the geometric-mean probability of the
    frames decoded in the chunk: exp(score delta / n_valid)."""
    S, W, H, T = 5, 3, 30, 20
    la, lo = _problem(T, S, 31)
    carry = _beam_carry(W, H, S, 0, 31)
    raw = beam_stream(la, lo, T, *carry[:3], 0)
    _, _, conf = _beam_finalize(
        (jnp.asarray(raw[0]), jnp.asarray(raw[1]), jnp.asarray(raw[2]),
         jnp.int32(raw[3])), carry[0], T, jnp.int32(T))
    expect = np.exp((raw[0].max() - float(jnp.max(carry[0]))) / T)
    np.testing.assert_allclose(np.asarray(conf), expect, rtol=1e-5)


def test_beam_width_gt_states_rejected():
    """W > S has no W distinct states: lax.top_k refuses it."""
    la, lo = _problem(16, 3, 4)
    carry = _beam_carry(5, 20, 3, 0, 4)
    with pytest.raises(Exception):
        _beam_step(la, lo, jnp.int32(16), carry)
