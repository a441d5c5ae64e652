"""Multi-stream beam decode: the vmapped fleet step and the decoder API
must equal the single-stream beam step per stream."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import nnx

from pytorch_hmm_tpu.streaming import (
    MultiStreamDecoder, StreamingHMMProcessor, _beam_scan_raw, _beam_step)


def fleet_chunk(la, los, nv, carry):
    """The fleet's raw (un-renormalized) beam scan, vmapped over streams
    as ``streaming._multi_step`` runs it."""
    return jax.vmap(
        lambda lo, c: _beam_scan_raw(la, lo, nv, c)[:4]
    )(los, carry)


@pytest.mark.parametrize("N", [4, 16])
def test_fleet_matches_single_stream(rng, N):
    S, T, W, H = 12, 32, 8, 100
    la = jnp.asarray(np.log(rng.dirichlet(np.ones(S), size=S)), jnp.float32)
    nv = jnp.int32(T)
    carry_m = (jnp.zeros((N, W)), jnp.zeros((N, W), jnp.int32),
               jnp.zeros((N, W, H), jnp.int32), jnp.zeros((N,), jnp.int32))
    carries = [(jnp.zeros((W,)), jnp.zeros((W,), jnp.int32),
                jnp.zeros((W, H), jnp.int32), jnp.int32(0))
               for _ in range(N)]
    for _ in range(2):  # chained chunks exercise the carried history
        los = jnp.asarray(rng.normal(size=(N, T, S)), jnp.float32)
        sc, st, pt, plen = fleet_chunk(la, los, nv, carry_m)
        carry_m = (sc, st, pt, plen)
        for n in range(N):
            cx, _, _ = _beam_step(la, los[n], nv, carries[n])
            carries[n] = cx
            np.testing.assert_array_equal(st[n], cx[1])
            np.testing.assert_array_equal(pt[n], cx[2])
            # The single-stream step renormalizes scores per chunk; the
            # raw fleet scan does not — they agree up to one shift.
            d = np.asarray(sc[n] - cx[0])
            finite = np.isfinite(np.asarray(cx[0]))
            assert np.allclose(d[finite] - d[finite][0], 0.0, atol=1e-4)


def test_decoder_api_matches_per_stream_processor(rng):
    N, F, D = 3, 32, 20
    proc = StreamingHMMProcessor(
        num_states=8, feature_dim=D, chunk_size=F, rngs=nnx.Rngs(0)
    )
    dec = MultiStreamDecoder(proc, n_streams=N, chunk_frames=F)
    carry = dec.init_carry()
    feats = jnp.asarray(rng.normal(size=(N, F, D)), jnp.float32)

    from pytorch_hmm_tpu.streaming import _emit, _PAD_GRANULE
    w = (proc.emission_hidden.kernel[...], proc.emission_hidden.bias[...],
         proc.emission_out.kernel[...], proc.emission_out.bias[...])
    la = jnp.log(proc.get_transition_matrix() + 1e-8)
    singles = [
        (proc._beam_scores, proc._beam_states, proc._beam_paths,
         proc._beam_len)
        for _ in range(N)
    ]
    for _ in range(2):
        carry, states, conf = dec.step(carry, feats)
        for n in range(N):
            lo = _emit(feats[n], *w)
            pad = -(-F // _PAD_GRANULE) * _PAD_GRANULE - F
            if pad:
                lo = jnp.pad(lo, ((0, pad), (0, 0)))
            c_n, st_n, cf_n = _beam_step(la, lo, jnp.int32(F), singles[n])
            singles[n] = c_n
            np.testing.assert_array_equal(states[n], st_n[:F])
            np.testing.assert_allclose(conf[n], cf_n[:F], atol=1e-5)
        feats = feats + 0.1  # vary the next chunk


def test_reset_stream(rng):
    proc = StreamingHMMProcessor(
        num_states=6, feature_dim=8, chunk_size=16, rngs=nnx.Rngs(0)
    )
    dec = MultiStreamDecoder(proc, n_streams=2, chunk_frames=16)
    carry = dec.init_carry()
    feats = jnp.asarray(rng.normal(size=(2, 16, 8)), jnp.float32)
    carry, _, _ = dec.step(carry, feats)
    carry2 = dec.reset_stream(carry, 1)
    assert int(carry2[3][1]) == 0 and int(carry2[3][0]) > 0
    # stream 0 untouched
    np.testing.assert_array_equal(carry2[2][0], carry[2][0])


def test_pcm_fleet_matches_single_stream(rng):
    """Fleet audio→states must equal the single-stream fused PCM path
    per stream (same frontend tables, same beam semantics)."""
    from pytorch_hmm_tpu.frontend import make_pcm_decode_step

    N, F = 3, 16
    proc = StreamingHMMProcessor(
        num_states=8, feature_dim=80, chunk_size=F, rngs=nnx.Rngs(0)
    )
    dec = MultiStreamDecoder(proc, n_streams=N, chunk_frames=F)
    fleet_step, fleet_carry = dec.make_pcm_step()
    single_step, single_carry0 = make_pcm_decode_step(proc, chunk_frames=F)
    pcm = jnp.asarray(
        rng.standard_normal((N, F * 160)).astype(np.float32)
    )
    singles = [single_carry0] * N
    for k in range(2):
        fleet_carry, st, cf, nv = fleet_step(fleet_carry, pcm)
        for n in range(N):
            singles[n], st_n, cf_n, nv_n = single_step(singles[n], pcm[n])
            assert int(nv) == int(nv_n)
            v = int(nv)
            np.testing.assert_array_equal(st[n][:v], st_n[:v])
            np.testing.assert_allclose(cf[n][:v], cf_n[:v], atol=1e-5)
        pcm = pcm * 0.9 + 0.1
