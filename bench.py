"""Benchmark of the BASELINE workloads on one GPU.

Prints ONE JSON line per workload (headline LAST), each:
    {"metric": ..., "value": <real-time factor>, "unit": "x_realtime",
     "vs_baseline": <ours / reference RTX-3060 number>,
     "spread": {"min_ms": .., "p50_ms": .., "max_ms": .., "trials": ..},
     "device": {"platform": .., "kind": .., "count": ..}}

Workloads (BASELINE.json / BASELINE.md):
  1. MixtureGaussianHMM decode  B=32 T=1000 S=12 C=4 D=80  (ref 3.2 ms)
  2. HSMM decode                B=32 T=1000 S=10 D=20      (ref 3.5 ms)
  3. Streaming chunk step p50   chunk=160 S=12 D=80 beam   (ref 1.1 ms)
  4. NeuralHMM forward          B=16 T=1000 S=12 H=256     (ref 5.1 ms)
  5. Long-context forward       B=32 T=131072 K=64         (ref: cannot)
  6. SemiMarkovHMM decode       B=24 T=800 S=10 D=20       (ref 4.2 ms)
  7. CTC forced alignment       B=16 T=500 C=40 U=50       (ref 180x RT)
  8. DTW alignment              500x500 frames, D=80       (ref 150x RT)
  9. Streaming e2e              PCM -> framer -> beam      (ref 445x RT,
     audio-in-to-states-out per 160-frame chunk             decode only)

Timing: each workload is one jitted function; after a compile call, TRIALS
windows each dispatch enough calls to last ~TARGET_WINDOW_SEC and end in
``block_until_ready`` (``profiling.window_times``); a row reports the
min/p50/max per-call time over its windows. The run fails unless JAX's
first device is a GPU: no row is ever timed on the CPU. Workloads built on
the flax model classes are skipped, with a note on stderr, where flax is
not installed.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

FRAME_SEC = 0.01
TRIALS = 7
TARGET_WINDOW_SEC = 0.05


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pytorch_hmm_tpu.profiling import window_times

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU, JAX found {dev.platform}")
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update(
            "jax_compilation_cache_dir",
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".jax_cache"),
        )
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    have_flax = importlib.util.find_spec("flax") is not None
    if have_flax:
        from flax import nnx

    def measure(fn, x):
        lats = sorted(window_times(
            jax.jit(fn), x, reps=TRIALS, target_window_sec=TARGET_WINDOW_SEC,
        ))
        return {"min": lats[0], "p50": lats[len(lats) // 2],
                "max": lats[-1], "trials": len(lats)}

    def emit(name, lat, audio_sec, ref_latency_sec, ref_rtf_base=None,
             roof=None):
        rtf = audio_sec / lat["p50"]
        if ref_rtf_base is None:
            vs = (ref_latency_sec / lat["p50"])
        else:
            vs = rtf / ref_rtf_base
        line = {
            "metric": name,
            "value": round(rtf, 1),
            "unit": "x_realtime",
            "vs_baseline": round(vs, 3),
            "spread": {
                "min_ms": round(lat["min"] * 1e3, 4),
                "p50_ms": round(lat["p50"] * 1e3, 4),
                "max_ms": round(lat["max"] * 1e3, 4),
                "trials": lat["trials"],
            },
            "device": device,
        }
        if roof is not None:
            from pytorch_hmm_tpu.roofline import roofline

            line["roofline"] = roofline(lat["p50"], dev.device_kind, **roof)
        print(
            f"{name}: p50={lat['p50']*1e3:.3f}ms "
            f"[{lat['min']*1e3:.3f}, {lat['max']*1e3:.3f}] "
            f"vs_baseline={line['vs_baseline']}",
            file=sys.stderr, flush=True,
        )
        return json.dumps(line)

    def needs_flax(row):
        if not have_flax:
            print(f"{row}: skipped, needs flax (not installed)",
                  file=sys.stderr, flush=True)
        return not have_flax

    lines = []
    key = jax.random.PRNGKey(0)

    # ---- 2. HSMM decode (B=32, T=1000, S=10, D=20; ref 3.5 ms) ----
    try:
        if needs_flax("hsmm"):
            raise _Skip
        from pytorch_hmm_tpu.models import HSMMLayer

        hsmm = HSMMLayer(
            num_states=10, feature_dim=80, max_duration=20,
            rngs=nnx.Rngs(0),
        )
        gd, st = nnx.split(hsmm)
        obs = jax.random.normal(key, (32, 1000, 80), jnp.float32)

        def hsmm_decode(o):
            m = nnx.merge(gd, st)
            states, score = m.viterbi_decode_hsmm(o)
            return jnp.sum(score) + jnp.sum(states[:, -1])

        lat = measure(hsmm_decode, obs)
        lines.append(emit(
            "hsmm_decode_rtf_b32_T1000_s10_d20", lat, 32 * 1000 * FRAME_SEC,
            3.5e-3,
        ))
    except _Skip:
        pass
    except Exception as e:  # pragma: no cover - diagnostics only
        print(f"hsmm bench failed: {e!r}", file=sys.stderr, flush=True)

    # ---- 3. Streaming chunk step p50 (chunk=160, S=12, D=80; ref 1.1 ms) --
    try:
        if needs_flax("streaming"):
            raise _Skip
        from pytorch_hmm_tpu.streaming import (
            StreamingHMMProcessor, _beam_step, _emit,
        )

        proc = StreamingHMMProcessor(
            num_states=12, feature_dim=80, chunk_size=160,
            use_beam_search=True, rngs=nnx.Rngs(0),
        )
        w = (
            proc.emission_hidden.kernel[...], proc.emission_hidden.bias[...],
            proc.emission_out.kernel[...], proc.emission_out.bias[...],
        )
        log_a = jnp.log(proc.get_transition_matrix() + 1e-8)
        carry0 = (proc._beam_scores, proc._beam_states,
                  proc._beam_paths, proc._beam_len)
        # 160 frames sit exactly on the 32-frame pad granule.
        chunk = jax.random.normal(key, (160, 80), jnp.float32)
        n_valid = jnp.int32(160)

        def stream_step(x):
            lo = _emit(x, *w)
            carry, states, conf = _beam_step(log_a, lo, n_valid, carry0)
            return jnp.sum(conf) + jnp.sum(states)

        lat = measure(stream_step, chunk)
        stream_p50 = lat["p50"]
        lines.append(emit(
            "streaming_chunk_p50_s12_d80_beam", lat, 160 * FRAME_SEC,
            1.1e-3,
        ))

        # ---- 3b. Multi-stream serving: 8 concurrent streams, ONE
        # kernel launch per chunk cadence (MultiStreamDecoder — no
        # reference analogue; its streaming is one stream per call).
        from pytorch_hmm_tpu.streaming import MultiStreamDecoder

        N_s = 8
        dec8 = MultiStreamDecoder(proc, n_streams=N_s, chunk_frames=160)
        carry8 = dec8.init_carry()
        feats8 = jax.random.normal(key, (N_s, 160, 80), jnp.float32)

        def multi_step(f):
            _, states, conf = dec8.step(carry8, f)
            return jnp.sum(conf) + jnp.sum(states)

        lat = measure(multi_step, feats8)
        # Audio seconds per chunk = N streams x 160 frames; baseline:
        # the reference serves N streams with N sequential 1.1 ms calls.
        lines.append(emit(
            "multi_stream_8x_chunk_p50_s12_d80_beam", lat,
            N_s * 160 * FRAME_SEC, N_s * 1.1e-3,
        ))

        # 16-stream fleet.
        N16 = 16
        dec16 = MultiStreamDecoder(proc, n_streams=N16, chunk_frames=160)
        carry16 = dec16.init_carry()
        feats16 = jax.random.normal(key, (N16, 160, 80), jnp.float32)

        def multi_step16(f):
            _, states, conf = dec16.step(carry16, f)
            return jnp.sum(conf) + jnp.sum(states)

        lat = measure(multi_step16, feats16)
        lines.append(emit(
            "multi_stream_16x_chunk_p50_s12_d80_beam", lat,
            N16 * 160 * FRAME_SEC, N16 * 1.1e-3,
        ))

        # ---- 9. End-to-end: raw PCM -> on-device framing -> beam decode
        # in one jitted dispatch: matmul-DFT framing + emission + beam
        # step (pytorch_hmm_tpu/frontend.py).
        from pytorch_hmm_tpu.frontend import make_pcm_decode_step

        pcm_step, pcm_carry = make_pcm_decode_step(proc, chunk_frames=160)
        rng_audio = np.random.default_rng(0)
        pcm_chunk = jnp.asarray(
            rng_audio.standard_normal(160 * 160).astype(np.float32)
        )

        def e2e_step(x):
            _, states, conf, _nv = pcm_step(pcm_carry, x)
            return jnp.sum(conf) + jnp.sum(states)

        lat_e2e = measure(e2e_step, pcm_chunk)
        # Reference claims 445x RT for streaming DECODE ONLY
        # (PERFORMANCE.md:13); this row includes framing from raw PCM.
        lines.append(emit(
            "streaming_e2e_audio_to_states_p50_chunk160", lat_e2e,
            160 * FRAME_SEC, None, ref_rtf_base=445.0,
        ))

        # Host-framer comparison (the no-JAX-on-host option): one line to
        # keep the breakdown visible in the bench log.
        from pytorch_hmm_tpu.native import NativeFramer

        framer = NativeFramer(n_mels=80)
        hop_samples = framer.hop * 160
        pcm_np = np.asarray(pcm_chunk)
        framer.push(np.concatenate([pcm_np, pcm_np])); framer.pop()  # warm
        fr_ms = []
        for _ in range(50):
            t0 = time.perf_counter()
            framer.push(pcm_np[:hop_samples])
            framer.pop()
            fr_ms.append((time.perf_counter() - t0) * 1e3)
        fr_ms.sort()
        print(
            f"host framer ({'native' if framer.is_native else 'numpy'}) "
            f"alternative: p50={fr_ms[len(fr_ms)//2]:.3f}ms per 160 frames "
            f"(+ {stream_p50*1e3:.3f}ms device decode); fused on-device "
            f"path above is the default",
            file=sys.stderr, flush=True,
        )
    except _Skip:
        pass
    except Exception as e:  # pragma: no cover
        print(f"streaming bench failed: {e!r}", file=sys.stderr, flush=True)

    # ---- 6. SemiMarkovHMM decode (B=24, T=800, S=10, D=20; ref 4.2 ms) ----
    try:
        if needs_flax("semi-markov"):
            raise _Skip
        from pytorch_hmm_tpu.models import SemiMarkovHMM

        smm = SemiMarkovHMM(
            num_states=10, observation_dim=80, max_duration=20,
            rngs=nnx.Rngs(0),
        )
        gd_s, st_s = nnx.split(smm)
        obs = jax.random.normal(key, (24, 800, 80), jnp.float32)

        def smm_decode(o):
            m = nnx.merge(gd_s, st_s)
            path, _, score = m.viterbi_decode(o)
            return jnp.sum(score) + jnp.sum(path[:, -1])

        lat = measure(smm_decode, obs)
        lines.append(emit(
            "semi_markov_decode_rtf_b24_T800_s10_d20", lat,
            24 * 800 * FRAME_SEC, 4.2e-3,
        ))
    except _Skip:
        pass
    except Exception as e:  # pragma: no cover
        print(f"semi-markov bench failed: {e!r}", file=sys.stderr, flush=True)

    # ---- 7. CTC forced alignment (B=16, T=500, C=40, U=50; ref 180x RT) --
    try:
        from pytorch_hmm_tpu.alignment import ctc_viterbi_alignment

        B_c, T_c, C_c, U_c = 16, 500, 40, 50
        lp = jax.nn.log_softmax(
            jax.random.normal(key, (T_c, B_c, C_c), jnp.float32), axis=-1
        )
        targets = (
            jax.random.randint(key, (B_c, U_c), 1, C_c)
        ).astype(jnp.int32)
        in_lens = jnp.full((B_c,), T_c, jnp.int32)
        tgt_lens = jnp.full((B_c,), U_c, jnp.int32)

        def ctc_align(x):
            ali, score = ctc_viterbi_alignment(
                x, targets, in_lens, tgt_lens
            )
            return jnp.sum(score) + jnp.sum(ali[:, -1])

        lat = measure(ctc_align, lp)
        # Reference: 180x real time on RTX 3060 (PERFORMANCE.md:22).
        lines.append(emit(
            "ctc_forced_alignment_rtf_b16_T500_c40_u50", lat,
            B_c * T_c * FRAME_SEC, None, ref_rtf_base=180.0,
        ))
    except Exception as e:  # pragma: no cover
        print(f"ctc bench failed: {e!r}", file=sys.stderr, flush=True)

    # ---- 8. DTW alignment (500x500 frames, D=80; ref 150x RT) ----
    try:
        from pytorch_hmm_tpu.alignment import compute_distance_matrix
        from pytorch_hmm_tpu.alignment.dtw import dtw_path_padded

        x_d = jax.random.normal(key, (500, 80), jnp.float32)
        y_d = jax.random.normal(jax.random.PRNGKey(7), (500, 80), jnp.float32)

        # Full alignment (cost + path) via the jit-composable path —
        # ``dtw_alignment`` itself trims the path host-side.
        def dtw_fn(x):
            dist = compute_distance_matrix(x, y_d)
            pi, pj, length, cost = dtw_path_padded(dist)
            return (cost + jnp.sum(pi[-1] + pj[-1])
                    + length.astype(jnp.float32))

        lat = measure(dtw_fn, x_d)
        # Reference: 150x real time on RTX 3060 (PERFORMANCE.md:21).
        lines.append(emit(
            "dtw_alignment_rtf_T500x500_d80", lat,
            500 * FRAME_SEC, None, ref_rtf_base=150.0,
        ))
    except Exception as e:  # pragma: no cover
        print(f"dtw bench failed: {e!r}", file=sys.stderr, flush=True)

    # ---- 4. NeuralHMM forward (B=16, T=1000, S=12, H=256; ref 5.1 ms) ----
    try:
        if needs_flax("neural"):
            raise _Skip
        from pytorch_hmm_tpu.models import NeuralHMM

        nh = NeuralHMM(
            num_states=12, observation_dim=80, hidden_dim=256,
            rngs=nnx.Rngs(0),
        )
        nh.eval()  # inference benchmark: dropout off (no RNG mutation)
        gd_n, st_n = nnx.split(nh)
        obs = jax.random.normal(key, (16, 1000, 80), jnp.float32)

        def neural_fwd(o):
            m = nnx.merge(gd_n, st_n)
            gamma, alpha, beta = m(o)
            return jnp.sum(gamma[:, -1]) + jnp.sum(alpha[:, -1])

        lat = measure(neural_fwd, obs)
        lines.append(emit(
            "neural_hmm_forward_rtf_b16_T1000_s12_h256", lat,
            16 * 1000 * FRAME_SEC, 5.1e-3,
        ))
    except _Skip:
        pass
    except Exception as e:  # pragma: no cover
        print(f"neural bench failed: {e!r}", file=sys.stderr, flush=True)

    # ---- 5. Long-context forward (B=32, T=131072, K=64) ----
    try:
        from pytorch_hmm_tpu import ops

        B, T, K = 32, 131072, 64
        lo = jax.random.normal(key, (B, T, K), jnp.float32)
        la = jax.nn.log_softmax(
            jax.random.normal(key, (K, K), jnp.float32), axis=-1
        )
        lpi = jnp.full((K,), -jnp.log(float(K)))

        def long_fwd(x):
            # auto dispatch: the forward trellis kernel on the GPU.
            _, lz = ops.auto_forward(x, la, lpi)
            return jnp.sum(lz)

        lat = measure(long_fwd, lo)
        # Reference cannot enter this regime; baseline = its best implied
        # frame rate (GMM decode: 32k frames / 3.2 ms = 10M frames/s).
        frames_per_sec = B * T / lat["p50"]
        lines.append(emit(
            "long_context_forward_rtf_b32_T131072_k64", lat,
            B * T * FRAME_SEC, None, ref_rtf_base=10e6 * FRAME_SEC,
        ))
        print(
            f"long-context: {frames_per_sec/1e6:.0f}M frames/s",
            file=sys.stderr, flush=True,
        )

        # Training at the same scale: d log Z / d log_obs (posteriors).
        # The VJP runs both recursions in one kernel launch.
        def long_grad(x):
            g = jax.grad(
                lambda y: jnp.sum(ops.auto_log_likelihood(y, la, lpi))
            )(x)
            return jnp.sum(g[:, -1])

        lat = measure(long_grad, lo)
        lines.append(emit(
            "long_context_grad_rtf_b32_T131072_k64", lat,
            B * T * FRAME_SEC, None, ref_rtf_base=10e6 * FRAME_SEC,
        ))
    except Exception as e:  # pragma: no cover
        print(f"long-context bench failed: {e!r}", file=sys.stderr,
              flush=True)

    # ---- 11. Large-state likelihood (B=48, T=2048, K=512) ----
    # Above the trellis kernels' state cap: the XLA scan. The reference's
    # benchmarks stop at 50 states in Python loops
    # (examples/benchmark.py:36-57).
    try:
        from pytorch_hmm_tpu import ops

        Bk, Tk, Kk = 48, 2048, 512
        lo_k = jax.random.normal(key, (Bk, Tk, Kk), jnp.float32)
        la_k = jax.nn.log_softmax(
            jax.random.normal(key, (Kk, Kk), jnp.float32), axis=-1
        )
        lpi_k = jnp.full((Kk,), -jnp.log(float(Kk)))

        def bigk_fn(x):
            return jnp.sum(ops.auto_log_likelihood(x, la_k, lpi_k))

        lat = measure(bigk_fn, lo_k)
        # Baseline convention matches the long-context rows: the
        # reference's best implied frame rate (10M frames/s at K=12).
        lines.append(emit(
            "bigk_forward_ll_b48_T2048_k512", lat, Bk * Tk * FRAME_SEC,
            None, ref_rtf_base=10e6 * FRAME_SEC,
        ))
    except Exception as e:  # pragma: no cover
        print(f"bigk bench failed: {e!r}", file=sys.stderr, flush=True)

    # ---- 12. CTC forced alignment at ASR scale (S=2048 lattice) ------
    # The small row (7.) covers the reference shape; this one is the
    # wide lattice (U=1000 labels, S = 2U+1 = 2001 states per frame).
    try:
        from pytorch_hmm_tpu.alignment import ctc_viterbi_alignment

        B_c2, T_c2, C_c2, U_c2 = 4, 2048, 100, 1000
        lp2 = jax.nn.log_softmax(
            jax.random.normal(key, (T_c2, B_c2, C_c2), jnp.float32),
            axis=-1,
        )
        targets2 = jax.random.randint(
            key, (B_c2, U_c2), 1, C_c2
        ).astype(jnp.int32)
        in2 = jnp.full((B_c2,), T_c2, jnp.int32)
        tg2 = jnp.full((B_c2,), U_c2, jnp.int32)

        def ctc_big(x):
            ali, score = ctc_viterbi_alignment(x, targets2, in2, tg2)
            return jnp.sum(score) + jnp.sum(ali[:, -1])

        lat = measure(ctc_big, lp2)
        lines.append(emit(
            "ctc_forced_alignment_rtf_b4_T2048_c100_u1000", lat,
            B_c2 * T_c2 * FRAME_SEC, None, ref_rtf_base=180.0,
        ))
    except Exception as e:  # pragma: no cover
        print(f"ctc big bench failed: {e!r}", file=sys.stderr, flush=True)

    # ---- 10. Full-covariance GMM decode (same shape as headline) ----
    try:
        if needs_flax("full-cov"):
            raise _Skip
        from pytorch_hmm_tpu.models import MixtureGaussianHMMLayer as _MG

        model_f = _MG(
            num_states=12, feature_dim=80, num_components=4,
            covariance_type="full", rngs=nnx.Rngs(0),
        )
        obs_f = jax.random.normal(key, (32, 1000, 80), jnp.float32)
        # Serving path: parameters frozen into derived tables
        # (make_decoder hoists the Cholesky-inverse prologue). Decodes
        # are verified identical to the live-parameter path.
        dec_f = model_f.make_decoder()

        def decode_full(o):
            states, scores = dec_f(o, return_log_probs=True)
            return jnp.sum(scores) + jnp.sum(states[:, -1])

        lat = measure(decode_full, obs_f)
        # Reference "full" covariance silently falls back to diagonal
        # (hmm_layer.py:311-319); its honest baseline is the same
        # 3.2 ms decode claim.
        lines.append(emit(
            "mixture_gaussian_full_cov_decode_rtf_b32_T1000_s12_c4_d80",
            lat, 32 * 1000 * FRAME_SEC, 3.2e-3,
        ))
    except _Skip:
        pass
    except Exception as e:  # pragma: no cover
        print(f"full-cov bench failed: {e!r}", file=sys.stderr, flush=True)

    # ---- 1. HEADLINE: GMM-HMM decode (B=32 T=1000 S=12 C=4 D=80) ----
    # Printed last so a last-line-only parser still records the headline.
    # The functional path of MixtureGaussianHMMLayer(12, 80, 4, "diag"):
    # matmul-form emission scoring + the Viterbi trellis.
    from pytorch_hmm_tpu import ops

    B, T, S, C, D = 32, 1000, 12, 4, 80
    ks = jax.random.split(key, 4)
    means = jax.random.normal(ks[0], (S, C, D)) * (2.0 / D) ** 0.5
    log_vars = jnp.zeros((S, C, D))
    log_w = jax.nn.log_softmax(jax.random.normal(ks[1], (S, C)) * 0.1, -1)
    log_a = jax.nn.log_softmax(jax.random.normal(ks[2], (S, S)) * 0.1, -1)
    log_pi = jnp.full((S,), -jnp.log(float(S)))
    obs = jax.random.normal(ks[3], (B, T, D), jnp.float32)

    def decode_once(o):
        states, scores = ops.auto_gmm_viterbi(
            o, means, log_vars, log_w, log_a, log_pi)
        return jnp.sum(scores) + jnp.sum(states[:, -1])

    lat = measure(decode_once, obs)
    lines.append(emit(
        "mixture_gaussian_hmm_decode_rtf_b32_T1000_s12_c4_d80", lat,
        B * T * FRAME_SEC, 3.2e-3,
        # Emission scoring is the only matmul ([x^2, x, 1] @ W); the
        # trellis is a latency-bound chain that no roofline bounds.
        roof=dict(hbm_bytes=B * T * (D + 2 * S) * 4,
                  matmul_flops=2 * B * T * (2 * D + 1) * S * C),
    ))

    for line in lines:
        print(line, flush=True)


class _Skip(Exception):
    """A workload that cannot run here (see ``needs_flax``)."""


if __name__ == "__main__":
    main()
