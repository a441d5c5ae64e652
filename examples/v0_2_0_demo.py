"""v0.2.0 feature demo (reference: ``examples/v0_2_0_demo.py``).

Walks the feature set the reference showcases for its v0.2.0 release —
Mixture Gaussian HMM, explicit-duration HSMM, real-time streaming,
advanced transition matrices, Korean TTS presets, the model factory and
a cross-model performance comparison — using jit-compiled scans,
synchronized device timing and JAX PRNG keys.

Run: python examples/v0_2_0_demo.py [--quick]

``--quick`` shrinks every shape so the full flow executes in CI.
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
from flax import nnx

import pytorch_hmm_tpu as ph
from pytorch_hmm_tpu.profiling import device_time


def _speech_like(key, batch, length, dim, smooth=0.7):
    """Temporally-correlated features (the reference builds these with a
    per-frame Python loop, ``v0_2_0_demo.py:52-54``; here it's one scan)."""
    noise = jax.random.normal(key, (batch, length, dim))

    def step(prev, x):
        cur = smooth * prev + (1.0 - smooth) * x
        return cur, cur

    _, out = jax.lax.scan(step, noise[:, 0], jnp.swapaxes(noise, 0, 1))
    return jnp.swapaxes(out, 0, 1)


def demo_mixture_gaussian_hmm(quick: bool):
    """GMM-HMM acoustic decode + duration analysis (``v0_2_0_demo.py:34-83``)."""
    print("\n=== Mixture Gaussian HMM ===")
    B, T, D = (2, 60, 20) if quick else (4, 200, 80)
    model = ph.MixtureGaussianHMMLayer(
        num_states=8, feature_dim=D, num_components=3,
        covariance_type="diag", learnable_transitions=True,
        rngs=nnx.Rngs(0),
    )
    features = _speech_like(jax.random.PRNGKey(0), B, T, D)

    states, log_probs = model(features, return_log_probs=True)
    t = device_time(
        lambda o: model(o, return_log_probs=True)[1], features,
        reps=2 if quick else 10,
    )
    rate = f"{B * T / t:,.0f} frames/s" if t > 1e-6 else "noise-floor"
    print(f"decoded {states.shape} paths in {t * 1e3:.3f} ms ({rate})")

    for b in range(min(2, B)):
        durations = ph.compute_state_durations(states[b])
        d = np.asarray(durations)
        print(f"  batch {b}: {d.size} segments, mean duration {d.mean():.1f}")

    info = model.get_model_info()
    print(f"model parameters: {info['total_parameters']:,}")
    return model, states


def demo_hsmm_duration_modeling(quick: bool):
    """HSMM generation + decode across duration families
    (``v0_2_0_demo.py:85-140``)."""
    print("\n=== HSMM duration modeling ===")
    D = 12 if quick else 40
    hsmm = ph.HSMMLayer(
        num_states=5, feature_dim=D, duration_distribution="gamma",
        max_duration=30, min_duration=3, rngs=nnx.Rngs(1),
    )
    print(f"expected durations: "
          f"{np.asarray(hsmm.get_expected_durations()).round(1)}")

    gen_len = 60 if quick else 150
    gen_states, gen_feats = hsmm.generate_sequence(
        gen_len, key=jax.random.PRNGKey(1)
    )
    durations = np.asarray(ph.compute_state_durations(gen_states))
    print(f"generated {gen_len} frames, {durations.size} segments "
          f"(mean {durations.mean():.1f}, min {durations.min()}, "
          f"max {durations.max()})")

    T = 40 if quick else 80
    test = jax.random.normal(jax.random.PRNGKey(2), (1, T, D))
    t = device_time(lambda o: hsmm(o)[1], test, reps=2 if quick else 5)
    print(f"HSMM decode: {t * 1e3:.2f} ms for {T} frames")

    print("duration families:")
    for dist in ("gamma", "poisson", "weibull"):
        m = ph.HSMMLayer(3, D, duration_distribution=dist, max_duration=15,
                         rngs=nnx.Rngs(2))
        s, _ = m.generate_sequence(60, key=jax.random.PRNGKey(3))
        d = np.asarray(ph.compute_state_durations(s))
        print(f"  {dist:>8}: mean={d.mean():.1f} std={d.std():.1f}")
    return hsmm


def demo_streaming_hmm(quick: bool):
    """Real-time chunked decoding (``v0_2_0_demo.py:142-210``)."""
    print("\n=== Streaming HMM ===")
    D = 50
    proc = ph.StreamingHMMProcessor(
        num_states=6, feature_dim=D, chunk_size=100, lookahead_frames=5,
        use_beam_search=True, beam_width=4, rngs=nnx.Rngs(3),
    )
    rng = np.random.default_rng(4)
    n_chunks = 5 if quick else 20
    for i in range(n_chunks):
        result = proc.process_chunk(rng.normal(size=(100, D)).astype(np.float32))
        if result.decoded_states is not None:
            print(f"  chunk {i:2d}: {result.status:>10} | "
                  f"{len(result.decoded_states):3d} states | "
                  f"{result.processing_time_ms:6.2f} ms | "
                  f"confidence {result.confidence:.3f}")
        else:
            print(f"  chunk {i:2d}: {result.status:>10} | "
                  f"buffer {result.buffer_size} frames")

    stats = proc.get_performance_stats()
    print(f"RTF {stats['real_time_factor']:.1f}x, "
          f"throughput {stats['throughput_fps']:,.0f} frames/s")

    proc.optimize_for_latency(target_latency_ms=15.0)
    print(f"after optimize_for_latency: beam={proc.use_beam_search} "
          f"width={proc.beam_width} chunk={proc.chunk_size}")
    return proc


def demo_advanced_transitions():
    """Transition-matrix toolbox (``v0_2_0_demo.py:212-254``)."""
    print("\n=== Advanced transitions ===")
    skip = ph.create_skip_state_matrix(
        num_states=8, self_loop_prob=0.5, forward_prob=0.4,
        skip_prob=0.1, max_skip=2,
    )
    print(f"skip-state matrix {skip.shape}; "
          f"state-0 skips: {np.asarray(skip[0, 2:4]).round(3)}")

    korean_durations = [4, 6, 3, 8, 5, 7, 4, 6]
    phoneme = ph.create_phoneme_aware_transitions(korean_durations)
    for i, dur in enumerate(korean_durations[:4]):
        print(f"  phoneme {i} (duration {dur}): "
              f"self-loop = {float(phoneme[i, i]):.3f}")

    for speech_type in ("normal", "fast", "slow", "emotional"):
        P = ph.get_speech_transitions(6, speech_type)
        self_loops = float(jnp.diagonal(P).mean())
        fwd = float(jnp.diagonal(P, offset=1).mean())
        print(f"  {speech_type:>10}: self-loop={self_loops:.3f} "
              f"forward={fwd:.3f}")

    report = ph.validate_transition_matrix(ph.create_left_to_right_matrix(6))
    print(f"validator on L2R(6): valid={all(report.values())}")
    return skip, phoneme


def demo_korean_tts(quick: bool):
    """Korean-TTS-sized model (``v0_2_0_demo.py:256-305``)."""
    print("\n=== Korean TTS ===")
    D = 20 if quick else 80
    model = ph.create_korean_tts_hmm(feature_dim=D, num_components=3)
    print(f"{model.num_states} phoneme states "
          f"({len(ph.api.KOREAN_PHONEMES)} Korean phonemes), "
          f"{model.num_components} components")

    T = 50 if quick else 120
    feats = _speech_like(jax.random.PRNGKey(5), 1, T, D)
    # Vowel-like regions: periodic energy boost in formant bands.
    tgrid = jnp.arange(T) % 15 < 8
    boost = jnp.zeros((T, D)).at[:, D // 8: D // 3].set(0.5)
    feats = feats + jnp.where(tgrid[:, None], boost, 0.0)[None]

    states, lp = model(feats, return_log_probs=True)
    durations = np.asarray(ph.compute_state_durations(states[0]))
    print(f"sequence log-prob {float(lp[0]):.1f}; "
          f"{durations.size} phoneme segments, "
          f"mean {durations.mean():.1f} frames")
    return model


def demo_model_factory(quick: bool):
    """Factory presets for ASR / TTS / real-time (``v0_2_0_demo.py:307-345``)."""
    print("\n=== Model factory ===")
    D = 20 if quick else 80
    asr = ph.create_speech_hmm(30, D, "mixture_gaussian", num_components=4)
    print(f"ASR: {asr.num_states} states, {asr.num_components} components")

    tts = ph.create_speech_hmm(25, D, "hsmm",
                               duration_distribution="gamma", max_duration=40)
    print(f"TTS: {tts.num_states} states, {tts.duration_distribution} "
          f"durations (max {tts.max_duration})")

    rt = ph.create_speech_hmm(15, 40, "streaming", chunk_size=80,
                              use_beam_search=False)
    print(f"Real-time: {rt.num_states} states, chunk {rt.chunk_size}, "
          f"greedy decode")
    return asr, tts, rt


def demo_performance_comparison(quick: bool):
    """Cross-model decode timing (``v0_2_0_demo.py:347-388``) — synchronized
    device timing instead of wall clock, plus live-buffer accounting."""
    print("\n=== Performance comparison ===")
    D = 40
    B, T = (2, 50) if quick else (4, 100)
    models = {
        "Basic HMM": ph.create_speech_hmm(10, D, "mixture_gaussian",
                                          num_components=1),
        "Mixture GMM": ph.create_speech_hmm(10, D, "mixture_gaussian",
                                            num_components=3),
        "HSMM": ph.create_speech_hmm(10, D, "hsmm", max_duration=20),
    }
    data = jax.random.normal(jax.random.PRNGKey(6), (B, T, D))
    print(f"{'model':>12} | {'time (ms)':>9} | {'frames/s':>12}")
    for name, model in models.items():
        t = device_time(lambda o, m=model: m(o)[0], data,
                        reps=2 if quick else 5)
        rate = f"{B * T / t:12,.0f}" if t > 1e-6 else f"{'—':>12}"
        print(f"{name:>12} | {t * 1e3:9.3f} | {rate}")


def main(quick: bool = False):
    print("pytorch_hmm_tpu — v0.2.0 feature walk-through")
    print(f"backend: {jax.default_backend()}, "
          f"devices: {jax.device_count()}")

    demo_mixture_gaussian_hmm(quick)
    demo_hsmm_duration_modeling(quick)
    demo_streaming_hmm(quick)
    demo_advanced_transitions()
    demo_korean_tts(quick)
    demo_model_factory(quick)
    demo_performance_comparison(quick)

    print("\nRunning quick integration test...")
    ph.run_quick_test()  # raises on failure
    print("All demos completed.")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true",
                        help="tiny shapes for CI smoke runs")
    main(parser.parse_args().quick)
