"""Forced alignment of speech features to a phoneme transcript.

The BASELINE north star for this framework: align 80-dim mel-like
features to a known transcript far faster than real time on one GPU,
with frame-exact Viterbi paths. This demo builds the whole pipeline
from public API pieces:

1.  an utterance HMM from the transcript — one left-to-right state per
    phoneme (``create_left_to_right_matrix``), diagonal-Gaussian
    acoustic models per phoneme;
2.  batched decode through ``ops.auto_viterbi`` (the Viterbi trellis
    kernel on the GPU), ragged lengths included;
3.  boundary / duration recovery from the state path, scored with the
    ``metrics`` module against the synthetic ground truth;
4.  a real-time-factor measurement from warmed, synchronized windows
    (``profiling.device_time``).

Mirrors the reference's application framing (``README.md`` forced
alignment, ``PERFORMANCE.md:23``: 96.1% boundary accuracy at 120× RT on
an RTX 3060); the decode itself is the flagship path.

Run: python examples/forced_alignment.py [--quick]
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np

from pytorch_hmm_tpu import create_left_to_right_matrix, metrics
from pytorch_hmm_tpu.core.semiring import safe_log
from pytorch_hmm_tpu.emissions import diag_gaussian_log_probs
from pytorch_hmm_tpu.ops import auto_viterbi
from pytorch_hmm_tpu.profiling import device_time
from pytorch_hmm_tpu.utils import compute_state_durations

FRAME_SEC = 0.01  # 10 ms hop


def synthesize_utterances(rng, n_utts, n_phones, feat_dim, mean_dur):
    """Ground-truth segmentations + noisy per-phoneme Gaussian features.

    Returns (features (B, T, D), lengths (B,), true_paths (B, T),
    phone_means (P, D)).
    """
    phone_means = rng.normal(size=(n_phones, feat_dim)).astype(np.float32)
    paths, lens = [], []
    for _ in range(n_utts):
        durs = rng.integers(mean_dur // 2, mean_dur * 2, size=n_phones)
        path = np.repeat(np.arange(n_phones), durs)
        paths.append(path)
        lens.append(len(path))
    T = max(lens)
    B = n_utts
    feats = np.zeros((B, T, feat_dim), np.float32)
    full_paths = np.zeros((B, T), np.int32)
    for b, path in enumerate(paths):
        L = len(path)
        feats[b, :L] = phone_means[path] + 0.5 * rng.normal(
            size=(L, feat_dim)
        )
        full_paths[b, :L] = path
        full_paths[b, L:] = path[-1]
    return (
        jnp.asarray(feats),
        jnp.asarray(lens, jnp.int32),
        full_paths,
        jnp.asarray(phone_means),
    )


def align(features, lengths, phone_means, log_var=None):
    """Viterbi forced alignment: ``(states (B, T), scores (B,))``."""
    P = phone_means.shape[0]
    if log_var is None:
        log_var = jnp.full(phone_means.shape, 2.0 * np.log(0.5))
    log_obs = diag_gaussian_log_probs(features, phone_means, log_var)
    # Transcript topology: advance-or-stay through the phone sequence.
    log_a = safe_log(create_left_to_right_matrix(P, self_loop_prob=0.6))
    log_pi = safe_log(
        jnp.zeros((P,)).at[0].set(1.0) + 1e-8
    )  # must start at the first phone
    return auto_viterbi(log_obs, log_a, log_pi, lengths)


def evaluate(states, true_paths, lengths):
    """Frame / boundary / duration scores averaged over the batch."""
    frame_accs, b_f1s, d_accs = [], [], []
    for b in range(states.shape[0]):
        L = int(lengths[b])
        pred = np.asarray(states)[b, :L]
        gt = true_paths[b, :L]
        frame_accs.append(
            float(metrics.alignment_accuracy(pred, gt, tolerance=2))
        )
        pb = np.flatnonzero(np.diff(pred)) + 1
        gb = np.flatnonzero(np.diff(gt)) + 1
        bres = metrics.boundary_accuracy(pb, gb, tolerance=2)
        b_f1s.append(float(bres["f1"]))
        dres = metrics.duration_accuracy(
            compute_state_durations(jnp.asarray(pred)),
            compute_state_durations(jnp.asarray(gt)),
        )
        d_accs.append(float(dres["accuracy_within_tolerance"]))
    return (
        float(np.mean(frame_accs)),
        float(np.mean(b_f1s)),
        float(np.mean(d_accs)),
    )


def main(quick: bool = False):
    print("Forced alignment — transcript HMM + Viterbi trellis")
    print(f"backend: {jax.default_backend()}")
    rng = np.random.default_rng(0)

    B, P, D, dur = (4, 8, 20, 8) if quick else (32, 24, 80, 12)
    feats, lens, true_paths, phone_means = synthesize_utterances(
        rng, B, P, D, dur
    )
    T = feats.shape[1]
    print(f"{B} utterances, {P} phones, T≤{T} frames, {D}-dim features")

    states, scores = align(feats, lens, phone_means)
    f_acc, b_f1, d_acc = evaluate(states, true_paths, lens)
    print(f"frame accuracy (±2): {f_acc:.3f}")
    print(f"boundary F1 (±2 frames): {b_f1:.3f}")
    print(f"duration accuracy (20% tol): {d_acc:.3f}")
    assert f_acc > 0.9, "alignment degraded — check the decode path"

    # Real-time factor from warmed windows that end in
    # block_until_ready.
    reps = 16 if quick else 128
    sec = device_time(
        lambda f: align(f, lens, phone_means)[1], feats, reps=reps
    )
    audio_sec = float(jnp.sum(lens)) * FRAME_SEC
    floor = 5e-5
    if sec < floor:
        print(
            f"decode: <{floor * 1e3:.2f} ms for {audio_sec:.1f} s of "
            f"audio → ≥{audio_sec / floor:,.0f}× real time"
        )
    else:
        print(
            f"decode: {sec * 1e3:.2f} ms for {audio_sec:.1f} s of audio "
            f"→ {audio_sec / sec:,.0f}× real time"
        )
    print("forced alignment demo completed.")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true")
    main(quick=parser.parse_args().quick)
