"""Alignment-accuracy protocol: boundary F1 vs SNR, three aligners.

The reference publishes accuracy-type claims on real speech (DTW 94.2%,
CTC 91.8%, boundary 96.1% — reference ``PERFORMANCE.md:21-23``) that
cannot be reproduced without its (unreleased) data. The repo's plain
forced-alignment demo scores F1 = 1.000 on well-separated synthetic
phones — true but vacuous. This protocol makes the synthetic task HARD
and reports the degradation curve instead of a single saturated number:

* phone emission means are drawn with a fixed pairwise separation and
  the additive noise is swept over SNR, so class overlap is controlled;
* state durations are gamma-distributed (not uniform), so duration
  models have something to model;
* three aligners run on identical data: transcript-HMM Viterbi,
  duration-constrained HSMM, and CTC forced alignment over a
  frame-classifier lattice.

Reported per SNR: boundary F1 (±2 frames) and frame accuracy. The
numbers should fall smoothly from ~1.0 toward chance as SNR drops —
a table that degrades gracefully is evidence the metrics bite, unlike
a pinned 1.000. Output: a markdown table (docs/applications.md embeds
a committed run).

Run: python examples/alignment_protocol.py [--quick]
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np

from pytorch_hmm_tpu import create_left_to_right_matrix, metrics
from pytorch_hmm_tpu.alignment import ctc_viterbi_alignment
from pytorch_hmm_tpu.core.semiring import safe_log
from pytorch_hmm_tpu.emissions import diag_gaussian_log_probs
from pytorch_hmm_tpu.core.hsmm import hsmm_viterbi
from pytorch_hmm_tpu.ops import auto_viterbi


def synthesize(rng, n_utts, n_phones, feat_dim, mean_dur, sep, noise_std):
    """Controlled-overlap utterances.

    Phone means sit on a random unit-norm constellation scaled to
    pairwise distance ~``sep``; features are mean + N(0, noise_std²).
    SNR(dB) = 20·log10(rms(means)/noise_std).
    """
    raw = rng.normal(size=(n_phones, feat_dim))
    raw /= np.linalg.norm(raw, axis=1, keepdims=True)
    means = (raw * sep / np.sqrt(2.0)).astype(np.float32)
    paths, lens = [], []
    for _ in range(n_utts):
        durs = np.maximum(
            1, rng.gamma(shape=4.0, scale=mean_dur / 4.0, size=n_phones)
        ).astype(int)
        path = np.repeat(np.arange(n_phones), durs)
        paths.append(path)
        lens.append(len(path))
    T = max(lens)
    feats = np.zeros((n_utts, T, feat_dim), np.float32)
    full_paths = np.zeros((n_utts, T), np.int32)
    for b, path in enumerate(paths):
        L = len(path)
        feats[b, :L] = means[path] + noise_std * rng.normal(
            size=(L, feat_dim)
        )
        full_paths[b, :L] = path
        full_paths[b, L:] = path[-1]
    snr_db = 20.0 * np.log10(
        np.sqrt(np.mean(means ** 2)) / max(noise_std, 1e-9)
    )
    return (
        jnp.asarray(feats), jnp.asarray(lens, jnp.int32), full_paths,
        jnp.asarray(means), float(snr_db),
    )


def scores(states, true_paths, lengths):
    b_f1s, f_accs = [], []
    for b in range(states.shape[0]):
        L = int(lengths[b])
        pred = np.asarray(states)[b, :L]
        gt = true_paths[b, :L]
        f_accs.append(float(np.mean(pred == gt)))
        pb = np.flatnonzero(np.diff(pred)) + 1
        gb = np.flatnonzero(np.diff(gt)) + 1
        b_f1s.append(
            float(metrics.boundary_accuracy(pb, gb, tolerance=2)["f1"])
        )
    return float(np.mean(b_f1s)), float(np.mean(f_accs))


def align_hmm(feats, lens, means, noise_std):
    P = means.shape[0]
    log_var = jnp.full(means.shape, 2.0 * np.log(max(noise_std, 1e-3)))
    log_obs = diag_gaussian_log_probs(feats, means, log_var)
    log_a = safe_log(create_left_to_right_matrix(P, self_loop_prob=0.6))
    log_pi = safe_log(jnp.zeros((P,)).at[0].set(1.0) + 1e-8)
    return auto_viterbi(log_obs, log_a, log_pi, lens)[0]


def align_hsmm_pmf(feats, lens, means, noise_std, mean_dur, max_dur=40):
    """Duration-constrained alignment: gamma(4, mean/4) duration pmf —
    the matched prior the HMM's geometric self-loop cannot express."""
    P = means.shape[0]
    log_var = jnp.full(means.shape, 2.0 * np.log(max(noise_std, 1e-3)))
    log_obs = diag_gaussian_log_probs(feats, means, log_var)
    # Gamma(4, mean_dur/4) pmf on the duration grid (numpy, no scipy).
    d = np.arange(1, max_dur + 1, dtype=np.float64)
    k, theta = 4.0, mean_dur / 4.0
    logpdf = (k - 1) * np.log(d) - d / theta
    logpdf -= logpdf.max()
    pmf = np.exp(logpdf); pmf /= pmf.sum()
    log_dur = jnp.broadcast_to(
        jnp.asarray(np.log(pmf), jnp.float32)[None, :], (P, max_dur)
    )
    nxt = jnp.eye(P, k=1)  # advance-only: durations carry the dwell
    nxt = nxt.at[P - 1, P - 1].set(1.0)
    log_a = safe_log(nxt)
    log_pi = safe_log(jnp.zeros((P,)).at[0].set(1.0) + 1e-8)
    return hsmm_viterbi(log_obs, log_a, log_pi, log_dur, lens)[0]


def align_ctc(feats, lens, means, noise_std, n_phones):
    """CTC forced alignment over a Gaussian frame-classifier lattice:
    vocab = blank + phones, transcript = the phone sequence."""
    B, T, _D = feats.shape
    log_var = jnp.full(means.shape, 2.0 * np.log(max(noise_std, 1e-3)))
    cls = diag_gaussian_log_probs(feats, means, log_var)  # (B, T, P)
    cls = jax.nn.log_softmax(cls, axis=-1)
    # Blank gets a flat low score: forced alignment may route short
    # silences through it; scoring ignores blank frames below.
    blank = jnp.full((B, T, 1), jnp.log(0.2 / n_phones))
    lp = jnp.concatenate([blank, cls + jnp.log(0.8)], axis=-1)
    lp = jnp.transpose(lp, (1, 0, 2))  # (T, B, C)
    targets = jnp.broadcast_to(
        jnp.arange(1, n_phones + 1, dtype=jnp.int32)[None], (B, n_phones)
    )
    tgt_lens = jnp.full((B,), n_phones, jnp.int32)
    ali, _ = ctc_viterbi_alignment(lp, targets, lens, tgt_lens)
    # Map token ids back to phone indices; fill blanks with the previous
    # phone (standard frame-labeling convention).
    ali = np.asarray(ali) - 1
    out = np.empty_like(ali)
    for b in range(ali.shape[0]):
        cur = 0
        for t in range(ali.shape[1]):
            if ali[b, t] >= 0:
                cur = ali[b, t]
            out[b, t] = cur
    return jnp.asarray(out)


def main(quick=False):
    rng = np.random.default_rng(0)
    B, P, D, dur = (4, 8, 20, 8) if quick else (16, 12, 40, 10)
    sep = 1.0
    print(f"{B} utts, {P} phones, D={D}, mean dur {dur}, sep {sep}")
    print()
    print("| SNR (dB) | HMM F1 | HSMM F1 | CTC F1 | HMM frame | HSMM frame | CTC frame |")
    print("|---|---|---|---|---|---|---|")
    for noise in ([0.35, 1.0] if quick else [0.18, 0.35, 0.7, 1.0, 1.4, 2.0]):
        feats, lens, gt, means, snr = synthesize(
            rng, B, P, D, dur, sep, noise
        )
        s_hmm = align_hmm(feats, lens, means, noise)
        s_hsmm = align_hsmm_pmf(feats, lens, means, noise, dur)
        s_ctc = align_ctc(feats, lens, means, noise, P)
        f1_m, fa_m = scores(s_hmm, gt, lens)
        f1_s, fa_s = scores(s_hsmm, gt, lens)
        f1_c, fa_c = scores(s_ctc, gt, lens)
        print(
            f"| {snr:+.1f} | {f1_m:.3f} | {f1_s:.3f} | {f1_c:.3f} "
            f"| {fa_m:.3f} | {fa_s:.3f} | {fa_c:.3f} |"
        )


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    main(quick=ap.parse_args().quick)
