"""CTC loss, forced alignment, and segmentation — lattice scans.

Parity target: reference ``alignment/ctc.py``. The reference's own CTC
DP is educational (nested ``t, b, s`` Python loops, ``ctc.py:32-199``)
and its production path delegates to ``nn.CTCLoss`` (``ctc.py:283,308``);
its ``ctc_alignment_path`` reads an α table that is never filled —
effectively broken (``ctc.py:224-231``) — and its beam search is a stub
that falls back to greedy (``ctc.py:355-362``).

Here CTC is implemented directly as a log-semiring scan over the
``2U+1`` expanded blank-interleaved label lattice — the same DP shape as
HMM forward, with a banded (self / advance / skip) transition structure,
fully vectorized over batch and lattice positions:

* ``ctc_forward_algorithm`` / ``ctc_backward_algorithm`` — exact α/β;
* ``ctc_loss`` — differentiable (autodiff through the scan), no torch;
* ``ctc_alignment_path`` — posterior-based alignment with a *working* α;
* ``CTCAligner.align`` — exact max-semiring forced alignment (Viterbi on
  the lattice) with backtrace;
* ``CTCAligner.decode`` / ``decode_batch`` — batched greedy and a real
  fixed-width prefix beam search, both single jitted device programs
  (``ctc_decode.py``) instead of the reference's stub; the host-side
  numpy ``_prefix_beam_search`` remains as the test oracle.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.semiring import logsumexp

__all__ = [
    "expand_targets_with_blank",
    "ctc_forward_algorithm",
    "ctc_backward_algorithm",
    "ctc_loss",
    "ctc_alignment_path",
    "ctc_viterbi_alignment",
    "CTCAligner",
    "CTCSegmentationAligner",
    "remove_ctc_blanks",
    "collapse_repeated_tokens",
    "ctc_decode_sequence",
]

_NEG = -1e30


def expand_targets_with_blank(
    targets: jax.Array, blank_id: int = 0
) -> jax.Array:
    """``(B, U)`` labels → ``(B, 2U+1)`` blank-interleaved lattice
    (``ctc.py:8-29``): ``[blank, y_1, blank, y_2, ..., y_U, blank]``."""
    B, U = targets.shape
    out = jnp.full((B, 2 * U + 1), blank_id, targets.dtype)
    return out.at[:, 1::2].set(targets)


def _lattice_masks(expanded: jax.Array, blank_id: int):
    """Skip-transition permission per lattice position: a jump from s-2 is
    allowed when label(s) is not blank and differs from label(s-2)."""
    lbl = expanded
    lbl_m2 = jnp.concatenate(
        [jnp.full_like(lbl[:, :2], -1), lbl[:, :-2]], axis=1
    )
    return (lbl != blank_id) & (lbl != lbl_m2)


def _gather_emissions(log_probs: jax.Array, expanded: jax.Array) -> jax.Array:
    """``lp[b, t, s] = log_probs[t, b, expanded[b, s]]`` as an exact
    one-hot matmul in place of a (B, T, S) gather (each output sums
    exactly one term, so there is no rounding).
    """
    C = log_probs.shape[-1]
    onehot = jax.nn.one_hot(expanded, C, dtype=log_probs.dtype)  # (B, S, C)
    # Clamp first: the contraction sums 0 · x over non-selected entries,
    # and 0 · (-inf) is NaN — masked vocabulary entries (-inf logits /
    # log(0)) must land as the finite log(0) sentinel instead.
    return jnp.einsum(
        "tbc,bsc->bts", jnp.maximum(log_probs, _NEG), onehot,
        precision=jax.lax.Precision.HIGHEST,
    )


def _tokens_at(expanded: jax.Array, positions: jax.Array) -> jax.Array:
    """``expanded[b, positions[b, t]]`` as an exact one-hot matmul.

    Each output row sums exactly one integer term < 2²⁴, so the float
    matmul is exact; HIGHEST keeps it in true f32.
    """
    S = expanded.shape[1]
    onehot = jax.nn.one_hot(positions, S, dtype=jnp.float32)  # (B, T, S)
    vals = jnp.einsum(
        "bts,bs->bt", onehot, expanded.astype(jnp.float32),
        precision=jax.lax.Precision.HIGHEST,
    )
    return vals.astype(expanded.dtype)


def _shift1(x):
    return jnp.concatenate([jnp.full_like(x[:, :1], _NEG), x[:, :-1]], axis=1)


def _shift2(x):
    return jnp.concatenate([jnp.full_like(x[:, :2], _NEG), x[:, :-2]], axis=1)


def ctc_forward_algorithm(
    log_probs: jax.Array,
    targets: jax.Array,
    input_lengths: jax.Array,
    target_lengths: jax.Array,
    blank_id: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """CTC forward pass (``ctc.py:32-121``, vectorized).

    Args:
        log_probs: ``(T, B, C)`` frame log-probabilities (torch CTC layout).
        targets: ``(B, U)`` label ids (padded).
        input_lengths / target_lengths: ``(B,)`` valid lengths.

    Returns:
        ``(log_alpha (B, T, 2U+1), log_likelihood (B,))``.
    """
    return _ctc_forward_impl(
        log_probs, targets, input_lengths, target_lengths, blank_id=blank_id
    )


@partial(jax.jit, static_argnames=("blank_id",))
def _ctc_forward_impl(
    log_probs, targets, input_lengths, target_lengths, blank_id: int
):
    T, B, C = log_probs.shape
    expanded = expand_targets_with_blank(targets, blank_id)  # (B, S)
    S = expanded.shape[1]
    skip_ok = _lattice_masks(expanded, blank_id)
    s_idx = jnp.arange(S)[None, :]
    valid_pos = s_idx < (2 * target_lengths[:, None] + 1)

    lp = _gather_emissions(log_probs, expanded)

    a0 = jnp.full((B, S), _NEG)
    a0 = a0.at[:, 0].set(lp[:, 0, 0])
    a0 = a0.at[:, 1].set(jnp.where(target_lengths > 0, lp[:, 0, 1], _NEG))
    a0 = jnp.where(valid_pos, a0, _NEG)

    def step(carry, xs):
        a, t = carry, xs
        stay = a
        adv = _shift1(a)
        skip = jnp.where(skip_ok, _shift2(a), _NEG)
        nxt = lp[:, t] + logsumexp(jnp.stack([stay, adv, skip]), axis=0)
        nxt = jnp.where(valid_pos, nxt, _NEG)
        nxt = jnp.where((t < input_lengths)[:, None], nxt, a)
        return nxt, nxt

    _, rest = jax.lax.scan(step, a0, jnp.arange(1, T), unroll=8)
    log_alpha = jnp.concatenate([a0[:, None], rest.swapaxes(0, 1)], axis=1)

    last = jnp.take_along_axis(
        log_alpha, (input_lengths - 1)[:, None, None].astype(jnp.int32),
        axis=1,
    )[:, 0]  # (B, S)
    end1 = jnp.take_along_axis(last, (2 * target_lengths)[:, None], axis=1)
    end2 = jnp.take_along_axis(
        last, jnp.maximum(2 * target_lengths - 1, 0)[:, None], axis=1
    )
    # Empty targets have a single exit position (the lone blank); both
    # indices resolve to it, so mask the duplicate to avoid a +log 2.
    end2 = jnp.where(target_lengths[:, None] > 0, end2, _NEG)
    ll = logsumexp(jnp.concatenate([end1, end2], axis=1), axis=1)
    return log_alpha, ll


def ctc_backward_algorithm(
    log_probs: jax.Array,
    targets: jax.Array,
    input_lengths: jax.Array,
    target_lengths: jax.Array,
    blank_id: int = 0,
) -> jax.Array:
    """CTC backward pass → ``log_beta (B, T, 2U+1)`` (``ctc.py:124-199``)."""
    return _ctc_backward_impl(
        log_probs, targets, input_lengths, target_lengths, blank_id=blank_id
    )


@partial(jax.jit, static_argnames=("blank_id",))
def _ctc_backward_impl(
    log_probs, targets, input_lengths, target_lengths, blank_id: int
):
    T, B, C = log_probs.shape
    expanded = expand_targets_with_blank(targets, blank_id)
    S = expanded.shape[1]
    skip_ok = _lattice_masks(expanded, blank_id)
    s_idx = jnp.arange(S)[None, :]
    valid_pos = s_idx < (2 * target_lengths[:, None] + 1)

    lp = _gather_emissions(log_probs, expanded)

    # beta at each sequence's final frame: 0 at the two exit positions.
    exit1 = s_idx == (2 * target_lengths)[:, None]
    exit2 = s_idx == jnp.maximum(2 * target_lengths - 1, 0)[:, None]
    bT = jnp.where(exit1 | exit2, 0.0, _NEG)

    def shift_back1(x):
        return jnp.concatenate(
            [x[:, 1:], jnp.full_like(x[:, :1], _NEG)], axis=1
        )

    def shift_back2(x):
        return jnp.concatenate(
            [x[:, 2:], jnp.full_like(x[:, :2], _NEG)], axis=1
        )

    skip_fwd = jnp.concatenate(
        [skip_ok[:, 2:], jnp.zeros_like(skip_ok[:, :2])], axis=1
    )

    def step(carry, t):
        b = carry
        msg = b + lp[:, t + 1]  # score of being at position s at t+1
        stay = msg
        adv = shift_back1(msg)
        skip = jnp.where(skip_fwd, shift_back2(msg), _NEG)
        nxt = logsumexp(jnp.stack([stay, adv, skip]), axis=0)
        nxt = jnp.where(valid_pos, nxt, _NEG)
        # Frames at/after the end keep the terminal beta.
        nxt = jnp.where((t + 1 < input_lengths)[:, None], nxt, bT)
        return nxt, nxt

    _, rest = jax.lax.scan(
        step, bT, jnp.arange(T - 1), reverse=True, unroll=8
    )
    return jnp.concatenate([rest.swapaxes(0, 1), bT[:, None]], axis=1)


@partial(jax.custom_vjp, nondiff_argnums=(4,))
def _ctc_ll(log_probs, targets, input_lengths, target_lengths, blank_id):
    """Differentiable per-sequence CTC log-likelihood ``(B,)``.

    The VJP is the classic closed form — the lattice posterior
    ``exp(α + β − ll)`` scattered back onto the vocabulary by the
    expanded labels — assembled from the α/β tables (one backward pass)
    instead of autodiff through the forward scan.
    """
    _, ll = ctc_forward_algorithm(
        log_probs, targets, input_lengths, target_lengths, blank_id
    )
    return ll


def _ctc_ll_fwd(log_probs, targets, input_lengths, target_lengths, blank_id):
    log_alpha, ll = ctc_forward_algorithm(
        log_probs, targets, input_lengths, target_lengths, blank_id
    )
    return ll, (log_probs, targets, input_lengths, target_lengths,
                log_alpha, ll)


def _ctc_ll_bwd(blank_id, res, g):
    log_probs, targets, input_lengths, target_lengths, log_alpha, ll = res
    T, B, C = log_probs.shape
    log_beta = ctc_backward_algorithm(
        log_probs, targets, input_lengths, target_lengths, blank_id
    )
    # Lattice posterior: beta excludes frame t's emission, so alpha+beta
    # is the full path mass through position s at frame t.
    post = jnp.exp(log_alpha + log_beta - ll[:, None, None])  # (B, T, S)
    valid_t = (
        jnp.arange(T)[None, :, None] < input_lengths[:, None, None]
    )
    post = jnp.where(valid_t, post, 0.0)
    expanded = expand_targets_with_blank(targets, blank_id)     # (B, S)
    onehot = jax.nn.one_hot(expanded, C, dtype=post.dtype)      # (B, S, C)
    d_lp = jnp.einsum("bts,bsc->btc", post, onehot)             # (B, T, C)
    d_log_probs = g[None, :, None] * d_lp.transpose(1, 0, 2)    # (T, B, C)
    zi = lambda x: np.zeros(x.shape, dtype=jax.dtypes.float0)
    return d_log_probs, zi(targets), zi(input_lengths), zi(target_lengths)


_ctc_ll.defvjp(_ctc_ll_fwd, _ctc_ll_bwd)


def ctc_loss(
    log_probs: jax.Array,
    targets: jax.Array,
    input_lengths: jax.Array,
    target_lengths: jax.Array,
    blank_id: int = 0,
    reduction: str = "mean",
) -> jax.Array:
    """Differentiable CTC loss — our own lattice scan, not a delegate to
    an external kernel (the reference wraps ``nn.CTCLoss``,
    ``ctc.py:283``). Gradients come
    from the closed-form posterior VJP of :func:`_ctc_ll`.
    """
    ll = _ctc_ll(
        log_probs, targets, input_lengths, target_lengths, blank_id
    )
    nll = -ll
    if reduction == "mean":
        return jnp.mean(nll / jnp.maximum(target_lengths, 1))
    if reduction == "sum":
        return jnp.sum(nll)
    return nll


def ctc_viterbi_alignment(
    log_probs: jax.Array,
    targets: jax.Array,
    input_lengths: jax.Array,
    target_lengths: jax.Array,
    blank_id: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """Exact forced alignment: max-semiring lattice DP + backtrace.

    Returns ``(alignment (B, T) token ids, score (B,))`` — the most
    likely frame-level label sequence consistent with the target.
    Frames beyond ``input_lengths`` repeat the final label.
    """
    return _ctc_viterbi_impl(
        log_probs, targets, input_lengths, target_lengths, blank_id=blank_id
    )


@partial(jax.jit, static_argnames=("blank_id",))
def _ctc_viterbi_impl(
    log_probs, targets, input_lengths, target_lengths, blank_id: int
) -> Tuple[jax.Array, jax.Array]:
    T, B, C = log_probs.shape
    expanded = expand_targets_with_blank(targets, blank_id)
    S = expanded.shape[1]
    skip_ok = _lattice_masks(expanded, blank_id)
    s_idx = jnp.arange(S)[None, :]
    valid_pos = s_idx < (2 * target_lengths[:, None] + 1)

    lp = _gather_emissions(log_probs, expanded)

    a0 = jnp.full((B, S), _NEG)
    a0 = a0.at[:, 0].set(lp[:, 0, 0])
    a0 = a0.at[:, 1].set(jnp.where(target_lengths > 0, lp[:, 0, 1], _NEG))
    a0 = jnp.where(valid_pos, a0, _NEG)

    def step(carry, t):
        d = carry
        stay = d
        adv = _shift1(d)
        skip = jnp.where(skip_ok, _shift2(d), _NEG)
        cands = jnp.stack([stay, adv, skip])  # (3, B, S)
        best = jnp.max(cands, axis=0)
        choice = jnp.argmax(cands, axis=0).astype(jnp.int32)  # 0/1/2 back-steps
        nxt = lp[:, t] + best
        nxt = jnp.where(valid_pos, nxt, _NEG)
        frozen = (t >= input_lengths)[:, None]
        nxt = jnp.where(frozen, d, nxt)
        choice = jnp.where(frozen, jnp.zeros_like(choice), choice)
        return nxt, choice

    delta_T, choices = jax.lax.scan(
        step, a0, jnp.arange(1, T), unroll=8
    )
    # choices: (T-1, B, S); choices[t] = back-step for the move into t+1.

    end_pos1 = 2 * target_lengths
    end_pos2 = jnp.maximum(2 * target_lengths - 1, 0)
    v1 = jnp.take_along_axis(delta_T, end_pos1[:, None], axis=1)[:, 0]
    v2 = jnp.take_along_axis(delta_T, end_pos2[:, None], axis=1)[:, 0]
    last_pos = jnp.where(v1 >= v2, end_pos1, end_pos2).astype(jnp.int32)
    score = jnp.maximum(v1, v2)

    def back(pos, ch_t):
        step_back = jnp.take_along_axis(ch_t, pos[:, None], axis=1)[:, 0]
        prev = pos - step_back
        return prev, pos

    # Reverse scan: ys[i] is the position at frame i+1 (the carry when
    # processing the move into frame i+1); the final carry is frame 0's
    # position. Prepend it — appending last_pos instead (as this code
    # once did) shifts the whole alignment one frame late and loses
    # frame 0.
    first_pos, positions = jax.lax.scan(
        back, last_pos, choices, reverse=True
    )
    positions = jnp.concatenate(
        [first_pos[:, None], positions.swapaxes(0, 1)], axis=1
    )  # (B, T) lattice positions
    alignment = _tokens_at(expanded, positions)
    return alignment, score


def ctc_alignment_path(
    log_probs: jax.Array,
    targets: jax.Array,
    input_lengths: jax.Array,
    target_lengths: jax.Array,
    blank_id: int = 0,
) -> List[jax.Array]:
    """Posterior-argmax alignment (``ctc.py:202-256``) — with a working
    forward pass (the reference never fills its α, ``ctc.py:224-231``).

    Returns per-batch token sequences trimmed to ``input_lengths``.
    """
    log_alpha, _ = ctc_forward_algorithm(
        log_probs, targets, input_lengths, target_lengths, blank_id
    )
    log_beta = ctc_backward_algorithm(
        log_probs, targets, input_lengths, target_lengths, blank_id
    )
    expanded = expand_targets_with_blank(targets, blank_id)
    best_pos = jnp.argmax(log_alpha + log_beta, axis=-1)  # (B, T)
    tokens = _tokens_at(expanded, best_pos)
    lens = np.asarray(input_lengths)
    return [tokens[b, : lens[b]] for b in range(tokens.shape[0])]


# ---------------------------------------------------------------------------
# Decode utilities (``ctc.py:464-485``)
# ---------------------------------------------------------------------------

def remove_ctc_blanks(sequence: jax.Array, blank_id: int = 0) -> jax.Array:
    seq = np.asarray(sequence)
    return jnp.asarray(seq[seq != blank_id])


def collapse_repeated_tokens(sequence: jax.Array) -> jax.Array:
    seq = np.asarray(sequence)
    if seq.size == 0:
        return jnp.asarray(seq)
    keep = np.concatenate([[True], seq[1:] != seq[:-1]])
    return jnp.asarray(seq[keep])


def ctc_decode_sequence(sequence: jax.Array, blank_id: int = 0) -> jax.Array:
    """Collapse repeats, then drop blanks (standard CTC decoding rule)."""
    return remove_ctc_blanks(collapse_repeated_tokens(sequence), blank_id)


# ---------------------------------------------------------------------------
# Aligner modules
# ---------------------------------------------------------------------------

class CTCAligner:
    """CTC loss / decode / forced alignment (``ctc.py:259-381``)."""

    def __init__(
        self,
        num_classes: int,
        blank_id: int = 0,
        reduction: str = "mean",
    ):
        self.num_classes = num_classes
        self.blank_id = blank_id
        self.reduction = reduction

    def __call__(self, log_probs, targets, input_lengths, target_lengths):
        """CTC loss (``ctc.py:285-308``)."""
        return ctc_loss(
            log_probs, targets, input_lengths, target_lengths,
            self.blank_id, self.reduction,
        )

    forward = __call__

    def decode(
        self,
        log_probs: jax.Array,
        input_lengths: jax.Array,
        beam_width: int = 1,
    ) -> List[jax.Array]:
        """Greedy (``beam_width == 1``) or prefix-beam-search decoding.

        Both paths run as single batched jit programs on device
        (:mod:`ctc_decode`); the list-of-ragged return is a host-side
        view. For a pure device pipeline use :meth:`decode_batch`.
        (The reference's "beam search" silently runs greedy,
        ``ctc.py:355-362``.)
        """
        tokens, out_lens = self.decode_batch(
            log_probs, input_lengths, beam_width
        )
        lens = np.asarray(out_lens)
        return [tokens[b, : lens[b]] for b in range(tokens.shape[0])]

    def decode_batch(
        self,
        log_probs: jax.Array,
        input_lengths: jax.Array,
        beam_width: int = 1,
    ) -> Tuple[jax.Array, jax.Array]:
        """Batched decode on device: ``(tokens (B, L), out_lengths (B,))``
        padded with ``blank_id`` — no per-utterance host loop."""
        from .ctc_decode import beam_search_decode_batch, greedy_decode_batch

        if beam_width == 1:
            return greedy_decode_batch(
                log_probs, input_lengths, self.blank_id
            )
        return beam_search_decode_batch(
            log_probs, input_lengths, beam_width, self.blank_id
        )

    def align(
        self, log_probs, targets, input_lengths, target_lengths
    ) -> List[jax.Array]:
        """Forced alignment via exact lattice Viterbi (``ctc.py:364-381``).
        Returns per-batch frame-level token sequences."""
        alignment, _ = ctc_viterbi_alignment(
            log_probs, targets, input_lengths, target_lengths, self.blank_id
        )
        lens = np.asarray(input_lengths)
        return [alignment[b, : lens[b]] for b in range(alignment.shape[0])]


def _prefix_beam_search(
    lp: np.ndarray, beam_width: int, blank_id: int
) -> np.ndarray:
    """Standard CTC prefix beam search over one utterance (T, C)."""
    # Each prefix maps to (log p ending in blank, log p ending in non-blank).
    beams = {(): (0.0, -np.inf)}
    for t in range(lp.shape[0]):
        new: dict = {}

        def add(prefix, pb, pnb):
            opb, opnb = new.get(prefix, (-np.inf, -np.inf))
            new[prefix] = (np.logaddexp(opb, pb), np.logaddexp(opnb, pnb))

        for prefix, (pb, pnb) in beams.items():
            p_tot = np.logaddexp(pb, pnb)
            # blank extends the same prefix
            add(prefix, p_tot + lp[t, blank_id], -np.inf)
            for c in range(lp.shape[1]):
                if c == blank_id:
                    continue
                p = lp[t, c]
                if prefix and prefix[-1] == c:
                    # repeat: same prefix (no blank between) …
                    add(prefix, -np.inf, pnb + p)
                    # … or new token after a blank
                    add(prefix + (c,), -np.inf, pb + p)
                else:
                    add(prefix + (c,), -np.inf, p_tot + p)
        beams = dict(
            sorted(
                new.items(),
                key=lambda kv: -np.logaddexp(*kv[1]),
            )[:beam_width]
        )
    best = max(beams.items(), key=lambda kv: np.logaddexp(*kv[1]))[0]
    return np.asarray(best, dtype=np.int32)


class CTCSegmentationAligner(CTCAligner):
    """Long-audio segmentation + per-segment text assignment
    (``ctc.py:384-460``; the reference's text estimator references an
    undefined variable at ``ctc.py:454`` — fixed here)."""

    def __init__(
        self,
        num_classes: int,
        min_segment_length: int = 50,
        max_segment_length: int = 1000,
        **kwargs,
    ):
        super().__init__(num_classes=num_classes, **kwargs)
        self.min_segment_length = min_segment_length
        self.max_segment_length = max_segment_length

    def segment_and_align(
        self,
        log_probs: jax.Array,
        full_transcript: jax.Array,
        segment_boundaries: Optional[jax.Array] = None,
    ) -> List[Tuple[jax.Array, jax.Array, int, int]]:
        """Split ``(T, C)`` log-probs into segments and assign transcript
        spans proportionally. Returns
        ``[(segment_log_probs, segment_text, start, end), ...]``."""
        T = log_probs.shape[0]
        if segment_boundaries is None:
            segment_boundaries = self._detect_segment_boundaries(
                log_probs, full_transcript
            )
        bounds = [int(x) for x in np.asarray(segment_boundaries)]
        if not bounds or bounds[-1] != T:
            bounds = bounds + [T]

        U = full_transcript.shape[0]
        segments = []
        prev = 0
        for boundary in bounds:
            # Sub-minimum spans are MERGED into the next segment (prev only
            # advances on emission), so every frame lands in exactly one
            # segment and the proportional transcript split stays a
            # partition; a short trailing span attaches to the last segment.
            if boundary - prev >= self.min_segment_length:
                seg_lp = log_probs[prev:boundary]
                lo = int(round(prev * U / T))
                hi = int(round(boundary * U / T))
                segments.append(
                    (seg_lp, full_transcript[lo:hi], prev, boundary)
                )
                prev = boundary
        if prev < T:
            # Trailing frames shorter than min_segment_length: extend the
            # final segment rather than dropping audio/transcript.
            if segments:
                seg_lp, _, start, _ = segments[-1]
                lo = int(round(start * U / T))
                segments[-1] = (
                    log_probs[start:T], full_transcript[lo:U], start, T
                )
            else:
                segments.append((log_probs[0:T], full_transcript[0:U], 0, T))
        return segments

    def _detect_segment_boundaries(
        self, log_probs: jax.Array, transcript: jax.Array
    ) -> jax.Array:
        """Fixed-length segmentation (``ctc.py:438-445``)."""
        T = log_probs.shape[0]
        bounds = jnp.arange(0, T, self.max_segment_length)
        return bounds[bounds > 0] if bounds.shape[0] > 1 else jnp.asarray([T])
