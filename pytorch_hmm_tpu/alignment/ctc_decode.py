"""Device-side batched CTC decoding (greedy + prefix beam search).

The reference's beam search is a stub that silently falls back to greedy
(``ctc.py:355-362``), and our original port ran a host-side numpy prefix
beam per utterance. Here both decoders are single jitted programs over
the whole batch:

* :func:`greedy_decode_batch` — argmax, collapse-repeats, drop-blanks as
  one masked cumsum + scatter compaction. No host loop, no host sync.
* :func:`beam_search_decode_batch` — an exact fixed-width prefix beam
  search. Beams live in fixed-shape buffers ``(W, L)``; per frame, each
  beam expands into blank/repeat/new-token candidates; duplicate
  prefixes (same prefix reached from different parents) are merged with
  an N×N rolling-hash equality matrix + masked logsumexp — fully
  vectorized, `vmap`-ped over the batch. Same technique as the
  fixed-width streaming beam (``streaming.py``).

Both return padded ``(tokens (B, Lmax), lengths (B,))`` device arrays —
the static-shape contract; list-of-ragged views are a host-side
convenience at the API boundary (``CTCAligner.decode``).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = ["greedy_decode_batch", "beam_search_decode_batch"]

_NEG = -1e30
# Plain int (not a jnp scalar): a module-level jnp constant would
# initialize the XLA backend at import time, breaking multihost setups
# that must call jax.distributed.initialize first.
_HASH_MULT = 1000003


@partial(jax.jit, static_argnames=("blank_id",))
def greedy_decode_batch(
    log_probs: jax.Array,
    input_lengths: jax.Array,
    blank_id: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """Batched greedy CTC decode, entirely on device.

    Args:
        log_probs: ``(T, B, C)`` frame log-probabilities (torch layout,
            matching :func:`ctc_forward_algorithm`).
        input_lengths: ``(B,)`` valid frame counts.
        blank_id: blank token id.

    Returns:
        ``(tokens (B, T), out_lengths (B,))`` — row ``b`` holds its
        decoded tokens in ``tokens[b, :out_lengths[b]]``; the padding is
        ``blank_id``.
    """
    T, B, C = log_probs.shape
    best = jnp.argmax(log_probs, axis=-1).T.astype(jnp.int32)  # (B, T)
    prev = jnp.concatenate(
        [jnp.full((B, 1), -1, jnp.int32), best[:, :-1]], axis=1
    )
    in_range = jnp.arange(T)[None, :] < input_lengths[:, None]
    # Collapse repeats first, then drop blanks (standard CTC rule).
    keep = (best != prev) & (best != blank_id) & in_range

    pos = jnp.cumsum(keep, axis=1) - 1  # output slot per kept frame
    idx = jnp.where(keep, pos, T)  # T = out of bounds -> dropped
    tokens = jnp.full((B, T), blank_id, jnp.int32)
    tokens = tokens.at[jnp.arange(B)[:, None], idx].set(best, mode="drop")
    return tokens, jnp.sum(keep, axis=1).astype(jnp.int32)


def _beam_step_single(carry, xs, *, W: int, L: int, C: int, blank_id: int):
    """One prefix-beam frame for one sequence.

    Beam state: ``tokens (W, L)``, ``lens (W,)``, ``h (W,) uint32``
    rolling prefix hashes, ``pb/pnb (W,)`` blank/non-blank ending
    log-probs. Frames past the row's length are identity.
    """
    tokens, lens, h, pb, pnb = carry
    lp_t, active = xs  # (C,), scalar bool
    p_tot = jnp.logaddexp(pb, pnb)  # (W,)

    last = jnp.take_along_axis(
        tokens, jnp.maximum(lens - 1, 0)[:, None], axis=1
    )[:, 0]  # (W,)
    has_last = lens > 0

    # --- candidates that KEEP each beam's prefix -------------------------
    # blank-extend: any path + blank; repeat-extend: non-blank path + last.
    keep_pb = p_tot + lp_t[blank_id]
    rep_score = jnp.where(has_last, lp_t[jnp.where(has_last, last, 0)], _NEG)
    keep_pnb = pnb + rep_score

    # --- candidates that EXTEND each beam with a non-blank token c -------
    # (W, C) grids; column blank_id is masked out.
    c_ids = jnp.arange(C)
    is_rep = has_last[:, None] & (c_ids[None, :] == last[:, None])
    # repeat token right after itself needs an intervening blank: only the
    # blank-ending mass extends; otherwise the whole mass extends.
    ext_base = jnp.where(is_rep, pb[:, None], p_tot[:, None])
    ext_pnb = ext_base + lp_t[None, :]  # (W, C)
    ext_pnb = jnp.where(c_ids[None, :] == blank_id, _NEG, ext_pnb)
    ext_pnb = jnp.where(lens[:, None] >= L, _NEG, ext_pnb)  # buffer full

    # --- flatten to one candidate list -----------------------------------
    # N = W (keep) + W*C (extend)
    cand_h = jnp.concatenate([h, (h[:, None] * _HASH_MULT
                                  + c_ids[None, :].astype(jnp.uint32)
                                  + 1).reshape(-1)])
    cand_pb = jnp.concatenate([keep_pb, jnp.full((W * C,), _NEG)])
    cand_pnb = jnp.concatenate([keep_pnb, ext_pnb.reshape(-1)])
    cand_parent = jnp.concatenate(
        [jnp.arange(W), jnp.repeat(jnp.arange(W), C)]
    )
    cand_new = jnp.concatenate(
        [jnp.full((W,), -1, jnp.int32),
         jnp.tile(c_ids, W).astype(jnp.int32)]
    )
    N = W + W * C

    # --- merge duplicate prefixes (same hash) ----------------------------
    # Dead candidates must not merge with each other: give them unique
    # sentinel hashes.
    dead = jnp.maximum(cand_pb, cand_pnb) <= _NEG / 2
    cand_h = jnp.where(
        dead, jnp.uint32(0x80000000) + jnp.arange(N, dtype=jnp.uint32),
        cand_h,
    )
    eq = cand_h[:, None] == cand_h[None, :]  # (N, N)

    def mlse(v):
        return jax.nn.logsumexp(
            jnp.where(eq, v[None, :], -jnp.inf), axis=1
        )

    pb_m = mlse(cand_pb)
    pnb_m = mlse(cand_pnb)
    first = jnp.argmax(eq, axis=1) == jnp.arange(N)  # first occurrence
    total = jnp.where(first, jnp.logaddexp(pb_m, pnb_m), -jnp.inf)

    # --- top-W ------------------------------------------------------------
    _, top = jax.lax.top_k(total, W)
    sel_parent = cand_parent[top]
    sel_new = cand_new[top]
    new_tokens = tokens[sel_parent]
    new_lens = lens[sel_parent]
    appended = sel_new >= 0
    slot = jnp.minimum(new_lens, L - 1)
    new_tokens = jnp.where(
        appended[:, None]
        & (jnp.arange(L)[None, :] == slot[:, None]),
        sel_new[:, None],
        new_tokens,
    )
    new_lens = new_lens + appended.astype(jnp.int32)
    new_state = (
        new_tokens,
        new_lens,
        cand_h[top],
        jnp.maximum(pb_m[top], _NEG),
        jnp.maximum(pnb_m[top], _NEG),
    )

    # Inactive frame (t >= input length): carry through untouched.
    out = jax.tree.map(
        lambda new, old: jnp.where(
            jnp.reshape(active, (1,) * new.ndim), new, old
        ),
        new_state, carry,
    )
    return out, None


@partial(jax.jit, static_argnames=("beam_width", "blank_id", "max_tokens"))
def beam_search_decode_batch(
    log_probs: jax.Array,
    input_lengths: jax.Array,
    beam_width: int = 4,
    blank_id: int = 0,
    max_tokens: int | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """Batched exact prefix beam search, entirely on device.

    Args:
        log_probs: ``(T, B, C)`` frame log-probabilities.
        input_lengths: ``(B,)`` valid frame counts.
        beam_width: number of live prefixes per sequence.
        blank_id: blank token id.
        max_tokens: output-length cap (default ``T``).

    Returns:
        ``(tokens (B, Lmax), out_lengths (B,))`` for the best prefix per
        sequence (padding = ``blank_id``).
    """
    T, B, C = log_probs.shape
    W = beam_width
    L = max_tokens if max_tokens is not None else T

    def run_one(lp, n):
        tokens0 = jnp.zeros((W, L), jnp.int32)
        lens0 = jnp.zeros((W,), jnp.int32)
        h0 = jnp.zeros((W,), jnp.uint32)
        pb0 = jnp.full((W,), _NEG).at[0].set(0.0)
        pnb0 = jnp.full((W,), _NEG)
        step = partial(
            _beam_step_single, W=W, L=L, C=C, blank_id=blank_id
        )
        (tokens, lens, _, pb, pnb), _ = jax.lax.scan(
            step,
            (tokens0, lens0, h0, pb0, pnb0),
            (lp, jnp.arange(T) < n),
        )
        best = jnp.argmax(jnp.logaddexp(pb, pnb))
        out = jnp.where(
            jnp.arange(L) < lens[best], tokens[best], blank_id
        )
        return out, lens[best]

    return jax.vmap(run_one)(log_probs.transpose(1, 0, 2), input_lengths)
