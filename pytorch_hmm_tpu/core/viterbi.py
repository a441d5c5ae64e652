"""Viterbi decoding as JAX scans (max-product semiring).

The reference implements Viterbi at least four times in sequential Python
loops (``hmm.py:132-184``, ``mixture_gaussian.py:290-338``,
``hsmm.py:245-354``, ``streaming.py:267-377``, ``neural.py:463-511``).
Here there is exactly one trellis implementation, parameterized by:

* static ``(K, K)`` or time-varying ``(B, T, K, K)`` log transitions
  (the latter subsumes NeuralHMM);
* optional per-sequence ``lengths`` for padded batches;
* an initial log distribution ``log_pi`` (``(K,)`` or ``(B, K)``).

Forward pass is a ``lax.scan`` carrying the ``(B, K)`` score vector and
emitting ``(B, K)`` int32 backpointers; backtrace is a reverse scan of
O(1)-per-step gathers. Both jit cleanly and run on-device end to end.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from .semiring import SCAN_UNROLL, max_matmul

__all__ = ["viterbi", "viterbi_associative"]


@partial(jax.jit, static_argnames=("return_score", "unroll"))
def viterbi(
    log_obs: jax.Array,
    log_a: jax.Array,
    log_pi: jax.Array,
    lengths: Optional[jax.Array] = None,
    return_score: bool = True,
    unroll: int = SCAN_UNROLL,
):
    """Most-likely state path.

    Args:
        log_obs: ``(B, T, K)`` per-state observation log-likelihoods.
        log_a: ``(K, K)`` static or ``(B, T, K, K)`` time-varying log
            transition matrix (entry ``[:, t]`` used for the step into t).
        log_pi: ``(K,)`` or ``(B, K)`` initial log-probabilities.
        lengths: optional ``(B,)`` valid lengths; the path for padded frames
            repeats the final valid state.
        return_score: also return the path log-score.
        unroll: time steps per trip of the XLA loops.

    Returns:
        ``states (B, T) int32`` and, if requested, ``score (B,)`` — the log
        joint probability of the best path (reference
        ``HMMPyTorch.viterbi_decode``, ``hmm.py:132-184``).
    """
    B, T, K = log_obs.shape
    tv = log_a.ndim >= 3
    delta0 = log_pi + log_obs[:, 0]

    def fwd(carry, xs):
        delta, t = carry
        if tv:
            lo_t, la_t = xs
            scores = delta[:, :, None] + la_t
        else:
            lo_t = xs
            scores = delta[:, :, None] + log_a[None]
        best = jnp.max(scores, axis=-2) + lo_t
        psi = jnp.argmax(scores, axis=-2).astype(jnp.int32)
        if lengths is not None:
            keep = (t < lengths)[:, None]
            best = jnp.where(keep, best, delta)
            # Pad frames point at themselves so the backtrace is a no-op.
            psi = jnp.where(
                keep, psi, jnp.arange(K, dtype=jnp.int32)[None, :]
            )
        return (best, t + 1), psi

    xs = (log_obs[:, 1:].swapaxes(0, 1), log_a[:, 1:].swapaxes(0, 1)) if tv \
        else log_obs[:, 1:].swapaxes(0, 1)
    (delta_T, _), psis = jax.lax.scan(
        fwd, (delta0, jnp.int32(1)), xs, unroll=unroll
    )
    # psis[t] are the backpointers for step t+1 (into frame t+1), t in [0, T-2].

    last_state = jnp.argmax(delta_T, axis=-1).astype(jnp.int32)
    score = jnp.max(delta_T, axis=-1)

    # Backtrace without per-step gathers: carry the state as a one-hot row
    # and select the backpointer by multiply-reduce (indices stay exact in
    # f32 for K <= 2^24).
    iota = jnp.arange(K, dtype=jnp.float32)[None, :]
    oh0 = (iota == last_state[:, None].astype(jnp.float32)).astype(
        jnp.float32
    )

    def back(oh, psi_t):
        prev = jnp.sum(psi_t.astype(jnp.float32) * oh, axis=-1,
                       keepdims=True)
        return (iota == prev).astype(jnp.float32), prev[:, 0]

    _, prev_states = jax.lax.scan(
        back, oh0, psis, reverse=True, unroll=unroll
    )
    states = jnp.concatenate(
        [prev_states.swapaxes(0, 1).astype(jnp.int32),
         last_state[:, None]],
        axis=1,
    )

    if lengths is not None:
        # Re-anchor: the valid final state lives at index lengths-1; frames
        # past it were identity steps so states[:, lengths-1:] are constant.
        idx = jnp.minimum(
            jnp.arange(T, dtype=jnp.int32)[None, :], (lengths - 1)[:, None]
        )
        states = jnp.take_along_axis(states, idx, axis=1)

    if return_score:
        return states, score
    return states


@jax.jit
def viterbi_associative(
    log_obs: jax.Array,
    log_a: jax.Array,
    log_pi: jax.Array,
    lengths: Optional[jax.Array] = None,
):
    """Fully parallel Viterbi: O(log T) depth, no sequential loop.

    Three associative stages (cf. Särkkä & García-Fernández,
    arXiv:2102.05743, §4, adapted to the tropical semiring):

    1. all-prefix trellis values ``delta_t`` via a (max, +) matrix
       associative scan (O(T·K³) work on big batched contractions);
    2. backpointers for every frame at once (one vectorized
       ``(B, T, K, K)`` argmax — no loop);
    3. backtrace as a *map-composition* associative scan: each frame's
       backpointer row is a function K→K; suffix compositions evaluated
       at the final argmax give the whole path.

    For small K and long T, where the sequential scan is bound by its
    per-step loop overhead. Static transitions only.
    ``lengths`` (B,) marks ragged batches: steps into padded frames are
    tropical identity matrices, freezing the trellis, so paths match the
    unpadded per-sequence result (padding repeats the final valid state).
    Returns ``(states (B, T) int32, score (B,))``.
    """
    B, T, K = log_obs.shape
    if log_a.ndim != 2:
        raise ValueError("viterbi_associative requires static (K, K) log_a")

    # Stage 1: prefix max-products. Element 0 is rank-1 (rows = delta_0)
    # so row 0 of every prefix equals delta_t (same trick as the
    # sum-semiring associative forward).
    m = log_a[None, None] + log_obs[:, 1:, None, :]       # (B, T-1, K, K)
    d0 = jnp.broadcast_to(
        (log_pi + log_obs[:, 0])[:, None, None, :], (B, 1, K, K)
    )
    chain = jnp.concatenate([d0, m], axis=1)              # (B, T, K, K)
    ident_i32 = jnp.arange(K, dtype=jnp.int32)[None, None, :]
    if lengths is not None:
        pad = jnp.arange(T)[None, :] >= lengths[:, None]  # (B, T)
        eye = jnp.where(jnp.eye(K, dtype=bool), 0.0, -1e30)
        chain = jnp.where(pad[:, :, None, None], eye[None, None], chain)

    prefixes = jax.lax.associative_scan(max_matmul, chain, axis=1)
    delta = prefixes[:, :, 0, :]                          # (B, T, K)

    # Stage 2: all backpointers at once. psi[t, j] = argmax_i
    # (delta[t-1, i] + log_a[i, j]) for t >= 1; psi[0] = identity.
    scores = delta[:, :-1, :, None] + log_a[None, None]   # (B, T-1, K, K)
    psi = jnp.argmax(scores, axis=2).astype(jnp.int32)    # (B, T-1, K)
    ident = jnp.broadcast_to(ident_i32, (B, 1, K))
    psi = jnp.concatenate([ident, psi], axis=1)           # (B, T, K)
    if lengths is not None:
        # Padded steps are identity maps so the backtrace passes through
        # and every frame >= length-1 carries the final valid state.
        psi = jnp.where(pad[:, :, None], ident_i32, psi)

    # Stage 3: suffix compositions of the backpointer maps.
    # s_t = (psi_{t+1} ∘ psi_{t+2} ∘ … ∘ psi_{T-1})(s_{T-1});
    # combine(f, g) = f∘g evaluated as f[g] (gather), associative.
    def compose(acc, new):
        # Under reverse=True the accumulated value covers LATER frames
        # and ``new`` is the next-earlier map; the suffix we need is
        # new ∘ acc, i.e. apply the later composition first:
        # (new ∘ acc)[j] = new[acc[j]].
        return jnp.take_along_axis(new, acc, axis=-1)

    maps = jnp.concatenate([psi[:, 1:], ident], axis=1)   # map INTO frame t
    suffix = jax.lax.associative_scan(
        compose, maps, axis=1, reverse=True
    )                                                     # (B, T, K)

    last_state = jnp.argmax(delta[:, -1], axis=-1).astype(jnp.int32)
    score = jnp.max(delta[:, -1], axis=-1)
    states = jnp.take_along_axis(
        suffix, last_state[:, None, None].repeat(T, 1), axis=2
    )[:, :, 0]
    return states, score


@partial(jax.jit, static_argnames=("blocks", "unroll"))
def viterbi_blocked(
    log_obs: jax.Array,
    log_a: jax.Array,
    log_pi: jax.Array,
    blocks: int = 8,
    unroll: int = 8,
    lengths: Optional[jax.Array] = None,
):
    """Single-device time-block-parallel Viterbi.

    The sequential scan is latency-bound per step regardless of the step
    body, so the wall clock is set by the chain *length*. This runs the
    same block-parallel decomposition as ``parallel.sharded_viterbi`` but
    with the P blocks vectorized into the batch dimension of one device:
    three chains of length T/P
    (operator fold, rescan, hypothesis backtrace) replace two chains of
    length T — a ~P/3 wall-clock win for small K where the extra
    O(K³/K²) fold work stays cheap.

    Exact: identical paths to ``viterbi``. Static (K, K) transitions.
    ``lengths`` (B,) marks ragged batches (steps into padded frames are
    identity, so paths repeat each row's final valid state).
    Returns ``(states (B, T), score (B,))``.
    """
    B, T, K = log_obs.shape
    if log_a.ndim != 2:
        raise ValueError("viterbi_blocked requires static (K, K) log_a")
    P = blocks
    Tb = -(-T // P)
    Tp = Tb * P
    neg = jnp.asarray(-1e30, log_obs.dtype)
    lo = jnp.pad(log_obs, ((0, 0), (0, Tp - T), (0, 0)))
    # (B, P, Tb, K) — time-major per block for the scans.
    lo_b = lo.reshape(B, P, Tb, K)
    delta0 = log_pi + log_obs[:, 0]

    g_idx = (
        jnp.arange(P)[:, None] * Tb + jnp.arange(Tb)[None, :]
    )  # (P, Tb) global frame index

    # Per-row effective length: frames >= this are identity steps. The
    # all-full case uses the same mask machinery with eff_len = T.
    eff_len = (jnp.full((B,), T, jnp.int32) if lengths is None
               else lengths.astype(jnp.int32))

    eye = jnp.where(jnp.eye(K, dtype=bool), 0.0, neg)

    # ---- Phase A: per-block operator fold (chain length Tb) ----
    def fold(carry, xs):
        lo_t, t = xs  # (B, P, K), (P,)
        m = log_a[None, None] + lo_t[:, :, None, :]
        rank1 = jnp.broadcast_to(delta0[:, None, None, :], (B, P, K, K))
        # Global frame 0 (block 0 position 0) is the rank-1 seed; padded
        # frames (t >= eff_len) are identity steps.
        m = jnp.where((t == 0)[None, :, None, None], rank1, m)
        m = jnp.where(
            (t[None, :] >= eff_len[:, None])[:, :, None, None],
            eye[None, None], m,
        )
        return max_matmul(carry, m), None

    f0 = jnp.broadcast_to(eye, (B, P, K, K))
    F, _ = jax.lax.scan(
        fold, f0, (lo_b.transpose(2, 0, 1, 3), g_idx.T), unroll=unroll
    )  # (B, P, K, K)

    # ---- Prefix over blocks (P tiny steps, unrolled) ----
    entries = [jnp.broadcast_to(delta0, (B, K))]  # entry delta per block
    acc = F[:, 0]
    for b in range(1, P):
        entries.append(acc[:, 0, :])  # rank-1 rows → delta at block start-1
        acc = max_matmul(acc, F[:, b])
    entry = jnp.stack(entries, axis=1)  # (B, P, K)
    score = jnp.max(acc[:, 0, :], axis=-1)
    final_state = jnp.argmax(acc[:, 0, :], axis=-1).astype(jnp.int32)

    # ---- Phase B: per-block rescan (chain length Tb) ----
    def rescan(carry, xs):
        lo_t, t = xs
        stepped = (
            jnp.max(carry[:, :, :, None] + log_a[None, None], axis=2) + lo_t
        )
        first = delta0[:, None, :] + 0.0 * lo_t
        d = jnp.where((t == 0)[None, :, None], first, stepped)
        d = jnp.where(
            (t[None, :] >= eff_len[:, None])[:, :, None], carry, d
        )
        return d, d

    _, deltas = jax.lax.scan(
        rescan, entry, (lo_b.transpose(2, 0, 1, 3), g_idx.T), unroll=unroll
    )  # (Tb, B, P, K)
    delta_flat = (
        deltas.transpose(1, 2, 0, 3).reshape(B, Tp, K)[:, :T]
    )

    # ---- All backpointers vectorized (no chain) ----
    psi = jnp.argmax(
        delta_flat[:, :-1, :, None] + log_a[None, None], axis=2
    ).astype(jnp.int32)  # (B, T-1, K): map into frame t (t >= 1)
    ident = jnp.broadcast_to(
        jnp.arange(K, dtype=jnp.int32)[None, None, :], (B, 1, K)
    )
    psi = jnp.concatenate([ident, psi], axis=1)  # (B, T, K)
    psi = jnp.pad(psi, ((0, 0), (0, Tp - T), (0, 0)), mode="edge")
    # Padded frames: identity maps so the backtrace passes through.
    pad_mask = jnp.arange(Tp)[None, :] >= eff_len[:, None]
    psi = jnp.where(
        pad_mask[:, :, None], jnp.arange(K, dtype=jnp.int32)[None, None],
        psi,
    )
    psi_b = psi.reshape(B, P, Tb, K)

    # ---- Phase C: per-block hypothesis backtrace (chain length Tb) ----
    all_states = jnp.broadcast_to(
        jnp.arange(K, dtype=jnp.int32)[None, None, :], (B, P, K)
    )

    def back(carry, psi_t):  # psi_t (B, P, K)
        prev = jnp.take_along_axis(psi_t, carry, axis=2)
        return prev, carry

    link, states_rev = jax.lax.scan(
        back, all_states, psi_b.transpose(2, 0, 1, 3), reverse=True,
        unroll=unroll,
    )
    # states_rev: (Tb, B, P, K) — state at each local frame per exit
    # hypothesis; link: (B, P, K) — predecessor exit state in block b-1.

    # ---- Stitch block exit states (P tiny steps) ----
    exits = [None] * P
    exits[P - 1] = final_state
    for b in range(P - 1, 0, -1):
        exits[b - 1] = jnp.take_along_axis(
            link[:, b], exits[b][:, None], axis=1
        )[:, 0]
    exit_states = jnp.stack(exits, axis=1)  # (B, P)

    sel = exit_states[:, None, :, None]  # (B, 1, P, 1)
    states = jnp.take_along_axis(
        states_rev.transpose(1, 0, 2, 3), 
        jnp.broadcast_to(sel, (B, Tb, P, 1)),
        axis=3,
    )[..., 0]  # (B, Tb, P)
    states = states.transpose(0, 2, 1).reshape(B, Tp)[:, :T]
    return states, score
