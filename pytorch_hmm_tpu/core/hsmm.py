"""Explicit-duration (semi-Markov) DP kernels.

The reference decodes HSMMs with a quadruple-nested Python loop over
(t, state, duration, predecessor) — O(T·S²·D²) interpreter time
(``hsmm.py:245-354``; again in ``semi_markov.py:308-383, 455-570``) and
warns beyond T=1000. Here the same segment DP is a single ``lax.scan``
over time with O(D·S + S²) fully-vectorized work per step:

* cumulative emission sums turn segment scores into two-gather
  differences: ``E(s, t-d+1..t) = C(s, t) − C(s, t-d)``;
* the predecessor maximization is hoisted out of the duration loop:
  ``μ(t, s) = op_{s'}(score(t, s') + log_a[s', s])`` is computed once per
  frame and consumed by *later* frames' duration scans, so the per-frame
  duration reduction is a (D, S) elementwise op, not (D, S²);
* a (D, S) ring buffer in the scan carry holds the last D values of μ
  and C — the only state the recursion ever needs.

One kernel serves both semirings: ``max`` (Viterbi segmentation, with
backpointers) and ``sum`` (forward algorithm / likelihood, differentiable
for training). HSMM semantics: transitions carry no self-loops (state
changes between segments); durations live in ``1..max_duration`` with a
(S, D) log-pmf whose entries below ``min_duration`` are -inf.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .semiring import logsumexp

__all__ = [
    "hsmm_forward",
    "hsmm_backward",
    "hsmm_posteriors",
    "hsmm_viterbi",
    "hsmm_log_z",
    "hsmm_grads_from_tables",
    "hsmm_posteriors_from_tables",
]

_NEG = -1e30  # finite log(0): keeps gradients NaN-free in the sum path


def _masked(x, mask):
    return jnp.where(mask, x, _NEG)


def _final_gather(table: jax.Array, lengths) -> jax.Array:
    """``table[b, lengths[b] - 1]`` — (B, T, S) → (B, S)."""
    idx = (lengths - 1).astype(jnp.int32)[:, None, None]
    return jnp.take_along_axis(
        table, jnp.broadcast_to(idx, (table.shape[0], 1, table.shape[2])),
        axis=1,
    )[:, 0]


@partial(jax.jit, static_argnames=())
def hsmm_forward(
    log_obs: jax.Array,
    log_a: jax.Array,
    log_pi: jax.Array,
    log_dur: jax.Array,
    lengths: jax.Array | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """HSMM forward algorithm.

    Args:
        log_obs: ``(B, T, S)`` per-state observation log-likelihoods.
        log_a: ``(S, S)`` log transition matrix (diagonal should be -inf /
            very negative — no self-loops between segments).
        log_pi: ``(S,)`` initial state log-probabilities.
        log_dur: ``(S, D)`` duration log-pmf; column ``j`` is duration
            ``j+1`` frames.
        lengths: optional ``(B,)`` valid lengths for ragged batches.
            ``log_z[b]`` then scores frames ``0..lengths[b]-1`` only;
            ``log_alpha_star[b, t]`` is unspecified for ``t >= lengths[b]``
            (alpha at frame ``t`` never depends on later frames, so
            in-range entries are exact without any masking).

    Returns:
        ``(log_alpha_star (B, T, S), log_z (B,))`` — ``log_alpha_star[t,s]``
        is the log-probability of the observations up to ``t`` with a
        segment of state ``s`` ending exactly at ``t``; ``log_z`` is the
        sequence log-likelihood (segmentations ending at the final valid
        frame).
    """
    out = _hsmm_scan(log_obs, log_a, log_pi, log_dur, viterbi=False)
    log_alpha, _, _ = out
    fin = (
        log_alpha[:, -1] if lengths is None
        else _final_gather(log_alpha, lengths)
    )
    log_z = logsumexp(fin, axis=-1)
    return log_alpha, log_z


@partial(jax.jit, static_argnames=())
def hsmm_viterbi(
    log_obs: jax.Array,
    log_a: jax.Array,
    log_pi: jax.Array,
    log_dur: jax.Array,
    lengths: jax.Array | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """Most-likely segmentation. Returns ``(states (B, T), score (B,))``.

    Replaces reference ``HSMMLayer._viterbi_decode_single``
    (``hsmm.py:245-354``) — batched, scan-based, O(T·(DS+S²)). With
    ``lengths`` (B,), each row decodes only its valid prefix; padded
    frames repeat the row's final valid state (same convention as
    ``core.viterbi``).
    """
    delta, dstar, phi = _hsmm_scan(log_obs, log_a, log_pi, log_dur,
                                   viterbi=True)
    B, T, S = log_obs.shape
    if lengths is None:
        delta_T = delta[:, -1]  # (B, S)
        dstar_T = dstar[:, -1]
    else:
        delta_T = _final_gather(delta, lengths)
        dstar_T = _final_gather(dstar, lengths)
    score = jnp.max(delta_T, axis=-1)
    s0 = jnp.argmax(delta_T, axis=-1).astype(jnp.int32)

    # Per-frame reverse backtrace. Carry: (state of the segment covering
    # frame t — as value AND one-hot row — and frames of that segment
    # remaining at and below t). The one-hot carry turns both per-step
    # table lookups into multiply-reduces (no lane gathers on the serial
    # chain — same trick as core.viterbi's backtrace; values stay exact
    # in f32 for S, D <= 2^24).
    iota = jnp.arange(S, dtype=jnp.float32)[None, :]
    oh0 = (iota == s0[:, None].astype(jnp.float32)).astype(jnp.float32)
    left0 = jnp.sum(dstar_T.astype(jnp.float32) * oh0, axis=1) + 1.0
    sval0 = s0.astype(jnp.float32)

    def back(carry, xs):
        oh, sval, left = carry
        phi_prev, dstar_prev, t = xs  # tables at frame t-1: (B, S)
        left_m1 = left - 1.0
        switch = left_m1 == 0.0
        s_prev = jnp.sum(phi_prev * oh, axis=1)              # (B,)
        oh_prev = (iota == s_prev[:, None]).astype(jnp.float32)
        d_prev = jnp.sum(dstar_prev * oh_prev, axis=1) + 1.0
        oh_new = jnp.where(switch[:, None], oh_prev, oh)
        s_new = jnp.where(switch, s_prev, sval)
        left_new = jnp.where(switch, d_prev, left_m1)
        if lengths is not None:
            # Frames at/past each row's length are padding: emit the
            # carried final state and leave the carry untouched.
            pad = t >= lengths
            oh_new = jnp.where(pad[:, None], oh, oh_new)
            s_new = jnp.where(pad, sval, s_new)
            left_new = jnp.where(pad, left, left_new)
        return (oh_new, s_new, left_new), sval

    # xs at step t are the (t-1)-frame tables; frame 0 gets dummies (the
    # scan's final carry is unused).
    phi_shift = jnp.concatenate([phi[:, :1], phi[:, :-1]], axis=1)
    dstar_shift = jnp.concatenate([dstar[:, :1], dstar[:, :-1]], axis=1)
    _, states = jax.lax.scan(
        back,
        (oh0, sval0, left0),
        (phi_shift.swapaxes(0, 1).astype(jnp.float32),
         dstar_shift.swapaxes(0, 1).astype(jnp.float32),
         jnp.arange(T)),
        reverse=True,
        unroll=16,
    )
    return states.swapaxes(0, 1).astype(jnp.int32), score


def _hsmm_scan(log_obs, log_a, log_pi, log_dur, viterbi: bool):
    """Shared segment-DP scan.

    Returns ``(score_table (B, T, S), dstar (B, T, S), phi (B, T, S))``;
    the last two are zeros for the sum semiring.
    """
    B, T, S = log_obs.shape
    D = log_dur.shape[-1]
    dt = log_obs.dtype

    log_a = jnp.maximum(log_a, _NEG)
    log_dur_t = jnp.maximum(log_dur.T, _NEG)  # (D, S)

    # Ring buffers over the last D frames: slot j holds the value at frame
    # t-1-j. mu(-1) = log_pi (segment starting at frame 0); C(-1) = 0.
    mu0 = jnp.full((B, D, S), _NEG, dt)
    mu0 = mu0.at[:, 0, :].set(jnp.broadcast_to(log_pi, (B, S)))
    c0 = jnp.zeros((B, D, S), dt)
    crun0 = jnp.zeros((B, S), dt)

    j_idx = jnp.arange(D)[None, :, None]  # (1, D, 1): j = d-1

    def step(carry, xs):
        mu_buf, c_buf, c_run = carry
        lo_t, t = xs
        c_t = c_run + lo_t  # C(t) inclusive

        # Candidate scores over durations d = j+1 ending at t.
        scores = (
            log_dur_t[None]                    # (1, D, S)
            + (c_t[:, None, :] - c_buf)        # segment emission sum
            + mu_buf                           # best/total entry at t-d
        )
        scores = _masked(scores, j_idx <= t)   # need t-d >= -1

        if viterbi:
            val = jnp.max(scores, axis=1)          # (B, S)
            dstar_t = jnp.argmax(scores, axis=1).astype(jnp.int32)
            trans = val[:, :, None] + log_a[None]  # (B, S', S)
            mu_t = jnp.max(trans, axis=1)
            phi_t = jnp.argmax(trans, axis=1).astype(jnp.int32)
        else:
            val = logsumexp(scores, axis=1)
            dstar_t = jnp.zeros((B, S), jnp.int32)
            trans = val[:, :, None] + log_a[None]
            mu_t = logsumexp(trans, axis=1)
            phi_t = dstar_t

        mu_buf = jnp.concatenate([mu_t[:, None], mu_buf[:, :-1]], axis=1)
        c_buf = jnp.concatenate([c_t[:, None], c_buf[:, :-1]], axis=1)
        return (mu_buf, c_buf, c_t), (val, dstar_t, phi_t)

    xs = (log_obs.swapaxes(0, 1), jnp.arange(T))
    _, (vals, dstars, phis) = jax.lax.scan(
        step, (mu0, c0, crun0), xs, unroll=4
    )
    return (
        vals.swapaxes(0, 1),
        dstars.swapaxes(0, 1),
        phis.swapaxes(0, 1),
    )


def _entry_scores(log_alpha, log_a, log_pi):
    """``nu(u, s)`` — log-score of a segment of ``s`` *starting* at
    frame ``u``: ``mu(u-1, s) = lse_{s'}(alpha*(u-1, s') + log_a[s', s])``
    with ``nu(0) = log_pi``. Shape (B, T, S)."""
    B, T, S = log_alpha.shape
    la = jnp.maximum(log_a, _NEG)
    mu = logsumexp(log_alpha[:, :-1, :, None] + la[None, None], axis=2)
    nu0 = jnp.broadcast_to(log_pi[None, None, :], (B, 1, S))
    return jnp.concatenate([nu0, mu], axis=1)


def _hsmm_grads(log_obs, log_a, log_pi, log_dur, log_alpha, log_z,
                lengths, g):
    """Closed-form cotangents of ``Σ_b g_b · log Z_b`` using the core
    XLA backward scan for the beta tables (see
    :func:`hsmm_grads_from_tables`)."""
    log_bstar, log_bstart = hsmm_backward(log_obs, log_a, log_dur, lengths)
    return hsmm_grads_from_tables(
        log_obs, log_a, log_pi, log_dur,
        log_alpha, log_bstar, log_bstart, log_z, lengths, g,
    )


def hsmm_grads_from_tables(log_obs, log_a, log_pi, log_dur, log_alpha,
                           log_bstar, log_bstart, log_z, lengths, g):
    """Closed-form cotangents of ``Σ_b g_b · log Z_b`` w.r.t. every
    log-parameter — the classic HSMM posterior expectations:

    * ``d/d log_obs``  = frame occupancy ``gamma``;
    * ``d/d log_pi``   = first-segment state posterior;
    * ``d/d log_a``    = expected segment-transition counts;
    * ``d/d log_dur``  = expected per-duration segment counts.

    Pure table algebra over precomputed alpha/beta tables (any backend
    can produce them); unlike autodiff through the forward scan, no
    O(T·B·D·S) per-step residuals are kept alive.
    """
    B, T, S = log_obs.shape
    D = log_dur.shape[-1]
    la = jnp.maximum(log_a, _NEG)
    ld = jnp.maximum(log_dur, _NEG)
    lz = log_z[:, None, None]
    gb = g[:, None, None]
    valid = (
        None if lengths is None
        else jnp.arange(T)[None, :, None] < lengths[:, None, None]
    )

    nu = _entry_scores(log_alpha, log_a, log_pi)          # (B, T, S)

    # gamma via the start/end telescoping identity (hsmm_posteriors).
    seg_end = jnp.exp(log_alpha + log_bstar - lz)
    seg_start = jnp.exp(nu + log_bstart - lz)
    if valid is not None:
        seg_end = jnp.where(valid, seg_end, 0.0)
        seg_start = jnp.where(valid, seg_start, 0.0)
    gamma = jnp.cumsum(seg_start, axis=1) - jnp.concatenate(
        [jnp.zeros_like(seg_end[:, :1]),
         jnp.cumsum(seg_end, axis=1)[:, :-1]],
        axis=1,
    )
    gamma = jnp.clip(gamma, 0.0, 1.0)
    if valid is not None:
        gamma = jnp.where(valid, gamma, 0.0)
    d_log_obs = gb * gamma

    d_log_pi = jnp.sum(
        g[:, None] * jnp.exp(log_pi[None] + log_bstart[:, 0] - log_z[:, None]),
        axis=0,
    )

    # Expected transitions i→j: a segment of i ends at t, one of j
    # starts at t+1 (t+1 must be a valid frame).
    lxi = (
        log_alpha[:, :-1, :, None]
        + la[None, None]
        + log_bstart[:, 1:, None, :]
        - lz[..., None]
    )
    if lengths is not None:
        tmask = (
            jnp.arange(1, T)[None, :] < lengths[:, None]
        )[..., None, None]
        lxi = jnp.where(tmask, lxi, -jnp.inf)
    d_log_a = jnp.sum(gb[..., None] * jnp.exp(lxi), axis=(0, 1))

    # Expected segments of state s with duration d: start u, end
    # u+d-1 <= final valid frame. E(s, u..u+d-1) = C(u+d-1) - C(u-1).
    # Per-duration shifts are uniform, so each d is a pair of STATIC
    # slices (gathers with (B,T,S,D) index tensors cost more than D fused
    # elementwise passes).
    C = jnp.cumsum(log_obs, axis=1)                             # (B, T, S)
    c_before = jnp.concatenate(
        [jnp.zeros_like(C[:, :1]), C[:, :-1]], axis=1
    )                                                     # C(u-1)
    t_fin_v = (
        jnp.full((B, 1, 1), T - 1)
        if lengths is None
        else (lengths - 1).astype(jnp.int32)[:, None, None]
    )
    u_iota = jnp.arange(T)[None, :, None]
    dur_cols = []
    for d in range(1, D + 1):
        n_u = T - d + 1
        if n_u <= 0:
            dur_cols.append(jnp.zeros((S,), log_obs.dtype))
            continue
        expo_d = (
            nu[:, :n_u]
            + ld[None, None, :, d - 1]
            + (C[:, d - 1:] - c_before[:, :n_u])
            + log_bstar[:, d - 1:]
            - lz
        )
        ok_d = (u_iota[:, :n_u] + (d - 1)) <= t_fin_v
        expo_d = jnp.where(ok_d, expo_d, -jnp.inf)
        dur_cols.append(jnp.sum(gb * jnp.exp(expo_d), axis=(0, 1)))
    d_log_dur = jnp.stack(dur_cols, axis=1)               # (S, D)

    return d_log_obs, d_log_a, d_log_pi, d_log_dur


@jax.custom_vjp
def _hsmm_lz(log_obs, log_a, log_pi, log_dur):
    _, lz = hsmm_forward(log_obs, log_a, log_pi, log_dur)
    return lz


def _hsmm_lz_fwd(log_obs, log_a, log_pi, log_dur):
    log_alpha, lz = hsmm_forward(log_obs, log_a, log_pi, log_dur)
    return lz, (log_obs, log_a, log_pi, log_dur, log_alpha, lz)


def _hsmm_lz_bwd(res, g):
    log_obs, log_a, log_pi, log_dur, log_alpha, lz = res
    return _hsmm_grads(
        log_obs, log_a, log_pi, log_dur, log_alpha, lz, None, g
    )


_hsmm_lz.defvjp(_hsmm_lz_fwd, _hsmm_lz_bwd)


@jax.custom_vjp
def _hsmm_lz_masked(log_obs, log_a, log_pi, log_dur, lengths):
    _, lz = hsmm_forward(log_obs, log_a, log_pi, log_dur, lengths)
    return lz


def _hsmm_lzm_fwd(log_obs, log_a, log_pi, log_dur, lengths):
    log_alpha, lz = hsmm_forward(log_obs, log_a, log_pi, log_dur, lengths)
    return lz, (log_obs, log_a, log_pi, log_dur, lengths, log_alpha, lz)


def _hsmm_lzm_bwd(res, g):
    log_obs, log_a, log_pi, log_dur, lengths, log_alpha, lz = res
    grads = _hsmm_grads(
        log_obs, log_a, log_pi, log_dur, log_alpha, lz, lengths, g
    )
    d_lengths = np.zeros(lengths.shape, dtype=jax.dtypes.float0)
    return (*grads, d_lengths)


_hsmm_lz_masked.defvjp(_hsmm_lzm_fwd, _hsmm_lzm_bwd)


def hsmm_log_z(log_obs, log_a, log_pi, log_dur, lengths=None):
    """Sequence log-likelihood ``(B,)`` over all segmentations,
    differentiable via closed-form posterior-expectation cotangents
    (one backward scan + table algebra) instead of autodiff through the
    forward scan. Same values and gradients (≤2e-5 off autodiff on CPU),
    but the residuals are the (B, T, S) alpha table (~1 MB at the benchmark
    shape) instead of the scan's per-step intermediates (~100× larger),
    so batch·length can scale well past the autodiff memory cliff.
    Gradients double as HSMM E-step statistics (``d/d log_dur`` =
    expected duration counts, etc.)."""
    if lengths is None:
        return _hsmm_lz(log_obs, log_a, log_pi, log_dur)
    return _hsmm_lz_masked(log_obs, log_a, log_pi, log_dur, lengths)


@partial(jax.jit, static_argnames=())
def hsmm_backward(
    log_obs: jax.Array,
    log_a: jax.Array,
    log_dur: jax.Array,
    lengths: jax.Array | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """HSMM backward pass.

    Returns ``(log_beta_star, log_beta_start)``, both ``(B, T, S)``:

    * ``log_beta_star[t, s]`` — log-prob of the observations after ``t``
      given a segment of state ``s`` *ends* exactly at ``t``
      (``beta_star[T-1] = 0``); recursion
      ``beta_star(t) = lse_{s'}(log_a[s, s'] + beta_start(t+1, s'))``.
    * ``log_beta_start[t, s]`` — log-prob of observations from ``t`` on
      given a segment of state ``s`` *starts* at ``t``:
      ``lse_d(log_dur[s, d] + E(s, t..t+d-1) + beta_star(t+d-1, s))``
      over durations that end by ``T-1``.

    Mirrors :func:`hsmm_forward`'s structure in reverse: suffix emission
    sums turn segment scores into single adds via the carried quantity
    ``w(e, s) = beta_star(e, s) − C(e+1, s)`` (C = suffix cumsum), held
    in a (D, S) ring buffer. Consistency: ``lse_s(log_pi + beta_start[0])
    == log Z``.

    With ``lengths`` (B,), rows are ragged: the boundary condition
    ``beta_star = 0`` moves to each row's final valid frame and segments
    must end by it. Entries at ``t >= lengths[b]`` are unspecified;
    in-range entries are exact — padded frames only ever enter through
    telescoping suffix-sum differences ``C(t) - C(e+1)`` over in-range
    frames, so their contributions cancel identically.

    A capability the reference lacks entirely — its HSMMs can only be
    Viterbi-decoded (``hsmm.py:208-354``), never given posteriors.
    """
    B, T, S = log_obs.shape
    D = log_dur.shape[-1]
    dt = log_obs.dtype

    log_a = jnp.maximum(log_a, _NEG)
    log_dur_t = jnp.maximum(log_dur.T, _NEG)  # (D, S)
    j_idx = jnp.arange(D)[None, :, None]
    t_fin = (
        jnp.full((B,), T - 1) if lengths is None
        else (lengths - 1).astype(jnp.int32)
    )
    if lengths is not None:
        # Padded frames only ever enter through telescoping suffix-sum
        # differences — mathematically they cancel, but not bitwise.
        # Zero them so in-range results are bit-independent of padding
        # (EM statistics divide by near-zero occupancies and amplify
        # any float-level pad dependence).
        log_obs = jnp.where(
            jnp.arange(T)[None, :, None] < lengths[:, None, None],
            log_obs, 0.0,
        )

    w0 = jnp.full((B, D, S), _NEG, dt)
    bstart0 = jnp.full((B, S), _NEG, dt)
    c0 = jnp.zeros((B, S), dt)  # C(T) = 0

    def step(carry, xs):
        w_buf, bstart_next, c_next = carry
        lo_t, t = xs
        c_t = c_next + lo_t  # suffix sum C(t)

        bs_from_next = logsumexp(
            log_a[None] + bstart_next[:, None, :], axis=2
        )
        beta_star_t = jnp.where(
            (t == t_fin)[:, None], jnp.zeros((B, S), dt), bs_from_next
        )

        w_t = beta_star_t - c_next  # w(t) = beta_star(t) - C(t+1)
        w_buf = jnp.concatenate([w_t[:, None], w_buf[:, :-1]], axis=1)

        # beta_start(t, s) = C(t) + lse_d(dur[s, d] + w(t+d-1)); the
        # segment must end by the final valid frame:
        # d <= t_fin + 1 - t  ⇔  j = d-1 <= t_fin - t.
        scores = _masked(
            log_dur_t[None] + w_buf, j_idx <= (t_fin[:, None, None] - t)
        )
        beta_start_t = c_t + logsumexp(scores, axis=1)

        return (w_buf, beta_start_t, c_t), (beta_star_t, beta_start_t)

    xs = (log_obs.swapaxes(0, 1), jnp.arange(T))
    _, (bstars, bstarts) = jax.lax.scan(
        step, (w0, bstart0, c0), xs, reverse=True, unroll=4
    )
    return bstars.swapaxes(0, 1), bstarts.swapaxes(0, 1)


@partial(jax.jit, static_argnames=())
def hsmm_posteriors(
    log_obs: jax.Array,
    log_a: jax.Array,
    log_pi: jax.Array,
    log_dur: jax.Array,
    lengths: jax.Array | None = None,
):
    """Exact HSMM posteriors.

    Returns a dict with:

    * ``gamma (B, T, S)`` — frame-level state occupancy
      ``P(state at frame t = s | O)`` (rows sum to 1);
    * ``segment_end (B, T, S)`` — ``P(a segment of s ends at t | O)``;
    * ``segment_start (B, T, S)`` — ``P(a segment of s starts at t | O)``;
    * ``log_z (B,)`` — sequence log-likelihood.

    Occupancy via the start/end telescoping identity:
    ``gamma(t) = Σ_{u<=t} start(u) − Σ_{u<=t-1} end(u)``.

    With ``lengths`` (B,), all three posterior arrays are zero at padded
    frames ``t >= lengths[b]`` and exact (per-sequence-identical) inside
    each row's valid prefix.
    """
    log_alpha, log_z = hsmm_forward(log_obs, log_a, log_pi, log_dur, lengths)
    log_bstar, log_bstart = hsmm_backward(log_obs, log_a, log_dur, lengths)
    return hsmm_posteriors_from_tables(
        log_a, log_pi, log_alpha, log_bstar, log_bstart, log_z, lengths
    )


def hsmm_posteriors_from_tables(
    log_a, log_pi, log_alpha, log_bstar, log_bstart, log_z, lengths=None
):
    """:func:`hsmm_posteriors`'s table algebra over precomputed
    alpha/beta tables (any backend can produce them)."""
    lz = log_z[:, None, None]
    seg_end = jnp.exp(log_alpha + log_bstar - lz)

    # Entry scores mu(t-1, s) = lse_{s'}(alpha*(t-1, s') + log_a[s', s]);
    # mu(-1, s) = log_pi[s].
    mu = _entry_scores(log_alpha, log_a, log_pi)
    seg_start = jnp.exp(mu + log_bstart - lz)

    if lengths is not None:
        valid = (
            jnp.arange(log_alpha.shape[1])[None, :, None]
            < lengths[:, None, None]
        )
        seg_end = jnp.where(valid, seg_end, 0.0)
        seg_start = jnp.where(valid, seg_start, 0.0)

    gamma = jnp.cumsum(seg_start, axis=1) - jnp.concatenate(
        [jnp.zeros_like(seg_end[:, :1]), jnp.cumsum(seg_end, axis=1)[:, :-1]],
        axis=1,
    )
    gamma = jnp.clip(gamma, 0.0, 1.0)
    # The telescoping cumsum accumulates f32 error over segments (up to
    # ~1e-2 row-sum drift on long, near-deterministic sequences);
    # renormalize so gamma is a proper per-frame distribution.
    gamma = gamma / jnp.maximum(
        jnp.sum(gamma, axis=-1, keepdims=True), 1e-30
    )
    if lengths is not None:
        gamma = jnp.where(valid, gamma, 0.0)
    return {
        "gamma": gamma,
        "segment_end": seg_end,
        "segment_start": seg_start,
        "log_z": log_z,
    }
