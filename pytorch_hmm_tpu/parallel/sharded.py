"""Time-block-parallel HMM recursions over a device mesh.

The forward, backward and Viterbi recursions have a length-T serial
dependency chain. The reference caps sequence length and tells users to
chunk by hand (``mixture_gaussian.py:169-172``, ``README.md:709-713``).
Here the time axis is *sharded*: with P time-blocks on P devices, each
device runs the classic O(T/P · K²) scan over its own block, and blocks
are glued together exactly with O(K²)-sized boundary exchanges — the
block-parallel scan decomposition (cf. Särkkä & García-Fernández,
arXiv:2102.05743, and the overlap-save carry the reference's streaming
processor uses on a single device, ``streaming.py:292-302``).

Three-phase structure (identical for all three recursions):

1. **Local block operator** (parallel): fold the per-frame semiring
   matrices ``M_t[i, j] = log_a[i, j] + log_obs[t, j]`` over the local
   block — O(T/P · K³), but these are batched (K, K) contractions that
   vectorize well; for the K ≲ 100 regime of speech HMMs this is cheap.
2. **Boundary exchange** (collective): ``all_gather`` the P block
   operators over the ``time`` axis (P·K² numbers per sequence) and
   redundantly prefix-fold them — every device learns the exact DP state
   vector at its block's entry.
3. **Local rescan** (parallel): the classic O(T/P · K²) vector scan from
   the exact entry state, producing exact per-frame alpha/beta/delta.

Results are bit-identical to the single-device scans in ``core`` as long
as the fold order matches (we fold left-to-right, like the sequential
scan, so only the block-operator path introduces reassociation — it
affects nothing because pass 3 recomputes every frame from exact entry
vectors computed from the same left-to-right fold order over blocks).

All functions here are meant to be called **inside** ``jax.shard_map``
(they use ``jax.lax`` collectives with an axis name), via the public
wrappers at the bottom that set up the shard_map for a ``(data, time)``
mesh. Ragged batches pass ``lengths=`` to the public wrappers: padded
frames become identity operators inside the kernel, so in-range results
match the per-sequence unpadded scans exactly.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core.semiring import (
    log_matmul,
    log_matvec,
    log_matvec_t,
    logsumexp,
    max_matmul,
)
from .mesh import DATA_AXIS, TIME_AXIS

__all__ = [
    "sharded_forward_backward",
    "sharded_log_likelihood",
    "sharded_scoring_log_likelihood",
    "sharded_viterbi",
]


def _axis_info(axis_name: str):
    idx = jax.lax.axis_index(axis_name)
    size = jax.lax.psum(1, axis_name)
    return idx, size


def _pvary(x: jax.Array, axis_names) -> jax.Array:
    """Mark a shard-invariant value as varying over the manual mesh axes
    (required for scan carries under shard_map's vma type system)."""
    return jax.lax.pvary(x, tuple(axis_names))


def _log_eye(k: int, dtype) -> jax.Array:
    """Semiring identity: 0 on the diagonal, -inf elsewhere."""
    return jnp.where(jnp.eye(k, dtype=bool), 0.0, -jnp.inf).astype(dtype)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _la_at(log_a, t_local):
    """Transition matrix governing the step into local frame ``t_local``:
    broadcastable ``(K, K)`` when static, the local time slice of a
    time-sharded ``(B, Tl, K, K)`` tensor when time-varying (the NeuralHMM
    regime, reference ``neural.py:403-431``)."""
    if log_a.ndim == 4:
        return log_a[:, t_local]  # (B, K, K)
    return log_a[None]  # (1, K, K), broadcasts over batch


def _forward_block(log_obs, log_a, log_pi, axis_name, vary=(), lengths=None):
    """Per-shard body: exact local log_alpha (B, Tl, K) + log_z (B,).

    ``log_obs`` is the local time block; frame indices are globalized via
    the shard's position on the time axis. ``log_a`` is ``(K, K)`` static
    or the LOCAL block ``(B, Tl, K, K)`` of time-varying transitions
    (``[:, t]`` governs the step into frame t, the core.fb convention).
    With ``lengths`` (B,), frames at/past each row's length contribute
    the semiring *identity* to the block operator — alpha freezes at the
    final valid frame, so the log_z read at the global last frame is
    exactly the ragged likelihood and padded-frame alphas repeat the
    final valid alpha.
    """
    B, Tl, K = log_obs.shape
    idx, p = _axis_info(axis_name)
    t0 = idx * Tl  # global index of the first local frame
    eye1 = _log_eye(K, log_obs.dtype)

    def pad_mask(t_local):
        if lengths is None:
            return None
        return (t0 + t_local >= lengths)[:, None, None]  # (B, 1, 1)

    # Pass 1: local block operator. Global frame 0 contributes the rank-1
    # matrix with rows equal to alpha_0 (same trick as core.fb's
    # associative path): row i of any later product is then alpha_t for
    # every i, making the entry vector a plain row slice.
    def op(t_local):
        lo_t = log_obs[:, t_local]  # (B, K)
        m = _la_at(log_a, t_local) + lo_t[:, None, :]  # (B, K, K)
        a0 = jnp.broadcast_to((log_pi + lo_t)[:, None, :], (B, K, K))
        m = jnp.where(t0 + t_local == 0, a0, m)
        pad = pad_mask(t_local)
        return m if pad is None else jnp.where(pad, eye1[None], m)

    def fold(carry, t_local):
        return log_matmul(carry, op(t_local)), None

    eye = _pvary(
        jnp.broadcast_to(_log_eye(K, log_obs.dtype), (B, K, K)), vary
    )
    block, _ = jax.lax.scan(fold, eye, jnp.arange(Tl))

    # Pass 2: gather block operators, fold prefixes redundantly.
    blocks = jax.lax.all_gather(block, axis_name)  # (P, B, K, K)

    def pfold(carry, b):
        nxt = log_matmul(carry, b)
        return nxt, carry  # emit the *exclusive* prefix

    _, prefixes = jax.lax.scan(pfold, eye, blocks)
    entry_mat = prefixes[idx]  # exclusive prefix: blocks 0..idx-1
    # For idx >= 1 the prefix contains the rank-1 frame-0 element, so every
    # row equals alpha at the previous block's last frame; row 0 suffices.
    entry = entry_mat[:, 0, :]  # (B, K); garbage for idx == 0 (unused)

    # Pass 3: exact local rescan.
    def step(carry, t_local):
        lo_t = log_obs[:, t_local]
        la_t = log_a[:, t_local] if log_a.ndim == 4 else log_a
        from_prev = lo_t + log_matvec(carry, la_t)
        first = log_pi + lo_t
        alpha_t = jnp.where(t0 + t_local == 0, first, from_prev)
        if lengths is not None:
            alpha_t = jnp.where(
                (t0 + t_local >= lengths)[:, None], carry, alpha_t
            )
        return alpha_t, alpha_t

    _, alphas = jax.lax.scan(step, entry, jnp.arange(Tl))
    log_alpha = alphas.swapaxes(0, 1)  # (B, Tl, K)

    # Sequence likelihood lives on the last shard (alpha at the global
    # final frame); psum broadcasts it — formally replicated over the time
    # axis for the vma type system, and differentiable.
    lz_local = logsumexp(log_alpha[:, -1], axis=-1)
    log_z = jax.lax.psum(
        jnp.where(idx == p - 1, lz_local, jnp.zeros_like(lz_local)),
        axis_name,
    )
    return log_alpha, log_z


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

def _backward_block(log_obs, log_a, axis_name, vary=(), lengths=None):
    """Per-shard body: exact local log_beta (B, Tl, K).

    Carries the message ``v_t = log_obs_t + beta_t`` so each block only
    needs its own observations: ``v_t = Ã_t ⊗ v_{t+1}`` with
    ``Ã_t[i, j] = log_obs_t[i] + log_a[i, j]`` and ``v_{T-1} = log_obs_{T-1}``.

    Time-varying transitions: the recursion at frame t applies the
    transition INTO frame t+1, so ``log_a`` here must be the local block
    of the pre-SHIFTED tensor (``la_next[:, t] = global A_{t+1}``) —
    built once outside the shard_map (one boundary-halo collective under
    XLA's sharding propagation) so frame ``Tl-1`` never reaches into the
    neighbouring shard from inside the kernel.

    With ``lengths`` (B,), each row's boundary condition ``beta = 0``
    moves to its final valid frame (which gets the rank-1 operator);
    later frames are semiring identities and emit ``beta = 0``.
    """
    B, Tl, K = log_obs.shape
    idx, p = _axis_info(axis_name)
    t0 = idx * Tl
    T = p * Tl
    eye1 = _log_eye(K, log_obs.dtype)
    t_fin = T - 1 if lengths is None else lengths - 1  # scalar or (B,)

    def op(t_local):
        lo_t = log_obs[:, t_local]
        m = lo_t[:, :, None] + _la_at(log_a, t_local)  # (B, K, K)
        # Final valid frame: rank-1 with columns v = log_obs at it.
        last = jnp.broadcast_to(lo_t[:, :, None], (B, K, K))
        t_g = t0 + t_local
        if lengths is None:
            return jnp.where(t_g == t_fin, last, m)
        m = jnp.where((t_g == t_fin)[:, None, None], last, m)
        return jnp.where((t_g > t_fin)[:, None, None], eye1[None], m)

    def fold(carry, t_local):
        # Right-to-left composition: block = Ã_first ⊗ ... ⊗ Ã_last.
        return log_matmul(op(t_local), carry), None

    eye = _pvary(
        jnp.broadcast_to(_log_eye(K, log_obs.dtype), (B, K, K)), vary
    )
    block, _ = jax.lax.scan(fold, eye, jnp.arange(Tl), reverse=True)

    blocks = jax.lax.all_gather(block, axis_name)  # (P, B, K, K)

    def sfold(carry, b):
        nxt = log_matmul(b, carry)
        return nxt, carry  # emit the *exclusive* suffix (blocks idx+1..P-1)

    _, suffixes = jax.lax.scan(sfold, eye, blocks, reverse=True)
    exit_mat = suffixes[idx]
    # Suffix products contain the rank-1 final element, so every column
    # equals v at the next block's first frame.
    exit_v = exit_mat[:, :, 0]  # (B, K); garbage for idx == P-1 (unused)

    def step(carry, t_local):
        lo_t = log_obs[:, t_local]
        la_t = log_a[:, t_local] if log_a.ndim == 4 else log_a
        at_end = (
            t0 + t_local == T - 1 if lengths is None
            else (t0 + t_local >= t_fin)[:, None]
        )
        beta_t = jnp.where(
            at_end,
            jnp.zeros((B, K), log_obs.dtype),
            log_matvec_t(la_t, carry),
        )
        return lo_t + beta_t, beta_t

    _, betas = jax.lax.scan(step, exit_v, jnp.arange(Tl), reverse=True)
    return betas.swapaxes(0, 1)


# ---------------------------------------------------------------------------
# Viterbi
# ---------------------------------------------------------------------------

def _viterbi_block(log_obs, log_a, log_pi, axis_name, vary=(), lengths=None):
    """Per-shard body: exact local Viterbi path (B, Tl) + score (B,).

    Same three phases in the (max, +) semiring, plus a fourth *stitch*
    phase for the backtrace: each block backtraces a (K,) family of local
    paths (one per hypothetical exit state), exposes the induced
    exit→entry-predecessor map, and the P maps are composed redundantly on
    every shard to pick each block's true exit state.

    With ``lengths`` (B,), padded frames contribute tropical identities
    (delta freezes, backpointers are the identity map), so the decoded
    path repeats each row's final valid state — the same convention as
    ``core.viterbi``.
    """
    B, Tl, K = log_obs.shape
    idx, p = _axis_info(axis_name)
    t0 = idx * Tl
    eye1 = _log_eye(K, log_obs.dtype)

    max_matmul_b = max_matmul  # shared (max, +) contraction from semiring

    def op(t_local):
        lo_t = log_obs[:, t_local]
        m = _la_at(log_a, t_local) + lo_t[:, None, :]
        d0 = jnp.broadcast_to((log_pi + lo_t)[:, None, :], (B, K, K))
        m = jnp.where(t0 + t_local == 0, d0, m)
        if lengths is None:
            return m
        return jnp.where(
            (t0 + t_local >= lengths)[:, None, None], eye1[None], m
        )

    def fold(carry, t_local):
        return max_matmul_b(carry, op(t_local)), None

    eye = _pvary(
        jnp.broadcast_to(_log_eye(K, log_obs.dtype), (B, K, K)), vary
    )
    block, _ = jax.lax.scan(fold, eye, jnp.arange(Tl))

    blocks = jax.lax.all_gather(block, axis_name)

    def pfold(carry, b):
        return max_matmul_b(carry, b), carry

    _, prefixes = jax.lax.scan(pfold, eye, blocks)
    entry = prefixes[idx][:, 0, :]  # delta at previous block's last frame

    # Pass 3: exact local trellis with backpointers. psi at local frame 0
    # points into the previous block's last frame (valid: entry is exact).
    def step(carry, t_local):
        lo_t = log_obs[:, t_local]
        scores = carry[:, :, None] + _la_at(log_a, t_local)  # (B, K, K)
        best = jnp.max(scores, axis=-2) + lo_t
        psi = jnp.argmax(scores, axis=-2).astype(jnp.int32)
        first = log_pi + lo_t
        is0 = t0 + t_local == 0
        delta_t = jnp.where(is0, first, best)
        psi_t = jnp.where(is0, jnp.zeros_like(psi), psi)
        if lengths is not None:
            pad = (t0 + t_local >= lengths)[:, None]
            delta_t = jnp.where(pad, carry, delta_t)
            # Identity backpointers: each state is its own predecessor,
            # so the backtrace repeats the final valid state.
            psi_t = jnp.where(
                pad, jnp.arange(K, dtype=jnp.int32)[None, :], psi_t
            )
        return delta_t, (delta_t, psi_t)

    delta_last, (_, psis) = jax.lax.scan(step, entry, jnp.arange(Tl))
    # psis: (Tl, B, K)

    # Pass 4a: local backtrace for every hypothetical exit state.
    all_states = _pvary(
        jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[None, :], (B, K)),
        vary,
    )

    def back(carry, psi_t):
        # carry: (B, K) current state per exit hypothesis
        prev = jnp.take_along_axis(psi_t, carry, axis=1)
        return prev, carry

    # Walk backpointers from the last local frame down to frame 0; emit the
    # state at each local frame, then the final carry is the predecessor in
    # the previous block (psi_0 applied).
    link, states_rev = jax.lax.scan(back, all_states, psis, reverse=True)
    # states_rev: (Tl, B, K) state at each local frame per exit hypothesis
    # link: (B, K) previous block's exit state per our exit hypothesis

    # Pass 4b: stitch — compose the per-block maps right-to-left. The true
    # final delta lives on the last shard; psum-broadcast its argmax/max.
    links = jax.lax.all_gather(link, axis_name)  # (P, B, K)
    is_last = idx == p - 1
    fs_local = jnp.argmax(delta_last, axis=-1).astype(jnp.int32)
    final_state = jax.lax.psum(
        jnp.where(is_last, fs_local, jnp.zeros_like(fs_local)), axis_name
    )
    score = jax.lax.psum(
        jnp.where(is_last, jnp.max(delta_last, axis=-1), 0.0), axis_name
    )

    def stitch(carry, lnk):
        # carry: exit state of the block to our right (i.e. this block's
        # successor chain); emits this block's exit state.
        prev_exit = jnp.take_along_axis(lnk, carry[:, None], axis=1)[:, 0]
        return prev_exit, carry

    _, exits = jax.lax.scan(
        stitch, _pvary(final_state, (axis_name,)), links, reverse=True
    )
    my_exit = exits[idx]  # (B,)

    path = jnp.take_along_axis(
        states_rev.transpose(1, 0, 2), my_exit[:, None, None].repeat(Tl, 1),
        axis=2,
    )[:, :, 0]  # (B, Tl)
    return path, score


# ---------------------------------------------------------------------------
# Public wrappers (set up shard_map over a (data, time) mesh)
# ---------------------------------------------------------------------------

def _specs(mesh: Mesh):
    has_data = DATA_AXIS in mesh.axis_names
    d = DATA_AXIS if has_data else None
    obs_spec = P(d, TIME_AXIS, None)
    return obs_spec, P(d, TIME_AXIS), P(d)


def _la_spec(mesh: Mesh, log_a: jax.Array):
    """Sharding spec for static ``(K, K)`` vs time-varying
    ``(B, T, K, K)`` transitions (batch over data, time over time)."""
    if log_a.ndim == 4:
        d = DATA_AXIS if DATA_AXIS in mesh.axis_names else None
        return P(d, TIME_AXIS, None, None)
    return P(None, None)


def _la_shifted(log_a: jax.Array) -> jax.Array:
    """``la_next[:, t] = log_a[:, t+1]`` for the backward recursion
    (frame t applies the transition INTO frame t+1). Built OUTSIDE the
    shard_map so the one-frame halo ride-along is XLA's problem (a
    collective-permute under time sharding), not the kernel's. The final
    slice is a don't-care (the last valid frame gets the rank-1
    boundary operator; later frames are identities)."""
    if log_a.ndim != 4:
        return log_a
    return jnp.concatenate([log_a[:, 1:], log_a[:, -1:]], axis=1)


@partial(jax.jit, static_argnames=("mesh",))
def sharded_forward_backward(
    log_obs: jax.Array,
    log_a: jax.Array,
    log_pi: jax.Array,
    mesh: Mesh,
    lengths: jax.Array | None = None,
):
    """Exact forward-backward with batch sharded over ``data`` and time
    sharded over ``time``. Returns ``(log_gamma, log_alpha, log_beta,
    log_z)`` like ``core.forward_backward``. ``log_a`` is ``(K, K)``
    static or ``(B, T, K, K)`` time-varying (the NeuralHMM regime —
    ``[:, t]`` governs the step into frame t), sharded like the
    observations. With ``lengths`` (B,), ragged rows are handled exactly
    inside the kernel (identity-operator padding) — in-range entries
    match per-sequence unpadded results.
    """
    obs_spec, _, b_spec = _specs(mesh)
    la_spec = _la_spec(mesh, log_a)

    def body(lo, la, la_nx, lp, lens):
        axis = TIME_AXIS
        vary = mesh.axis_names
        log_alpha, log_z = _forward_block(lo, la, lp, axis, vary, lens)
        log_beta = _backward_block(lo, la_nx, axis, vary, lens)
        lg = log_alpha + log_beta
        log_gamma = lg - logsumexp(lg, axis=-1, keepdims=True)
        return log_gamma, log_alpha, log_beta, log_z

    lengths = _full_lengths(log_obs, lengths)
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(obs_spec, la_spec, la_spec, P(None), b_spec),
        out_specs=(obs_spec, obs_spec, obs_spec, b_spec),
    )(log_obs, log_a, _la_shifted(log_a), log_pi, lengths)


@partial(jax.jit, static_argnames=("mesh",))
def sharded_log_likelihood(
    log_obs: jax.Array,
    log_a: jax.Array,
    log_pi: jax.Array,
    mesh: Mesh,
    lengths: jax.Array | None = None,
) -> jax.Array:
    """Sequence log-likelihood ``(B,)`` on a sharded mesh (differentiable —
    use inside sharded training losses). ``log_a`` static ``(K, K)`` or
    time-varying ``(B, T, K, K)``; ``lengths`` (B,) scores ragged rows
    exactly."""
    obs_spec, _, b_spec = _specs(mesh)

    def body(lo, la, lp, lens):
        _, log_z = _forward_block(
            lo, la, lp, TIME_AXIS, mesh.axis_names, lens
        )
        return log_z

    lengths = _full_lengths(log_obs, lengths)
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(obs_spec, _la_spec(mesh, log_a), P(None), b_spec),
        out_specs=b_spec,
    )(log_obs, log_a, log_pi, lengths)


@partial(jax.jit, static_argnames=("mesh",))
def sharded_viterbi(
    log_obs: jax.Array,
    log_a: jax.Array,
    log_pi: jax.Array,
    mesh: Mesh,
    lengths: jax.Array | None = None,
):
    """Exact Viterbi path ``(B, T)`` + score ``(B,)`` on a sharded mesh.
    ``log_a`` static ``(K, K)`` or time-varying ``(B, T, K, K)``. With
    ``lengths`` (B,), padded frames repeat each row's final valid state
    (``core.viterbi`` convention)."""
    obs_spec, t_spec, b_spec = _specs(mesh)

    def body(lo, la, lp, lens):
        return _viterbi_block(
            lo, la, lp, TIME_AXIS, mesh.axis_names, lens
        )

    lengths = _full_lengths(log_obs, lengths)
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(obs_spec, _la_spec(mesh, log_a), P(None), b_spec),
        out_specs=(t_spec, b_spec),
    )(log_obs, log_a, log_pi, lengths)


def _full_lengths(log_obs, lengths):
    """Materialize ``lengths`` (full length when not given) so the
    shard_map signature is uniform."""
    if lengths is None:
        return jnp.full((log_obs.shape[0],), log_obs.shape[1], jnp.int32)
    return lengths.astype(jnp.int32)


@partial(jax.jit, static_argnames=("mesh",))
def sharded_scoring_log_likelihood(
    log_obs: jax.Array,
    log_a: jax.Array,
    log_pi: jax.Array,
    mesh: Mesh,
) -> jax.Array:
    """Batch-data-parallel likelihood scoring ``(B,)``: each device runs
    ``ops.auto_log_likelihood`` on its batch shard, with the whole time
    axis, and no communication (likelihoods are independent per
    sequence). For long sequences or few sequences per device use
    :func:`sharded_log_likelihood`, which also shards time.
    """
    from ..ops import auto_log_likelihood

    has_data = DATA_AXIS in mesh.axis_names
    d = DATA_AXIS if has_data else None

    return jax.shard_map(
        auto_log_likelihood,
        mesh=mesh,
        in_specs=(P(d, None, None), P(None, None), P(None)),
        out_specs=P(d),
        # A pallas_call inside does not annotate vma on its out shapes;
        # the mapping is trivially batch-parallel.
        check_vma=False,
    )(log_obs, log_a, log_pi)
