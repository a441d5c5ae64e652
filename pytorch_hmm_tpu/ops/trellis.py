"""HMM trellis kernels for the GPU, written in Pallas through Triton.

The forward, backward and Viterbi recursions are chains of tiny dependent
steps: at the flagship decode (B=32, T=1000, K=12) each frame is one
``(B, 12) x (12, 12)`` max-plus or log-sum-exp product. Compiled by XLA as
a ``lax.scan``, every frame costs kernel launches and a loop trip. These
kernels keep the whole time loop inside one program instead:

* one program per sequence, so a batch of 32 spreads over 32 streaming
  multiprocessors (more sequences per program measured slower on the
  card, see PERF.md);
* the carry and the ``(Kp, Kp)`` transition tile live in registers for the
  whole sequence; the next frame's emissions are loaded one step ahead so
  the load overlaps the current step;
* the arithmetic is float32 broadcast-and-reduce exactly as in ``core``
  (no dot, so no TF32 enters), so the Viterbi paths and scores are
  bit-identical to ``core.viterbi``, tie-breaks (lowest index) included;
* ragged ``lengths`` freeze each row's carry past its end, as ``core`` does.

``Kp`` (states padded with ``-inf``) is a power of two, as Triton
requires. The forward and backward recursions share one kernel body
with a direction taken from the grid: asked for both, they run as two grid
rows, on different multiprocessors at the same time.

Every entry point takes ``interpret``. It defaults to False, and then the
kernel compiles only for the GPU; tests pass True to run the same kernel in
the Pallas interpreter on the CPU.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = [
    "trellis_viterbi",
    "trellis_forward_backward",
    "padded_states",
]

_NEG_INF = float("-inf")
# Smallest padded state count: keeps every tile a comfortable Triton
# tensor; the padding states cost nothing measurable at this size.
_MIN_KP = 16


def padded_states(num_states: int) -> int:
    """State count the kernels pad to: the next power of two, at least 16."""
    return max(_MIN_KP, 1 << (num_states - 1).bit_length())


def _compiler_params(kp: int, elems_per_warp: int):
    """One warp per ``elems_per_warp`` elements of the (Kp, Kp) step tile,
    1..8. Measured on the card: the max-plus step is latency-bound
    and wants few warps (2048 elements each), the log-sum-exp step's
    exponentials want more (256 each)."""
    warps = min(8, max(1, kp * kp // elems_per_warp))
    return plgpu.CompilerParams(num_warps=warps, num_stages=1)


def _require_gpu(interpret: bool) -> None:
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the trellis kernels compile only for the GPU (backend is "
            f"{jax.default_backend()!r}); pass interpret=True to run them "
            "in the Pallas interpreter"
        )


def _prepare(log_obs, log_a, lengths):
    """Pad states to Kp with -inf; lengths default to T."""
    B, T, K = log_obs.shape
    kp = padded_states(K)
    lo = jnp.pad(
        log_obs.astype(jnp.float32), ((0, 0), (0, 0), (0, kp - K)),
        constant_values=_NEG_INF,
    )
    la = jnp.pad(
        log_a.astype(jnp.float32), ((0, kp - K), (0, kp - K)),
        constant_values=_NEG_INF,
    )
    if lengths is None:
        lens = jnp.full((B,), T, jnp.int32)
    else:
        lens = lengths.astype(jnp.int32)
    return lo, la, lens, kp


# ---------------------------------------------------------------------------
# Viterbi: max-plus forward with backpointers, then a backtrace kernel.
# ---------------------------------------------------------------------------

def _viterbi_fwd_kernel(lo_ref, a_ref, d0_ref, len_ref, psi_ref, delta_ref):
    bt, T, kp = lo_ref.shape
    a = a_ref[...]
    lens = len_ref[...]
    iota = jax.lax.broadcasted_iota(jnp.int32, (bt, kp), 1)
    psi_ref[:, 0, :] = iota  # frame 0 has no predecessor

    def step(t, carry):
        delta, lo_t = carry
        lo_next = lo_ref[:, jnp.minimum(t + 1, T - 1), :]
        scores = delta[:, :, None] + a[None]
        best = jnp.max(scores, axis=1) + lo_t
        psi = jnp.argmax(scores, axis=1).astype(jnp.int32)
        keep = (t < lens)[:, None]
        # Past a row's end the carry is frozen and the pointers are the
        # identity, so the backtrace repeats the final valid state.
        psi_ref[:, t, :] = jnp.where(keep, psi, iota)
        return jnp.where(keep, best, delta), lo_next

    lo_1 = lo_ref[:, min(1, T - 1), :]
    delta, _ = jax.lax.fori_loop(1, T, step, (d0_ref[...], lo_1))
    delta_ref[...] = delta


def _backtrace_kernel(psi_ref, last_ref, states_ref):
    bt, T, kp = psi_ref.shape
    iota = jax.lax.broadcasted_iota(jnp.int32, (bt, kp), 1)

    def step(i, carry):
        s, row = carry  # state at frame t and the pointers into frame t
        t = T - 1 - i
        row_next = psi_ref[:, jnp.maximum(t - 1, 0), :]
        states_ref[:, t] = s
        prev = jnp.sum(jnp.where(iota == s[:, None], row, 0), axis=1)
        return prev, row_next

    s, _ = jax.lax.fori_loop(
        0, T - 1, step, (last_ref[...], psi_ref[:, T - 1, :])
    )
    states_ref[:, 0] = s


@functools.partial(jax.jit, static_argnames=("interpret",))
def trellis_viterbi(
    log_obs: jax.Array,
    log_a: jax.Array,
    log_pi: jax.Array,
    lengths: Optional[jax.Array] = None,
    *,
    interpret: bool = False,
):
    """Most-likely state path ``(states (B, T) int32, score (B,))``.

    Same contract as ``core.viterbi`` with static ``(K, K)`` ``log_a``;
    paths and scores are identical to it, tie-breaks included.
    """
    _require_gpu(interpret)
    B, T, K = log_obs.shape
    lo, la, lens, kp = _prepare(log_obs, log_a, lengths)
    d0 = log_pi + log_obs[:, 0]
    d0 = jnp.pad(
        jnp.broadcast_to(d0, (B, K)).astype(jnp.float32),
        ((0, 0), (0, kp - K)), constant_values=_NEG_INF,
    )
    params = _compiler_params(kp, 2048)
    psi, delta = pl.pallas_call(
        _viterbi_fwd_kernel,
        grid=(B,),
        in_specs=[
            pl.BlockSpec((1, T, kp), lambda i: (i, 0, 0)),
            pl.BlockSpec((kp, kp), lambda i: (0, 0)),
            pl.BlockSpec((1, kp), lambda i: (i, 0)),
            pl.BlockSpec((1,), lambda i: (i,)),
        ],
        out_specs=[
            pl.BlockSpec((1, T, kp), lambda i: (i, 0, 0)),
            pl.BlockSpec((1, kp), lambda i: (i, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((B, T, kp), jnp.int32),
            jax.ShapeDtypeStruct((B, kp), jnp.float32),
        ],
        backend="triton",
        compiler_params=params,
        interpret=interpret,
        name="trellis_viterbi",
    )(lo, la, d0, lens)
    last = jnp.argmax(delta, axis=-1).astype(jnp.int32)
    score = jnp.max(delta, axis=-1)
    states = pl.pallas_call(
        _backtrace_kernel,
        grid=(B,),
        in_specs=[
            pl.BlockSpec((1, T, kp), lambda i: (i, 0, 0)),
            pl.BlockSpec((1,), lambda i: (i,)),
        ],
        out_specs=pl.BlockSpec((1, T), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((B, T), jnp.int32),
        backend="triton",
        compiler_params=params,
        interpret=interpret,
        name="trellis_backtrace",
    )(psi, last)
    return states, score


# ---------------------------------------------------------------------------
# Forward / backward: one log-sum-exp body, direction from the grid.
# ---------------------------------------------------------------------------

def _fb_kernel(lo_ref, m_ref, c0_ref, len_ref, out_ref):
    """Grid row 0 runs the forward recursion, row 1 the backward.

    With ``M`` = ``log_a`` (forward) or its transpose (backward), both are
    ``c'[j] = lse_i(M[i, j] + c[i] + pre[i]) + post[j]``: the forward adds
    the frame's emissions after the reduction (``alpha``), the backward
    before it (``beta``, which reads the next frame).
    """
    _, T, kp = lo_ref.shape
    bwd = pl.program_id(1) == 1
    d = bwd.astype(jnp.int32)  # index arithmetic stays int32 for Triton
    m = m_ref[0]
    lens = len_ref[...] - d  # beta is 0 from len-1 on
    out_ref[0, :, d * (T - 1), :] = c0_ref[0]

    def frame(s):  # emissions frame read at step s: s+1, or T-1-s
        f = s + 1 + d * (T - 2 - 2 * s)
        return jnp.minimum(jnp.maximum(f, 0), T - 1)  # clamp the prefetch

    def step(s, carry):
        c, x = carry
        t = s + 1 + d * (T - 3 - 2 * s)  # frame written: s+1, or T-2-s
        x_next = lo_ref[:, frame(s + 1), :]
        v = c + jnp.where(bwd, x, 0.0)
        scores = v[:, :, None] + m[None]
        mx = jnp.max(scores, axis=1)
        mx = jnp.where(mx == _NEG_INF, 0.0, mx)  # all -inf: lse is -inf
        new = jnp.log(jnp.sum(jnp.exp(scores - mx[:, None, :]), axis=1)) + mx
        new = new + jnp.where(bwd, 0.0, x)
        new = jnp.where((t < lens)[:, None], new, c)
        out_ref[0, :, t, :] = new
        return new, x_next

    jax.lax.fori_loop(
        0, T - 1, step, (c0_ref[0], lo_ref[:, frame(jnp.int32(0)), :])
    )


@functools.partial(jax.jit, static_argnames=("backward", "interpret"))
def trellis_forward_backward(
    log_obs: jax.Array,
    log_a: jax.Array,
    log_pi: jax.Array,
    lengths: Optional[jax.Array] = None,
    *,
    backward: bool = True,
    interpret: bool = False,
):
    """``(log_alpha, log_beta | None, log_z)`` for static ``(K, K)`` ``log_a``.

    The recursions and their ``lengths`` semantics are those of
    ``core.forward_log`` and ``core.backward_log``; values agree to float32
    reduction order. With ``backward=False`` only the forward grid row runs.
    """
    _require_gpu(interpret)
    B, T, K = log_obs.shape
    lo, la, lens, kp = _prepare(log_obs, log_a, lengths)
    n_dir = 2 if backward else 1
    a0 = jnp.broadcast_to(log_pi + log_obs[:, 0], (B, K)).astype(jnp.float32)
    a0 = jnp.pad(a0, ((0, 0), (0, kp - K)), constant_values=_NEG_INF)
    c0 = jnp.stack([a0, jnp.zeros_like(a0)])[:n_dir]
    m = jnp.stack([la, la.T])[:n_dir]
    out = pl.pallas_call(
        _fb_kernel,
        grid=(B, n_dir),
        in_specs=[
            pl.BlockSpec((1, T, kp), lambda i, d: (i, 0, 0)),
            pl.BlockSpec((1, kp, kp), lambda i, d: (d, 0, 0)),
            pl.BlockSpec((1, 1, kp), lambda i, d: (d, i, 0)),
            pl.BlockSpec((1,), lambda i, d: (i,)),
        ],
        out_specs=pl.BlockSpec((1, 1, T, kp), lambda i, d: (d, i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n_dir, B, T, kp), jnp.float32),
        backend="triton",
        compiler_params=_compiler_params(kp, 256),
        interpret=interpret,
        name="trellis_forward_backward",
    )(lo, m, c0, lens)
    log_alpha = out[0, :, :, :K]
    log_beta = out[1, :, :, :K] if backward else None
    if lengths is None:
        last = log_alpha[:, -1]
    else:
        last = jnp.take_along_axis(
            log_alpha, (lengths - 1).astype(jnp.int32)[:, None, None], axis=1
        )[:, 0]
    log_z = jax.scipy.special.logsumexp(last, axis=-1)
    return log_alpha, log_beta, log_z
