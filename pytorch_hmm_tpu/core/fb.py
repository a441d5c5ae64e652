"""Log-domain forward-backward algorithm as JAX scans.

Replaces the reference's sequential Python loops (pytorch_hmm
``hmm.py:66-130``: ``for t in range(1, T)`` forward, ``for t in range(T-2,
-1, -1)`` backward) with two formulations:

* ``method='scan'`` — a ``lax.scan`` over time. Exactly the sequential
  recursion, O(T·K²) work, compiled to a single fused loop by XLA. This is
  the numerics ground truth.
* ``method='associative'`` — temporal parallelization via
  ``lax.associative_scan`` in the (logsumexp, +) matrix semiring
  (Särkkä & García-Fernández, arXiv:2102.05743). O(T·K³) work but
  O(log T) depth: the T axis becomes a batched ``(K, K)`` contraction
  instead of a length-T dependency chain. For small K and long T.

All functions operate on **log-space** quantities with batch dimension:
``log_obs`` is ``(B, T, K)`` per-state observation log-likelihoods,
``log_a`` is a row-stochastic log transition matrix — either static
``(K, K)`` or time-varying ``(B, T, K, K)`` (the NeuralHMM case,
reference ``neural.py:403-431``; entry ``[:, t]`` governs the transition
from ``t-1`` into ``t``, entry ``[:, 0]`` is ignored) — and ``log_pi`` is
``(K,)`` or ``(B, K)`` initial log-probabilities.

Optional ``lengths`` (shape ``(B,)``) supports padded batches: frames at
``t >= lengths[b]`` contribute nothing to likelihoods and have garbage
posteriors (mask them downstream). The reference has no padding support.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from .semiring import (
    SCAN_UNROLL, log_matmul, log_matvec, log_matvec_t, logsumexp,
)

__all__ = [
    "forward_log",
    "backward_log",
    "forward_backward",
    "log_likelihood",
]


def _time_varying(log_a: jax.Array) -> bool:
    return log_a.ndim >= 3


def _masked_step(new, old, t, lengths):
    """Freeze the carry past each sequence's end (identity transition)."""
    if lengths is None:
        return new
    keep = (t < lengths)[:, None]
    return jnp.where(keep, new, old)


def forward_log(
    log_obs: jax.Array,
    log_a: jax.Array,
    log_pi: jax.Array,
    lengths: Optional[jax.Array] = None,
    method: str = "scan",
    unroll: int = SCAN_UNROLL,
) -> tuple[jax.Array, jax.Array]:
    """Forward algorithm. Returns ``(log_alpha (B,T,K), log_z (B,))``.

    ``log_z`` is the sequence log-likelihood ``log p(o_1..o_T)`` — computed
    in log space throughout, deliberately NOT reproducing the reference's
    prob-space round-trip bug (``hmm.py:203-206``).
    """
    B, T, K = log_obs.shape
    la0 = log_pi + log_obs[:, 0]  # (B, K) via broadcast if log_pi is (K,)

    if method == "associative":
        log_alpha = _forward_associative(log_obs, log_a, la0, lengths)
    else:
        tv = _time_varying(log_a)

        def step(carry, xs):
            la, t = carry
            if tv:
                lo_t, la_t = xs
                nxt = lo_t + log_matvec(la, la_t)
            else:
                lo_t = xs
                nxt = lo_t + log_matvec(la, log_a)
            nxt = _masked_step(nxt, la, t, lengths)
            return (nxt, t + 1), nxt

        xs = (log_obs[:, 1:].swapaxes(0, 1), log_a[:, 1:].swapaxes(0, 1)) if tv \
            else log_obs[:, 1:].swapaxes(0, 1)
        (_, _), rest = jax.lax.scan(
            step, (la0, jnp.int32(1)), xs, unroll=unroll
        )
        log_alpha = jnp.concatenate([la0[:, None], rest.swapaxes(0, 1)], axis=1)

    if lengths is None:
        log_z = logsumexp(log_alpha[:, -1], axis=-1)
    else:
        last = jnp.take_along_axis(
            log_alpha, (lengths - 1)[:, None, None].astype(jnp.int32), axis=1
        )[:, 0]
        log_z = logsumexp(last, axis=-1)
    return log_alpha, log_z


def _semiring_identity(K, dtype):
    """Identity element of the (logsumexp, +) matrix semiring: diag 0,
    off-diagonal ~-inf (finite -1e30 so reductions never see inf-inf)."""
    return jnp.where(jnp.eye(K, dtype=bool), 0.0, -1e30).astype(dtype)


def _forward_associative(log_obs, log_a, la0, lengths=None):
    """All-prefix forward via associative scan in the log-matmul semiring.

    Element t (t >= 1) is the matrix ``M_t[i, j] = log_a[i, j] + log_obs[t, j]``;
    the prefix product applied to ``alpha_0`` yields every ``alpha_t`` at
    O(log T) depth. We fold ``alpha_0`` in as a rank-1 first element so a
    single scan produces all prefixes.

    Ragged batches: steps into padded frames
    (``t >= lengths[b]``) are semiring identity matrices, freezing alpha
    at its final valid value — the same freeze semantics as the
    sequential path's masked carry (values agree to reduction-order
    rounding, since the scan tree reassociates logsumexp).
    """
    B, T, K = log_obs.shape
    if _time_varying(log_a):
        m = log_a[:, 1:] + log_obs[:, 1:, None, :]  # (B, T-1, K, K)
    else:
        m = log_a[None, None] + log_obs[:, 1:, None, :]
    # First element: rows all equal to alpha_0, so row 0 of every prefix
    # product equals log alpha_t.
    m0 = jnp.broadcast_to(la0[:, None, None, :], (B, 1, K, K))
    m = jnp.concatenate([m0, m], axis=1)  # (B, T, K, K)
    if lengths is not None:
        pad = jnp.arange(T)[None, :] >= lengths[:, None]  # (B, T)
        eye = _semiring_identity(K, log_obs.dtype)
        m = jnp.where(pad[:, :, None, None], eye[None, None], m)
    prefixes = jax.lax.associative_scan(log_matmul, m, axis=1)
    return prefixes[:, :, 0, :]  # (B, T, K)


def backward_log(
    log_obs: jax.Array,
    log_a: jax.Array,
    lengths: Optional[jax.Array] = None,
    method: str = "scan",
    unroll: int = SCAN_UNROLL,
) -> jax.Array:
    """Backward algorithm. Returns ``log_beta (B, T, K)``.

    Recursion (reference ``hmm.py:110-117``):
    ``beta_t[i] = logsumexp_j(log_a[i,j] + log_obs[t+1,j] + beta_{t+1}[j])``
    with ``beta_{T-1} = 0``. Under padding, ``beta_t = 0`` for
    ``t >= lengths[b] - 1`` so that padded frames are identity steps.
    """
    B, T, K = log_obs.shape
    bT = jnp.zeros((B, K), log_obs.dtype)

    if method == "associative":
        return _backward_associative(log_obs, log_a, lengths)

    tv = _time_varying(log_a)

    def step(carry, xs):
        lb, t = carry
        if tv:
            lo_next, la_t = xs
            nxt = log_matvec_t(la_t, lo_next + lb)
        else:
            lo_next = xs
            nxt = log_matvec_t(log_a, lo_next + lb)
        if lengths is not None:
            keep = (t < lengths - 1)[:, None]
            nxt = jnp.where(keep, nxt, jnp.zeros_like(nxt))
        return (nxt, t - 1), nxt

    xs = (log_obs[:, 1:].swapaxes(0, 1), log_a[:, 1:].swapaxes(0, 1)) if tv \
        else log_obs[:, 1:].swapaxes(0, 1)
    (_, _), rest = jax.lax.scan(
        step, (bT, jnp.int32(T - 2)), xs, reverse=True, unroll=unroll
    )
    return jnp.concatenate([rest.swapaxes(0, 1), bT[:, None]], axis=1)


def _backward_associative(log_obs, log_a, lengths=None):
    B, T, K = log_obs.shape
    if _time_varying(log_a):
        m = log_a[:, 1:] + log_obs[:, 1:, None, :]
    else:
        m = jnp.broadcast_to(
            log_a[None, None] + log_obs[:, 1:, None, :], (B, T - 1, K, K)
        )
    if lengths is not None:
        # Steps into padded frames (global index t >= lengths[b]; m[t-1]
        # is the step into frame t) become semiring identities, so
        # beta_t = 0 for every t >= lengths[b]-1, matching the sequential
        # masked recursion.
        pad = jnp.arange(1, T)[None, :] >= lengths[:, None]  # (B, T-1)
        eye = _semiring_identity(K, log_obs.dtype)
        m = jnp.where(pad[:, :, None, None], eye[None, None], m)
    # Suffix products: reverse associative scan; beta_t = M_{t+1} ⊗ ... ⊗ M_{T-1} 1
    # Append an all-zero column vector as a rank-1 final element.
    mT = jnp.zeros((B, 1, K, K), log_obs.dtype)
    m = jnp.concatenate([m, mT], axis=1)
    # reverse=True reverses, scans, and un-reverses — so the combine sees
    # (later, earlier) and must flip its operands to keep matrix order.
    suffixes = jax.lax.associative_scan(
        lambda a, b: log_matmul(b, a), m, axis=1, reverse=True
    )
    return suffixes[:, :, :, 0]


@partial(jax.jit, static_argnames=("method", "unroll"))
def forward_backward(
    log_obs: jax.Array,
    log_a: jax.Array,
    log_pi: jax.Array,
    lengths: Optional[jax.Array] = None,
    method: str = "scan",
    unroll: int = SCAN_UNROLL,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Full forward-backward pass.

    Returns ``(log_gamma, log_alpha, log_beta, log_z)`` where ``log_gamma``
    is the normalized state posterior ``log p(s_t | o_{1:T})`` of shape
    ``(B, T, K)``. Mirrors reference ``HMMPyTorch.forward_backward``
    (``hmm.py:66-130``) which returns probability-space
    ``(posterior, alpha, beta)``; exponentiate at the call site for parity.
    """
    log_alpha, log_z = forward_log(
        log_obs, log_a, log_pi, lengths, method, unroll
    )
    log_beta = backward_log(log_obs, log_a, lengths, method, unroll)
    lg = log_alpha + log_beta
    log_gamma = lg - logsumexp(lg, axis=-1, keepdims=True)
    return log_gamma, log_alpha, log_beta, log_z


@partial(jax.jit, static_argnames=("method", "unroll"))
def log_likelihood(
    log_obs: jax.Array,
    log_a: jax.Array,
    log_pi: jax.Array,
    lengths: Optional[jax.Array] = None,
    method: str = "scan",
    unroll: int = SCAN_UNROLL,
) -> jax.Array:
    """Sequence log-likelihood ``log p(o_1..o_T)`` of shape ``(B,)``."""
    _, log_z = forward_log(log_obs, log_a, log_pi, lengths, method, unroll)
    return log_z


def xi_expectations(
    log_alpha: jax.Array,
    log_beta: jax.Array,
    log_obs: jax.Array,
    log_a: jax.Array,
    log_z: jax.Array,
) -> jax.Array:
    """Pairwise posteriors ``xi_t[i,j] = p(s_t=i, s_{t+1}=j | o)``, summed
    over t. Shape ``(B, K, K)``. The E-step sufficient statistic for the
    transition matrix (the reference has no EM; BASELINE config 2 needs it).
    """
    if _time_varying(log_a):
        la = log_a[:, 1:]
    else:
        la = log_a[None, None]
    lxi = (
        log_alpha[:, :-1, :, None]
        + la
        + (log_obs + log_beta)[:, 1:, None, :]
        - log_z[:, None, None, None]
    )
    return logsumexp(lxi, axis=1)
