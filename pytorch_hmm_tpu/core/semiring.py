"""Semiring linear algebra for HMM dynamic programming.

All HMM recursions in this framework (forward, backward, Viterbi, HSMM
segment DP, CTC lattice DP) are expressed as matrix/vector products in one
of two semirings over log-space numbers:

* **sum-product** (log-semiring): ``(logsumexp, +)`` — used by the forward
  and backward algorithms and by likelihood computation.
* **max-product** (tropical semiring): ``(max, +)`` — used by Viterbi
  decoding, where we also need the argmax for backtracking.

The reference implementation (pytorch_hmm: ``hmm.py:95-101``,
``hmm.py:162-168``, ``mixture_gaussian.py:315-324``, ``hsmm.py:277-316``)
re-implements these contractions inline four separate times inside Python
``for t in range(T)`` loops. Here they are factored into a tiny, fully
vectorized primitive layer that every model shares: elementwise work and
reductions, or, for the associative-scan time parallelization, batched
``(K, K)`` contractions.

Conventions
-----------
Transition matrices are *row-stochastic*: ``A[i, j] = P(s_t = j | s_{t-1} = i)``,
matching the reference (``hmm.py:39``). Log-space matrices use ``-inf`` for
impossible transitions; all ops here are ``-inf``-safe.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# A finite stand-in for log(0) used where -inf would create NaNs under
# autodiff (e.g. softmax over a fully-masked row). Mirrors the role of the
# reference's `log(P + 1e-8)` epsilon (hmm.py:42) without biasing feasible
# transitions.
LOG_ZERO = -1e30

# Time steps per trip of the XLA loops in ``core`` (``lax.scan`` unroll).
# Chosen on the GPU among 1, 8, 16, 32 and 64 (``chip_smoke.py`` phase 6,
# PERF.md): 32 was best for the likelihood + gradient step and within 6%
# of 64 for decode.
SCAN_UNROLL = 32


def logsumexp(x: jax.Array, axis=None, keepdims: bool = False) -> jax.Array:
    """-inf-safe logsumexp (thin wrapper over jax.scipy)."""
    return jax.scipy.special.logsumexp(x, axis=axis, keepdims=keepdims)


def log_matvec(v: jax.Array, log_a: jax.Array) -> jax.Array:
    """Sum-product semiring vector-matrix product.

    ``out[..., j] = logsumexp_i(v[..., i] + log_a[..., i, j])``

    This is one step of the forward recursion: ``v`` is ``log alpha_{t-1}``
    (shape ``(..., K)``) and ``log_a`` is the (possibly batched or
    time-varying) log transition matrix ``(..., K, K)``.
    """
    return logsumexp(v[..., :, None] + log_a, axis=-2)


def log_matvec_t(log_a: jax.Array, v: jax.Array) -> jax.Array:
    """Sum-product semiring matrix-vector product (backward recursion step).

    ``out[..., i] = logsumexp_j(log_a[..., i, j] + v[..., j])``
    """
    return logsumexp(log_a + v[..., None, :], axis=-1)


def log_matmul(x: jax.Array, y: jax.Array) -> jax.Array:
    """Sum-product semiring matrix-matrix product.

    ``out[..., i, j] = logsumexp_k(x[..., i, k] + y[..., k, j])``

    Used as the associative combine for temporal parallelization of the
    forward algorithm (cf. Särkkä & García-Fernández, "Temporal
    Parallelization of Inference in Hidden Markov Models").
    """
    return logsumexp(x[..., :, :, None] + y[..., None, :, :], axis=-2)


def max_matvec(v: jax.Array, log_a: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Max-product semiring vector-matrix product with argmax.

    ``out[..., j] = max_i(v[..., i] + log_a[..., i, j])``

    Returns ``(max_values, argmax_indices)`` — one Viterbi trellis step with
    its backpointers (reference: ``hmm.py:162-168``).
    """
    scores = v[..., :, None] + log_a
    return jnp.max(scores, axis=-2), jnp.argmax(scores, axis=-2)


def max_matmul(x: jax.Array, y: jax.Array) -> jax.Array:
    """Max-product semiring matrix-matrix product (no argmax)."""
    return jnp.max(x[..., :, :, None] + y[..., None, :, :], axis=-2)


def safe_log(x: jax.Array, eps: float = 1e-8) -> jax.Array:
    """Numerically safe elementwise log, matching reference semantics.

    The reference adds an epsilon before the log (``hmm.py:42``,
    ``mixture_gaussian.py:137-144``); we do the same where behavioral parity
    matters (probability-space inputs).
    """
    return jnp.log(x + eps)


def normalize_log(x: jax.Array, axis=-1) -> jax.Array:
    """Normalize a log-space distribution so that exp sums to 1 over axis."""
    return x - logsumexp(x, axis=axis, keepdims=True)
