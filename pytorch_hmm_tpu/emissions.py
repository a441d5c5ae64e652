"""Emission (observation) models as pure log-prob functions.

Every emission model here is a pure function ``(params, obs) → (B, T, K)
log-probs`` feeding the shared DP kernels (SURVEY.md §7 principle 2).

Design note: the reference scores Gaussians by materializing a
``(B, T, S, C, D)`` difference tensor (``mixture_gaussian.py:175``,
``hmm_layer.py:270-323``) — a pure HBM-bandwidth burn. Here the quadratic
form is expanded so scoring becomes two ``(B·T, D) × (D, S·C)`` matmuls::

    (x-μ)ᵀ diag(1/σ²) (x-μ) = x²·(1/σ²) − 2x·(μ/σ²) + Σ μ²/σ²

which XLA hands to the matmul units; the per-state/component terms are
rank-1 corrections. Full covariance goes through precomputed inverse
Cholesky factors with time-chunked evaluation to bound memory.

Mixed precision: every function takes ``compute_dtype`` (default
``None`` = resolve from the live ``USE_MIXED_PRECISION`` flag, see
``precision.py``). The big contractions run at that precision with
float32 accumulation; returned log-probs are always float32 so the
DP recursions never carry bf16.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .core.semiring import logsumexp
from .precision import mxu_einsum

__all__ = [
    "diag_gaussian_log_probs",
    "spherical_gaussian_log_probs",
    "full_gaussian_log_probs",
    "fullcov_prepare",
    "full_gaussian_log_probs_prepared",
    "fullcov_mixture_log_probs_prepared",
    "gaussian_log_probs",
    "gmm_log_probs",
    "gmm_component_log_probs",
    "tril_from_flat",
    "tril_inverse",
    "flat_dim",
]

_LOG_2PI = math.log(2.0 * math.pi)


# ---------------------------------------------------------------------------
# Single Gaussian per state (GaussianHMMLayer emissions, hmm_layer.py:270-323)
# ---------------------------------------------------------------------------

def diag_gaussian_log_probs(
    obs: jax.Array, means: jax.Array, log_vars: jax.Array,
    compute_dtype=None,
) -> jax.Array:
    """Diagonal-covariance Gaussian scores.

    Args:
        obs: ``(B, T, D)``; means: ``(..., K, D)``; log_vars: ``(..., K, D)``.
        compute_dtype: contraction dtype (None → precision policy).
    Returns:
        ``(B, T, K)`` log N(obs; mean_k, diag(exp(log_vars_k))) in f32.
    """
    D = obs.shape[-1]
    inv_var = jnp.exp(-log_vars)  # (K, D)
    mm = jnp.sum(means * means * inv_var, axis=-1)  # (K,)
    log_norm = -0.5 * (D * _LOG_2PI + jnp.sum(log_vars, axis=-1))

    # One augmented contraction [x², x, 1] @ W. x² is squared in f32
    # before any reduced-precision pass (squaring rounded values doubles
    # the error).
    W = jnp.concatenate(
        [inv_var, -2.0 * means * inv_var, mm[..., None]], axis=-1
    )  # (K, 2D+1)
    ones = jnp.ones((*obs.shape[:-1], 1), obs.dtype)
    aug = jnp.concatenate([obs * obs, obs, ones], axis=-1)  # (..., 2D+1)
    mahal = mxu_einsum("bte,ke->btk", aug, W, dtype=compute_dtype)
    return log_norm - 0.5 * mahal


def spherical_gaussian_log_probs(
    obs: jax.Array, means: jax.Array, log_vars: jax.Array,
    compute_dtype=None,
) -> jax.Array:
    """Isotropic Gaussian scores. ``log_vars`` has shape ``(K,)`` (σ² shared
    over dimensions)."""
    D = obs.shape[-1]
    inv_var = jnp.exp(-log_vars)  # (K,)
    x2 = jnp.sum(obs * obs, axis=-1)  # (B, T) — f32
    xm = mxu_einsum("btd,kd->btk", obs, means, dtype=compute_dtype)
    m2 = jnp.sum(means * means, axis=-1)  # (K,)
    mahal = (x2[..., None] - 2.0 * xm + m2) * inv_var
    log_norm = -0.5 * D * (_LOG_2PI + log_vars)
    return log_norm - 0.5 * mahal


def fullcov_prepare(means: jax.Array, chol: jax.Array) -> dict:
    """Observation-independent tables for full-covariance scoring.

    ~0.07 ms of small-matrix work (Cholesky inverse + precision
    assembly) at the flagship (48, 80, 80) shape — worth hoisting out of
    the per-call decode path when parameters are static (serving); see
    ``MixtureGaussianHMMLayer.make_decoder``.

    The Mahalanobis term is the expanded precision form
    ``xᵀPx − 2x·(Pμ̃) + μ̃ᵀPμ̃`` over centered coordinates. Centering
    on the mean of the means keeps the expansion O(Mahalanobis distance)
    for un-centered features — shifting x and μ by the same constant is
    exact.

    Returns ``{"prec": (K, D, D), "pm": (K, D), "mm": (K,),
    "center": (D,), "log_norm": (K,)}``.
    """
    D = means.shape[-1]
    inv_chol = tril_inverse(chol)  # (K, D, D): L^{-1}
    logdet = jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
    log_norm = -0.5 * D * _LOG_2PI - logdet  # (K,)
    center = jnp.mean(means, axis=0)
    mu_c = means - center
    wm = jnp.einsum("ked,kd->ke", inv_chol, mu_c)          # L⁻¹ μ̃, (K, D)
    prec = jnp.einsum("ked,kef->kdf", inv_chol, inv_chol)  # Σ⁻¹, (K, D, D)
    pm = jnp.einsum("kde,ke->kd", prec, mu_c)              # Σ⁻¹ μ̃
    mm = jnp.sum(wm * wm, axis=-1)                         # μ̃ᵀ Σ⁻¹ μ̃, (K,)
    return {
        "prec": prec, "pm": pm, "mm": mm,
        "center": center, "log_norm": log_norm,
    }


def full_gaussian_log_probs_prepared(
    obs: jax.Array,
    prep: dict,
    time_chunk: int = 128,
    compute_dtype=None,
) -> jax.Array:
    """Full-covariance scores from :func:`fullcov_prepare` tables.

    The per-call cost is the three-operand ``xPx`` einsum plus a thin
    matvec and the centering subtract. ``time_chunk`` bounds the rows of
    τ each contraction sees, and with them whatever intermediate XLA
    picks for the quadratic.
    """
    return _fullcov_scored_prepared(
        obs, prep, time_chunk, compute_dtype, mixture=None
    )


def fullcov_mixture_log_probs_prepared(
    obs: jax.Array,
    prep: dict,
    num_states: int,
    num_components: int,
    time_chunk: int = 128,
    compute_dtype=None,
) -> jax.Array:
    """Mixture-marginalized state scores ``(B, T, S)`` straight from
    :func:`fullcov_prepare` tables with the log mixture weights already
    folded into ``prep["log_norm"]``. The logsumexp over components runs
    INSIDE each time chunk, so the ``(B, T, S·C)`` component tensor
    never round-trips HBM — the serving decode path
    (``MixtureGaussianHMMLayer.make_decoder``)."""
    return _fullcov_scored_prepared(
        obs, prep, time_chunk, compute_dtype,
        mixture=(num_states, num_components),
    )


def _fullcov_scored_prepared(obs, prep, time_chunk, compute_dtype, mixture):
    B, T, D = obs.shape
    log_norm = prep["log_norm"]
    prec, pm, mm = prep["prec"], prep["pm"], prep["mm"]
    center = prep["center"]

    def score_chunk(x):
        x = x - center  # per-chunk: fuses into the einsum producer
        xpx = mxu_einsum(
            "btd,kde,bte->btk", x, prec, x, dtype=compute_dtype
        )
        xq = mxu_einsum("btd,kd->btk", x, pm, dtype=compute_dtype)
        # A true Mahalanobis distance is non-negative; clamp so rounding
        # in the expansion can never push log-probs above log_norm.
        mahal = jnp.maximum(xpx - 2.0 * xq + mm, 0.0)
        out = log_norm[None, None] - 0.5 * mahal
        if mixture is not None:
            S, C = mixture
            out = logsumexp(out.reshape(*out.shape[:-1], S, C), axis=-1)
        return out

    if T <= time_chunk:
        return score_chunk(obs)

    # Prefer a chunk size that DIVIDES T: padding the time axis (and
    # pre-subtracting the center) each materialize a full (B, T, D)
    # copy through HBM — ~0.05 ms at the flagship shape, a third of the
    # whole emission budget. A divisor chunk slices the raw input in
    # place (T=1000 → τ=125 instead of 128 + 24 padded frames).
    tc = max(
        (d for d in range(time_chunk, time_chunk // 2, -1) if T % d == 0),
        default=0,
    )
    if tc:
        obs_p, Tp = obs, T
    else:  # awkward T: fall back to padding
        tc = time_chunk
        Tp = T + ((-T) % tc)
        obs_p = jnp.pad(obs, ((0, 0), (0, Tp - T), (0, 0)))

    # Chunk via scan + dynamic slices: the reshape/swapaxes form of
    # lax.map relayouts the whole (B, T, D) input and output through HBM
    # (~0.04 ms at the flagship shape); slicing reads in place. (An
    # unrolled static-slice loop + concat was measured 0.21 ms vs this
    # form's 0.17 at the flagship shape — the concat's output copies
    # cost more than the scan's loop overhead.)
    def body(_, i):
        x = jax.lax.dynamic_slice_in_dim(obs_p, i * tc, tc, axis=1)
        return 0, score_chunk(x)

    _, out = jax.lax.scan(body, 0, jnp.arange(Tp // tc))  # (n, B, τ, K')
    out = out.transpose(1, 0, 2, 3).reshape(B, Tp, -1)
    return out[:, :T]


def full_gaussian_log_probs(
    obs: jax.Array,
    means: jax.Array,
    chol: jax.Array,
    time_chunk: int = 128,
    compute_dtype=None,
) -> jax.Array:
    """Full-covariance Gaussian scores via precision matrices.

    A real full-covariance path — the reference's GaussianHMMLayer silently
    falls back to a diagonal approximation (``hmm_layer.py:311-319``); we
    do not reproduce that bug. Composition of :func:`fullcov_prepare`
    (parameter-only tables) and :func:`full_gaussian_log_probs_prepared`
    (one augmented quadratic-form einsum).

    Args:
        obs: ``(B, T, D)``; means ``(K, D)``; chol ``(K, D, D)`` lower
            triangular with positive diagonal.
        time_chunk: time-block size bounding whatever intermediate XLA
            picks for the quadratic-form contraction.
    Returns: ``(B, T, K)``.
    """
    prep = fullcov_prepare(means, chol)
    return full_gaussian_log_probs_prepared(
        obs, prep, time_chunk=time_chunk, compute_dtype=compute_dtype
    )


def gaussian_log_probs(
    obs: jax.Array,
    means: jax.Array,
    log_scales: jax.Array,
    covariance_type: str = "diag",
    compute_dtype=None,
) -> jax.Array:
    """Dispatch matching GaussianHMMLayer's parameterization: ``log_scales``
    is the log *standard deviation* (``hmm_layer.py:270-323`` uses
    ``log_var = 2 * log_scales``)."""
    if covariance_type == "diag":
        return diag_gaussian_log_probs(
            obs, means, 2.0 * log_scales, compute_dtype
        )
    if covariance_type == "spherical":
        return spherical_gaussian_log_probs(
            obs, means, 2.0 * log_scales[..., 0], compute_dtype
        )
    if covariance_type == "full":
        # log_scales: (K, D, D) raw; build a valid Cholesky factor.
        tril = jnp.tril(log_scales, k=-1)
        diag = jnp.exp(jnp.diagonal(log_scales, axis1=-2, axis2=-1))
        chol = tril + jax.vmap(jnp.diag)(diag)
        return full_gaussian_log_probs(
            obs, means, chol, compute_dtype=compute_dtype
        )
    raise ValueError(f"Unknown covariance_type: {covariance_type}")


# ---------------------------------------------------------------------------
# GMM emissions (MixtureGaussianHMMLayer, mixture_gaussian.py:157-288)
# ---------------------------------------------------------------------------

def flat_dim(d: int) -> int:
    """Size of the flattened lower triangle of a (d, d) matrix."""
    return d * (d + 1) // 2


def tril_from_flat(flat: jax.Array, d: int) -> jax.Array:
    """Unpack ``(..., d(d+1)/2)`` → lower-triangular ``(..., d, d)`` with
    softplus-positive diagonal (guaranteed PD covariance — the reference's
    raw-diagonal Cholesky params (``mixture_gaussian.py:271-288``) can go
    non-positive under training).

    Built by a static GATHER (take) instead of a scatter.
    """
    # idx[r, c] = flat position of (r, c) for c <= r, else the padded
    # zero slot appended at the end.
    tri = np.zeros((d, d), np.int32)
    r, c = np.tril_indices(d)
    tri[r, c] = np.arange(len(r))
    tri[np.triu_indices(d, 1)] = flat.shape[-1]
    idx = jnp.asarray(tri.reshape(-1))
    padded = jnp.concatenate(
        [flat, jnp.zeros((*flat.shape[:-1], 1), flat.dtype)], axis=-1
    )
    L = jnp.take(padded, idx, axis=-1).reshape(*flat.shape[:-1], d, d)
    diag = jax.nn.softplus(jnp.diagonal(L, axis1=-2, axis2=-1)) + 1e-4
    L = jnp.tril(L, k=-1)
    return L + diag[..., None] * jnp.eye(d, dtype=flat.dtype)


def tril_inverse(L: jax.Array) -> jax.Array:
    """Batched lower-triangular inverse via Newton iteration.

    ``X ← X (2I − L X)`` doubles the number of correct Neumann terms per
    step, and for a triangular matrix the series is finite — ⌈log₂ d⌉
    iterations give the EXACT inverse (in exact arithmetic). Each step
    is two batched matmuls, so the whole inverse is ~15 matmuls in place
    of a batched ``solve_triangular``, which back-substitutes serially.
    """
    d = L.shape[-1]
    eye = jnp.eye(d, dtype=L.dtype)
    x = eye / jnp.diagonal(L, axis1=-2, axis2=-1)[..., :, None]  # D⁻¹ seed
    n_iter = max(1, int(np.ceil(np.log2(d))))
    mm = partial(
        jnp.matmul, precision=jax.lax.Precision.HIGHEST
    )  # exact-nilpotency argument needs true-f32 multiplies
    for _ in range(n_iter):
        x = mm(x, 2.0 * eye - mm(L, x))
        # Newton preserves triangularity only in exact arithmetic;
        # re-project so rounding never leaks into the upper triangle.
        x = jnp.tril(x)
    return x


def gmm_component_log_probs(
    obs: jax.Array,
    means: jax.Array,
    cov_params: jax.Array,
    covariance_type: str = "diag",
    time_chunk: int = 128,
    compute_dtype=None,
) -> jax.Array:
    """Per-component Gaussian scores ``(B, T, S, C)``.

    means: ``(S, C, D)``. cov_params by type:
    ``diag`` → log-variances ``(S, C, D)``; ``full`` → flattened Cholesky
    ``(S, C, D(D+1)/2)``; ``tied`` → shared log-variances ``(D,)``;
    ``spherical`` → log-variance ``(S, C)``.
    """
    B, T, D = obs.shape
    S, C, _ = means.shape

    if covariance_type == "diag":
        m2 = means.reshape(S * C, D)
        lv2 = cov_params.reshape(S * C, D)
        return diag_gaussian_log_probs(
            obs, m2, lv2, compute_dtype
        ).reshape(B, T, S, C)

    if covariance_type == "tied":
        # One diagonal covariance shared across all states/components.
        m2 = means.reshape(S * C, D)
        lv2 = jnp.broadcast_to(cov_params, (S * C, D))
        return diag_gaussian_log_probs(
            obs, m2, lv2, compute_dtype
        ).reshape(B, T, S, C)

    if covariance_type == "spherical":
        m2 = means.reshape(S * C, D)
        lv2 = cov_params.reshape(S * C)
        return spherical_gaussian_log_probs(
            obs, m2, lv2, compute_dtype
        ).reshape(B, T, S, C)

    if covariance_type == "full":
        chol = tril_from_flat(cov_params.reshape(S * C, -1), D)
        out = full_gaussian_log_probs(
            obs, means.reshape(S * C, D), chol, time_chunk=time_chunk,
            compute_dtype=compute_dtype,
        )
        return out.reshape(B, T, S, C)

    raise ValueError(f"Unknown covariance_type: {covariance_type}")


def gmm_log_probs(
    obs: jax.Array,
    means: jax.Array,
    cov_params: jax.Array,
    mixture_logits: jax.Array,
    covariance_type: str = "diag",
    time_chunk: int = 128,
    compute_dtype=None,
) -> jax.Array:
    """Mixture-marginalized state scores ``(B, T, S)``:
    ``logsumexp_c(log w_{s,c} + log N_c(x))`` (``mixture_gaussian.py:192-196``).
    """
    comp = gmm_component_log_probs(
        obs, means, cov_params, covariance_type, time_chunk, compute_dtype
    )
    log_w = jax.nn.log_softmax(mixture_logits, axis=-1)  # (S, C)
    return logsumexp(comp + log_w[None, None], axis=-1)
