"""Closed-form Baum-Welch (EM) for GMM-HMMs, as a pure function.

``MixtureGaussianHMMLayer.em_step`` applies it to its parameters; it is
usable on its own, without flax.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import core
from .core.semiring import logsumexp
from .emissions import gmm_component_log_probs

__all__ = ["gmm_em_update"]


@partial(
    jax.jit,
    static_argnames=("covariance_type", "learnable_transitions", "mesh"),
)
def gmm_em_update(
    obs: jax.Array,
    means: jax.Array,
    cov_params: jax.Array,
    mixture_logits: jax.Array,
    log_a: jax.Array,
    log_pi: jax.Array,
    covariance_type: str,
    var_floor: float,
    learnable_transitions: bool,
    mesh=None,
):
    """One exact Baum-Welch update of a GMM-HMM from a batch ``obs (B, T,
    D)``.

    E-step: forward-backward posteriors γ and pairwise ξ
    (``ops.auto_em_statistics``, or the block-parallel sharded pass over
    ``mesh``), component responsibilities r = γ · softmax_c(comp
    scores). M-step: closed-form weight / mean / covariance / transition
    updates. Returns ``(mean log-likelihood before the update, new)``
    with ``new`` holding ``means``, ``cov_params``, ``mixture_logits`` and,
    when ``learnable_transitions``, ``transition_logits``.
    """
    B, T, D = obs.shape
    S, C, _ = means.shape

    comp = gmm_component_log_probs(obs, means, cov_params, covariance_type)
    log_w = jax.nn.log_softmax(mixture_logits, axis=-1)
    weighted = comp + log_w[None, None]  # (B, T, S, C)
    log_obs = logsumexp(weighted, axis=-1)  # (B, T, S)

    if mesh is not None:
        from .parallel.sharded import sharded_forward_backward

        log_gamma, log_alpha, log_beta, log_z = sharded_forward_backward(
            log_obs, log_a, log_pi, mesh
        )
        xi = jnp.exp(
            core.xi_expectations(log_alpha, log_beta, log_obs, log_a, log_z)
        )
    else:
        from .ops import auto_em_statistics

        log_gamma, xi, log_z = auto_em_statistics(log_obs, log_a, log_pi)
    # Component responsibilities: r = γ_s · p(c | x, s).
    log_r = log_gamma[..., None] + weighted - log_obs[..., None]
    r = jnp.exp(log_r)  # (B, T, S, C)

    r_sum = jnp.sum(r, axis=(0, 1)) + 1e-10  # (S, C)
    new_w = r_sum / jnp.sum(r_sum, axis=-1, keepdims=True)
    new_means = jnp.einsum("btsc,btd->scd", r, obs) / r_sum[..., None]

    ex2 = jnp.einsum("btsc,btd->scd", r, obs * obs) / r_sum[..., None]
    var_diag = jnp.maximum(ex2 - new_means**2, var_floor)  # (S, C, D)

    if covariance_type == "diag":
        new_cov = jnp.log(var_diag)
    elif covariance_type == "spherical":
        new_cov = jnp.log(jnp.mean(var_diag, axis=-1))
    elif covariance_type == "tied":
        w = r_sum / jnp.sum(r_sum)
        new_cov = jnp.log(jnp.einsum("sc,scd->d", w, var_diag))
    elif covariance_type == "full":
        exx = jnp.einsum("btsc,btd,bte->scde", r, obs, obs) / r_sum[..., None, None]
        cov = exx - jnp.einsum("scd,sce->scde", new_means, new_means)
        cov = cov + var_floor * jnp.eye(D)[None, None]
        chol = jnp.linalg.cholesky(cov)  # (S, C, D, D)
        rows, cols = jnp.tril_indices(D)
        flat = chol[..., rows, cols]
        # Invert the softplus-diagonal parameterization of tril_from_flat.
        diag_pos = jnp.asarray([i * (i + 1) // 2 + i for i in range(D)])
        diag = jnp.diagonal(chol, axis1=-2, axis2=-1)
        inv_sp = jnp.log(jnp.expm1(jnp.maximum(diag - 1e-4, 1e-6)))
        flat = flat.at[..., diag_pos].set(inv_sp)
        new_cov = flat
    else:
        raise ValueError(covariance_type)

    new = {
        "means": new_means,
        "cov_params": new_cov,
        "mixture_logits": jnp.log(new_w + 1e-10),
    }
    if learnable_transitions:
        a_new = jnp.sum(xi, axis=0)  # (K, K): Σ_b Σ_t ξ_t
        a_new = a_new / (jnp.sum(a_new, axis=-1, keepdims=True) + 1e-10)
        new["transition_logits"] = jnp.log(a_new + 1e-10)
    return jnp.mean(log_z), new
