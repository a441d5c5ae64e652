"""Dispatch between the GPU trellis kernels and the ``core`` scans.

``auto_viterbi``, ``auto_forward``, ``auto_forward_backward``,
``auto_log_likelihood``, ``auto_em_statistics`` and ``auto_gmm_viterbi`` run the Pallas-Triton
kernels of ``ops.trellis`` when the default backend is the GPU, the
transitions are static ``(K, K)`` and K is at most the cap below. Everything
else runs the XLA scans of ``core``, which are also the reference the
kernels are tested against.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import core
from .trellis import trellis_forward_backward, trellis_viterbi

__all__ = [
    "auto_forward",
    "auto_forward_backward",
    "auto_em_statistics",
    "auto_viterbi",
    "auto_log_likelihood",
    "auto_gmm_viterbi",
    "trellis_applies",
    "trellis_forward_backward",
    "trellis_viterbi",
    "TRELLIS_MAX_K",
]

# Largest state count the kernels take: measured faster than the XLA scans
# up to here on the card (PERF.md); beyond it the (Kp, Kp) step tile
# outgrows one program's registers.
TRELLIS_MAX_K = 128


def trellis_applies(num_states: int, log_a: jax.Array) -> bool:
    """True when the trellis kernels serve this call: GPU backend, static
    ``(K, K)`` transitions, ``K <= TRELLIS_MAX_K``."""
    return (
        jax.default_backend() == "gpu"
        and log_a.ndim == 2
        and num_states <= TRELLIS_MAX_K
    )


def _shifted(log_obs, lengths):
    """Per-frame max shift of the emissions, zero past each row's end.

    Raw log-alpha reaches ``|T log p| ~ 1e5`` at speech shapes, where one
    float32 ulp is ~8e-3 and posteriors taken from ``alpha + beta`` absorb
    that as error. Shifting each frame by its max adds the same constant
    to every state, so posteriors are unchanged in exact arithmetic but
    computed at far smaller magnitudes. Returns ``(log_obs - shift,
    cumulative shift (B, T, 1))``.
    """
    shift = jnp.max(log_obs, axis=-1, keepdims=True)
    shift = jnp.where(jnp.isfinite(shift), shift, 0.0)
    if lengths is not None:
        valid = jnp.arange(log_obs.shape[1])[None, :, None] < lengths[:, None, None]
        shift = jnp.where(valid, shift, 0.0)
    return log_obs - shift, jnp.cumsum(shift, axis=1)


def _total(csh):
    """Sum of the shifts over each row's valid frames, ``(B,)`` (the shift
    is zero past a row's end)."""
    return csh[:, -1, 0]


def _fb(log_obs, log_a, log_pi, lengths, backward):
    lo_hat, csh = _shifted(log_obs, lengths)
    alpha_hat, beta_hat, lz_hat = trellis_forward_backward(
        lo_hat, log_a, log_pi, lengths, backward=backward
    )
    return lo_hat, csh, alpha_hat, beta_hat, lz_hat


def auto_forward(log_obs, log_a, log_pi, lengths: Optional[jax.Array] = None):
    """``(log_alpha, log_z)``: the forward kernel on the GPU, else
    ``core.forward_log``."""
    if not trellis_applies(log_obs.shape[-1], log_a):
        return core.forward_log(log_obs, log_a, log_pi, lengths)
    _, csh, alpha_hat, _, lz_hat = _fb(log_obs, log_a, log_pi, lengths, False)
    return alpha_hat + csh, lz_hat + _total(csh)


def auto_forward_backward(
    log_obs, log_a, log_pi, lengths: Optional[jax.Array] = None
):
    """``(log_gamma, log_alpha, log_beta, log_z)``: both recursions in one
    kernel launch on the GPU, else ``core.forward_backward``. The posterior
    normalization matches ``core.forward_backward``."""
    if not trellis_applies(log_obs.shape[-1], log_a):
        return core.forward_backward(log_obs, log_a, log_pi, lengths)
    _, csh, alpha_hat, beta_hat, lz_hat = _fb(
        log_obs, log_a, log_pi, lengths, True
    )
    lg = alpha_hat + beta_hat
    log_gamma = lg - core.semiring.logsumexp(lg, axis=-1, keepdims=True)
    total = _total(csh)
    log_alpha = alpha_hat + csh
    log_beta = beta_hat + (total[:, None, None] - csh)
    return log_gamma, log_alpha, log_beta, lz_hat + total


def _xi_sum(lo_hat, log_a, alpha_hat, beta_hat, valid=None):
    """Pairwise posteriors summed over time, ``(B, K, K)``, from the
    shifted recursions. Each frame pair is normalized to sum to 1 rather
    than divided by Z: over a long sequence alpha and beta drift by a
    rounding error common to all states of a frame, which the
    normalization cancels and division by Z would not. ``valid (B, T)``
    zeroes pairs past a row's end."""
    lxi = (
        alpha_hat[:, :-1, :, None]
        + log_a[None, None]
        + (lo_hat + beta_hat)[:, 1:, None, :]
    )
    lxi = lxi - core.semiring.logsumexp(lxi, axis=(-2, -1), keepdims=True)
    xi = jnp.exp(lxi)
    if valid is not None:
        xi = jnp.where(valid[:, 1:, None, None], xi, 0.0)
    return jnp.sum(xi, axis=1)


def auto_em_statistics(log_obs, log_a, log_pi):
    """E-step statistics ``(log_gamma, xi (B, K, K), log_z)``: posteriors,
    pairwise posteriors summed over time, and the likelihood. On the GPU
    both recursions run in one kernel launch on shifted emissions, and xi
    is normalized per frame pair (``_xi_sum``); else
    ``core.forward_backward`` and ``core.xi_expectations``."""
    if not trellis_applies(log_obs.shape[-1], log_a):
        log_gamma, log_alpha, log_beta, log_z = core.forward_backward(
            log_obs, log_a, log_pi
        )
        xi = core.xi_expectations(log_alpha, log_beta, log_obs, log_a, log_z)
        return log_gamma, jnp.exp(xi), log_z
    lo_hat, csh, alpha_hat, beta_hat, lz_hat = _fb(
        log_obs, log_a, log_pi, None, True
    )
    lg = alpha_hat + beta_hat
    log_gamma = lg - core.semiring.logsumexp(lg, axis=-1, keepdims=True)
    xi = _xi_sum(lo_hat, log_a, alpha_hat, beta_hat)
    return log_gamma, xi, lz_hat + _total(csh)


def auto_viterbi(log_obs, log_a, log_pi, lengths: Optional[jax.Array] = None):
    """``(states, score)``: the Viterbi kernel on the GPU, else
    ``core.viterbi``. Paths are identical on both, tie-breaks included
    (all break toward the lowest state index)."""
    if trellis_applies(log_obs.shape[-1], log_a):
        return trellis_viterbi(log_obs, log_a, log_pi, lengths)
    return core.viterbi(log_obs, log_a, log_pi, lengths)


@jax.custom_vjp
def _trellis_log_likelihood(log_obs, log_a, log_pi, lengths):
    _, csh, _, _, lz_hat = _fb(log_obs, log_a, log_pi, lengths, False)
    return lz_hat + _total(csh)


def _ll_fwd(log_obs, log_a, log_pi, lengths):
    # The backward pass always needs beta, so both recursions run now, in
    # one launch, on the shifted emissions (posteriors at small magnitude).
    lo_hat, csh, alpha_hat, beta_hat, lz_hat = _fb(
        log_obs, log_a, log_pi, lengths, True
    )
    lz = lz_hat + _total(csh)
    return lz, (lo_hat, log_a, lengths, alpha_hat, beta_hat)


def _ll_bwd(res, g):
    """Classic forward-backward identities: ``d log Z / d log_obs = gamma``,
    ``d log Z / d log_a = sum_t xi_t``, ``d log Z / d log_pi = gamma_0``;
    frames past a row's end get zero. Each frame's gamma and each frame
    pair's xi are normalized to sum to 1 (see ``_xi_sum``)."""
    lo_hat, log_a, lengths, alpha_hat, beta_hat = res
    T = lo_hat.shape[1]
    lse = core.semiring.logsumexp
    valid = jnp.arange(T)[None, :] < lengths[:, None]
    lg = alpha_hat + beta_hat
    gamma = jnp.exp(lg - lse(lg, axis=-1, keepdims=True))
    gamma = jnp.where(valid[..., None], gamma, 0.0)
    d_log_obs = g[:, None, None] * gamma
    d_log_pi = jnp.sum(g[:, None] * gamma[:, 0], axis=0)
    xi = _xi_sum(lo_hat, log_a, alpha_hat, beta_hat, valid)
    d_log_a = jnp.sum(g[:, None, None] * xi, axis=0)
    d_lengths = np.zeros(lengths.shape, dtype=jax.dtypes.float0)
    return d_log_obs, d_log_a, d_log_pi, d_lengths


_trellis_log_likelihood.defvjp(_ll_fwd, _ll_bwd)


def auto_log_likelihood(
    log_obs, log_a, log_pi, lengths: Optional[jax.Array] = None
):
    """Differentiable ``log Z (B,)``: the forward kernel with a closed-form
    VJP on the GPU, else ``core.log_likelihood``."""
    if not trellis_applies(log_obs.shape[-1], log_a):
        return core.log_likelihood(log_obs, log_a, log_pi, lengths)
    if lengths is None:
        lengths = jnp.full((log_obs.shape[0],), log_obs.shape[1], jnp.int32)
    return _trellis_log_likelihood(log_obs, log_a, log_pi, lengths)


def auto_gmm_viterbi(
    obs,
    means,
    cov_params=None,
    log_w=None,
    log_a=None,
    log_pi=None,
    lengths: Optional[jax.Array] = None,
    covariance_type: str = "diag",
    log_vars=None,
):
    """GMM-HMM decode ``(states, score)`` for every covariance family: the
    flagship path. Emission scoring is XLA's (matmul form, see
    ``emissions``); the trellis is ``auto_viterbi``.

    ``log_w`` are log mixture weights ``(S, C)``; ``log_vars`` is the older
    keyword name of ``cov_params``.
    """
    from ..emissions import gmm_log_probs

    if cov_params is None:
        cov_params = log_vars
    log_obs = gmm_log_probs(obs, means, cov_params, log_w, covariance_type)
    return auto_viterbi(log_obs, log_a, log_pi, lengths)
