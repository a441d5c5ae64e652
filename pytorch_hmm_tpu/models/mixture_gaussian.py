"""MixtureGaussianHMMLayer — GMM-HMM acoustic model (+ EM training).

Parity target: reference ``mixture_gaussian.py:20-382`` (K-state,
C-component GMM emissions with diag/full/tied/spherical covariances,
learnable or fixed left-to-right transitions, batched Viterbi decode).

Differences from the reference:

* emission scoring is matmul-form (see ``emissions.py``) — no
  ``(B, T, S, C, D)`` broadcast (reference ``mixture_gaussian.py:175``);
* decoding/likelihood run on the shared ``core`` scan kernels instead of a
  private Viterbi (``mixture_gaussian.py:290-338``);
* full-covariance Cholesky diagonals are softplus-positive (always PD);
* a closed-form Baum-Welch ``em_step`` is provided — the reference has no
  EM at all, but BASELINE.json config 2 requires it;
* no ``max_sequence_length`` warning: long sequences are handled by
  chunked/sharded scans, not capped (SURVEY.md §5 long-context).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from flax import nnx

from ..core.semiring import logsumexp, safe_log
from ..ops import auto_gmm_viterbi, auto_log_likelihood
from ..em import gmm_em_update
from ..emissions import (flat_dim, gmm_component_log_probs,
                         gmm_log_probs, tril_from_flat)
from ..precision import maybe_remat
from .common import Buffer, TrainMode

__all__ = ["MixtureGaussianHMMLayer", "PreparedGMMDecoder"]


class PreparedGMMDecoder:
    """Parameter-frozen GMM-HMM Viterbi decoder (see ``make_decoder``).

    Holds only derived arrays; ``__call__`` is one jitted program:
    emission scoring (for full covariance, a single augmented
    quadratic-form einsum over pre-inverted precision matrices) into the
    shared trellis (``auto_viterbi``: the Viterbi kernel on the GPU).
    Decodes match ``MixtureGaussianHMMLayer.__call__``
    exactly — both routes share the same emission math and trellis.
    """

    def __init__(self, emission_kind, emission_tables, log_a, log_pi,
                 num_states, num_components, covariance_type=None):
        self.emission_kind = emission_kind
        self.emission_tables = emission_tables
        self.log_a = log_a
        self.log_pi = log_pi
        self.num_states = num_states
        self.num_components = num_components
        self.covariance_type = covariance_type

    def log_obs(self, observations: jax.Array) -> jax.Array:
        """State emission scores ``(B, T, S)`` from the frozen tables."""
        if self.emission_kind == "full_prepared":
            from ..emissions import fullcov_mixture_log_probs_prepared

            # Mixture weights are pre-folded into log_norm; the lse over
            # components runs inside each time chunk.
            return fullcov_mixture_log_probs_prepared(
                observations, self.emission_tables,
                self.num_states, self.num_components,
            )
        t = self.emission_tables
        return gmm_log_probs(
            observations, t["means"], t["cov_params"], t["log_w"],
            self.covariance_type,
        )

    def __call__(
        self,
        observations: jax.Array,
        return_log_probs: bool = False,
        lengths: Optional[jax.Array] = None,
    ) -> Tuple[jax.Array, Optional[jax.Array]]:
        from ..ops import auto_viterbi

        states, score = auto_viterbi(
            self.log_obs(observations), self.log_a, self.log_pi, lengths
        )
        return (states, score) if return_log_probs else (states, None)


jax.tree_util.register_pytree_node(
    PreparedGMMDecoder,
    lambda d: (
        (d.emission_tables, d.log_a, d.log_pi),
        (d.emission_kind, d.num_states, d.num_components,
         d.covariance_type),
    ),
    lambda aux, leaves: PreparedGMMDecoder(
        aux[0], leaves[0], leaves[1], leaves[2], aux[1], aux[2], aux[3]
    ),
)


def _l2r_fixed(num_states: int) -> jax.Array:
    """Reference's fixed decode topology: 0.8 self-loop / 0.2 forward
    (``mixture_gaussian.py:119-135``)."""
    eye = jnp.eye(num_states)
    nxt = jnp.eye(num_states, num_states, 1)
    p = 0.8 * eye + 0.2 * nxt
    return p.at[-1, -1].set(1.0)


class MixtureGaussianHMMLayer(TrainMode):
    """GMM-HMM with 4 covariance families and EM / gradient training."""

    def __init__(
        self,
        num_states: int,
        feature_dim: int,
        num_components: int = 3,
        covariance_type: str = "diag",
        learnable_transitions: bool = True,
        max_sequence_length: int = 10000,
        *,
        rngs: Optional[nnx.Rngs] = None,
    ):
        rngs = rngs or nnx.Rngs(0)
        self.num_states = num_states
        self.feature_dim = feature_dim
        self.num_components = num_components
        self.covariance_type = covariance_type
        self.learnable_transitions = learnable_transitions
        self.max_sequence_length = max_sequence_length
        self.eps = 1e-8
        self.log_eps = math.log(self.eps)
        self._training = True

        S, C, D = num_states, num_components, feature_dim
        if learnable_transitions:
            self.transition_logits = nnx.Param(
                jax.random.normal(rngs.params(), (S, S)) * 0.1
            )
        else:
            self.transition_matrix = Buffer(_l2r_fixed(S))

        self.mixture_weights_logits = nnx.Param(
            jax.random.normal(rngs.params(), (S, C)) * 0.1
        )
        gain = math.sqrt(2.0 / D)
        self.means = nnx.Param(
            jax.random.normal(rngs.params(), (S, C, D)) * gain
        )

        if covariance_type in ("diag",):
            self.cov_params = nnx.Param(jnp.zeros((S, C, D)))
        elif covariance_type == "full":
            flat = jnp.zeros((S, C, flat_dim(D)))
            rows = jnp.asarray([i * (i + 1) // 2 + i for i in range(D)])
            # softplus(0.54) ≈ 1.0 → unit initial variances.
            flat = flat.at[..., rows].set(0.5413)
            self.cov_params = nnx.Param(flat)
        elif covariance_type == "tied":
            self.cov_params = nnx.Param(jnp.zeros((D,)))
        elif covariance_type == "spherical":
            self.cov_params = nnx.Param(jnp.zeros((S, C)))
        else:
            raise ValueError(f"Unknown covariance_type: {covariance_type}")

    # -- parameter views ------------------------------------------------------
    def get_transition_matrix(self) -> jax.Array:
        if self.learnable_transitions:
            return jax.nn.softmax(self.transition_logits[...], axis=-1)
        return self.transition_matrix[...]

    def _log_a(self) -> jax.Array:
        if self.learnable_transitions:
            return jax.nn.log_softmax(self.transition_logits[...], axis=-1)
        return safe_log(self.transition_matrix[...])

    def _log_pi(self) -> jax.Array:
        # Reference decodes with a uniform prior (mixture_gaussian.py:307).
        return jnp.full((self.num_states,), -math.log(self.num_states))

    # -- emissions --------------------------------------------------------------
    def get_component_log_probs(self, observations: jax.Array) -> jax.Array:
        """Per-component scores ``(B, T, S, C)`` (before mixture weights)."""
        return gmm_component_log_probs(
            observations, self.means[...], self.cov_params[...],
            self.covariance_type,
        )

    def get_observation_log_probs(self, observations: jax.Array) -> jax.Array:
        """State scores ``(B, T, S)`` (``mixture_gaussian.py:157-198``)."""
        comp = self.get_component_log_probs(observations)
        log_w = jax.nn.log_softmax(self.mixture_weights_logits[...], axis=-1)
        return logsumexp(comp + log_w[None, None], axis=-1)

    # -- inference ---------------------------------------------------------------
    def __call__(
        self,
        observations: jax.Array,
        return_log_probs: bool = False,
        lengths: Optional[jax.Array] = None,
    ) -> Tuple[jax.Array, Optional[jax.Array]]:
        """Viterbi decode: ``(decoded_states (B, T), seq_log_probs (B,)|None)``
        (``mixture_gaussian.py:340-365``). ``lengths`` masks ragged batches
        (padded frames repeat each row's final valid state). Every
        covariance family routes through ``auto_gmm_viterbi``."""
        log_w = jax.nn.log_softmax(
            self.mixture_weights_logits[...], axis=-1
        )
        states, score = auto_gmm_viterbi(
            observations, self.means[...], self.cov_params[...], log_w,
            self._log_a(), self._log_pi(), lengths,
            covariance_type=self.covariance_type,
        )
        return (states, score) if return_log_probs else (states, None)

    forward = __call__

    def make_decoder(self) -> "PreparedGMMDecoder":
        """Freeze the current parameters into a serving decoder.

        Decode-time emission scoring needs only parameter-DERIVED tables
        (for full covariance: the augmented precision matrices from
        ``emissions.fullcov_prepare`` — ~0.07 ms of Cholesky-inverse
        work per call otherwise). This hoists that prologue out of the
        per-call path, the standard weight-preprocessing step of a
        serving engine. The returned decoder is a pure pytree-of-arrays
        callable with ``__call__(observations, return_log_probs,
        lengths)`` semantics identical to the layer's.

        Parameters are captured BY VALUE: train further (``em_step`` /
        optimizer updates), then call ``make_decoder()`` again for a
        fresh snapshot.
        """
        log_w = jax.nn.log_softmax(self.mixture_weights_logits[...], axis=-1)
        S, C, D = self.num_states, self.num_components, self.feature_dim
        if self.covariance_type == "full":
            from ..emissions import fullcov_prepare

            chol = tril_from_flat(
                self.cov_params[...].reshape(S * C, -1), D
            )
            prep = fullcov_prepare(self.means[...].reshape(S * C, D), chol)
            # Fold the mixture weights into the per-component constant so
            # decode is einsum + logsumexp only.
            prep = dict(prep, log_norm=prep["log_norm"] + log_w.reshape(-1))
            emission = ("full_prepared", prep)
        else:
            emission = (
                "raw",
                {
                    "means": self.means[...],
                    "cov_params": self.cov_params[...],
                    "log_w": log_w,
                },
            )
        return PreparedGMMDecoder(
            emission_kind=emission[0],
            emission_tables=emission[1],
            log_a=self._log_a(),
            log_pi=self._log_pi(),
            num_states=S,
            num_components=C,
            covariance_type=self.covariance_type,
        )

    def log_likelihood(
        self, observations: jax.Array, lengths: Optional[jax.Array] = None
    ) -> jax.Array:
        """Marginal sequence log-likelihood ``(B,)`` via the forward pass.

        With ``Config.USE_CHECKPOINTING`` on, the ``(B, T, S, C)``
        component scores are rematerialized in the backward pass
        (``precision.maybe_remat``) instead of stored across it."""

        def _score(o, means, cov_params, mixture_logits):
            return gmm_log_probs(
                o, means, cov_params, mixture_logits,
                self.covariance_type,
            )

        log_obs = maybe_remat(_score)(
            observations, self.means[...], self.cov_params[...],
            self.mixture_weights_logits[...],
        )
        return auto_log_likelihood(
            log_obs, self._log_a(), self._log_pi(), lengths
        )

    def compute_loss(
        self, observations: jax.Array, lengths: Optional[jax.Array] = None
    ) -> jax.Array:
        """NLL for gradient training."""
        return -jnp.mean(self.log_likelihood(observations, lengths))

    # -- EM (Baum-Welch) ----------------------------------------------------------
    def em_step(
        self,
        observations: jax.Array,
        var_floor: float = 1e-3,
        mesh=None,
    ):
        """One exact Baum-Welch update from a batch of sequences.

        E-step: forward-backward posteriors γ and pairwise ξ on the shared
        kernels, component responsibilities r = γ · softmax_c(comp scores).
        M-step: closed-form weight/mean/covariance/transition updates.
        Returns the batch mean log-likelihood *before* the update.

        With ``mesh`` (a ``(data, time)`` ``jax.sharding.Mesh``), the
        forward-backward pass runs on the block-parallel sharded kernel
        and the sufficient-statistic reductions distribute over the mesh
        — distributed EM, which the reference cannot express at all.
        Shard ``observations`` with ``parallel.shard_batch`` first.
        """
        (ll, new) = gmm_em_update(
            observations,
            self.means[...],
            self.cov_params[...],
            self.mixture_weights_logits[...],
            self._log_a(),
            self._log_pi(),
            self.covariance_type,
            var_floor,
            self.learnable_transitions,
            mesh,
        )
        self.means[...] = new["means"]
        self.cov_params[...] = new["cov_params"]
        self.mixture_weights_logits[...] = new["mixture_logits"]
        if self.learnable_transitions:
            self.transition_logits[...] = new["transition_logits"]
        return ll

    def get_model_info(self) -> dict:
        """Configuration and parameter statistics
        (``mixture_gaussian.py:367-382``)."""
        graphdef, params = nnx.split(self, nnx.Param)
        total = sum(x.size for x in jax.tree.leaves(params))
        return {
            "num_states": self.num_states,
            "feature_dim": self.feature_dim,
            "num_components": self.num_components,
            "covariance_type": self.covariance_type,
            "learnable_transitions": self.learnable_transitions,
            "total_parameters": int(total),
            "trainable_parameters": int(total),
            "memory_efficient": True,
            "max_sequence_length": self.max_sequence_length,
        }
