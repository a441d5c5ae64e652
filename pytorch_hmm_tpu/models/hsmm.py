"""HSMMLayer / DurationConstrainedHMM — explicit-duration models.

Parity targets: reference ``hsmm.py:20-472`` (HSMMLayer: no-self-loop
transitions, gamma/Poisson/Weibull duration pmfs with softplus-learnable
parameters, diagonal-Gaussian emissions, segment Viterbi, generation) and
``hsmm.py:475-590`` (DurationConstrainedHMM: MLP emissions + duration-
penalized Viterbi).

Differences from the reference:

* decoding runs on the shared vectorized segment-DP scan
  (``core/hsmm.py``) — batched, O(T·(DS+S²)) — instead of the reference's
  per-sequence O(T·S²·D²) Python loops (``hsmm.py:235-354``); no
  T>1000 warning because there is no cliff;
* a differentiable HSMM *forward* algorithm (``log_likelihood`` /
  ``compute_loss``) is provided — the reference can only Viterbi-decode;
* DurationConstrainedHMM expresses its soft min/max duration penalties as
  a duration log-score in the same segment DP, rather than mutating a
  running-duration counter inside a Python Viterbi (``hsmm.py:520-590``).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from flax import nnx

from ..core.hsmm import hsmm_log_z, hsmm_posteriors, hsmm_viterbi
from ..durations import (
    gamma_duration_log_pmf,
    poisson_duration_log_pmf,
    weibull_duration_log_pmf,
)
from ..emissions import diag_gaussian_log_probs
from .common import Buffer, TrainMode

__all__ = ["HSMMLayer", "DurationConstrainedHMM"]


class HSMMLayer(TrainMode):
    """Hidden semi-Markov model with explicit state durations."""

    def __init__(
        self,
        num_states: int,
        feature_dim: int,
        duration_distribution: str = "gamma",
        max_duration: int = 50,
        learnable_duration_params: bool = True,
        min_duration: int = 1,
        normalize_durations: bool = False,
        *,
        rngs: Optional[nnx.Rngs] = None,
    ):
        rngs = rngs or nnx.Rngs(0)
        if duration_distribution not in ("gamma", "poisson", "weibull"):
            raise ValueError(
                f"Unknown duration distribution: {duration_distribution}"
            )
        self.num_states = num_states
        self.feature_dim = feature_dim
        self.duration_distribution = duration_distribution
        self.max_duration = max_duration
        self.min_duration = min_duration
        self.learnable_duration_params = learnable_duration_params
        self.normalize_durations = normalize_durations
        self.eps = 1e-8

        S, F = num_states, feature_dim
        self.transition_logits = nnx.Param(
            jax.random.normal(rngs.params(), (S, S)) * 0.1
        )
        self.observation_means = nnx.Param(
            jax.random.normal(rngs.params(), (S, F)) * 0.1
        )
        self.observation_log_vars = nnx.Param(jnp.zeros((S, F)))

        # Raw (pre-softplus) duration parameters; initial values match the
        # reference (mean duration ~10 frames, hsmm.py:80-100).
        def raw(v):
            # softplus(x) = v  ⇒  x = log(expm1(v))
            arr = jnp.full((S,), math.log(math.expm1(v)))
            return nnx.Param(arr) if learnable_duration_params else Buffer(arr)

        if duration_distribution == "gamma":
            self.duration_shape = raw(2.0)
            self.duration_rate = raw(0.2)
        elif duration_distribution == "poisson":
            self.duration_lambda = raw(10.0)
        else:  # weibull
            self.duration_scale = raw(10.0)
            self.duration_concentration = raw(2.0)

    # -- parameter views ------------------------------------------------------
    def get_transition_matrix(self) -> jax.Array:
        """Softmax transitions with a hard-zero diagonal (no self-loops,
        ``hsmm.py:108-113``)."""
        logits = self.transition_logits[...]
        masked = jnp.where(
            jnp.eye(self.num_states, dtype=bool), -jnp.inf, logits
        )
        return jax.nn.softmax(masked, axis=-1)

    def _log_a(self) -> jax.Array:
        logits = self.transition_logits[...]
        masked = jnp.where(
            jnp.eye(self.num_states, dtype=bool), -jnp.inf, logits
        )
        return jax.nn.log_softmax(masked, axis=-1)

    def _log_pi(self) -> jax.Array:
        # Uniform initial distribution, as in the reference's decoder
        # (hsmm.py:269-274 scores every state's first segment equally).
        return jnp.full((self.num_states,), -math.log(self.num_states))

    def get_duration_log_probs(self) -> jax.Array:
        """(S, D) duration log-pmf (``hsmm.py:115-179``)."""
        kw = dict(
            max_duration=self.max_duration,
            min_duration=self.min_duration,
            normalize=self.normalize_durations,
        )
        sp = jax.nn.softplus
        if self.duration_distribution == "gamma":
            return gamma_duration_log_pmf(
                sp(self.duration_shape[...]), sp(self.duration_rate[...]), **kw
            )
        if self.duration_distribution == "poisson":
            return poisson_duration_log_pmf(
                sp(self.duration_lambda[...]), **kw
            )
        return weibull_duration_log_pmf(
            sp(self.duration_scale[...]),
            sp(self.duration_concentration[...]),
            **kw,
        )

    def get_duration_probabilities(self) -> jax.Array:
        """(S, D) probabilities — reference API shape (``hsmm.py:115``)."""
        return jnp.exp(self.get_duration_log_probs())

    def get_observation_log_probs(self, observations: jax.Array) -> jax.Array:
        """(B, T, S) diagonal-Gaussian scores (``hsmm.py:181-206``)."""
        return diag_gaussian_log_probs(
            observations,
            self.observation_means[...],
            self.observation_log_vars[...],
        )

    # -- inference ------------------------------------------------------------
    def viterbi_decode_hsmm(
        self,
        observations: jax.Array,
        lengths: Optional[jax.Array] = None,
    ) -> Tuple[jax.Array, jax.Array]:
        """Best segmentation: ``(states (B, T), scores (B,))``
        (``hsmm.py:208-243``). ``lengths`` (B,) masks ragged batches
        (padded frames repeat each row's final valid state)."""
        log_obs = self.get_observation_log_probs(observations)
        return hsmm_viterbi(
            log_obs, self._log_a(), self._log_pi(),
            self.get_duration_log_probs(), lengths,
        )

    def __call__(
        self,
        observations: jax.Array,
        lengths: Optional[jax.Array] = None,
    ):
        return self.viterbi_decode_hsmm(observations, lengths)

    forward = __call__

    def log_likelihood(
        self,
        observations: jax.Array,
        lengths: Optional[jax.Array] = None,
    ) -> jax.Array:
        """Marginal log-likelihood over all segmentations ``(B,)`` — new
        capability; the reference has no HSMM forward algorithm."""
        log_obs = self.get_observation_log_probs(observations)
        return hsmm_log_z(
            log_obs, self._log_a(), self._log_pi(),
            self.get_duration_log_probs(), lengths,
        )

    def compute_loss(
        self,
        observations: jax.Array,
        lengths: Optional[jax.Array] = None,
    ) -> jax.Array:
        return -jnp.mean(self.log_likelihood(observations, lengths))

    def em_step(
        self,
        observations: jax.Array,
        var_floor: float = 1e-3,
        lengths: Optional[jax.Array] = None,
        mesh=None,
    ):
        """One Baum-Welch update for the HSMM (new capability — the
        reference cannot train its HSMMs at all beyond autograd).

        E-step: expected frame occupancy, segment-transition counts and
        per-duration segment counts, obtained as gradients of ``log Z``
        through the segment DP. M-step: closed-form Gaussian emission
        update from occupancy-weighted moments; transition update from
        normalized counts; duration parameters by moment matching the
        posterior duration distribution (gamma: shape = m²/v,
        rate = m/v; poisson: λ = m; weibull: moment-matched via gamma
        then mapped through the mean/variance relations — approximated
        by the gamma fit). Returns the mean log-likelihood before the
        update.

        ``lengths`` (B,) restricts every statistic to each row's valid
        prefix (padded-frame gradients are identically zero through the
        final-frame gather). With ``mesh`` (a ``jax.sharding.Mesh`` with
        a ``data`` axis), the E-step runs batch-sharded under
        ``shard_map`` and the sufficient statistics are ``psum``-reduced
        over devices — distributed HSMM EM, which the reference cannot
        express at all.
        """
        obs = observations if observations.ndim == 3 else observations[None]
        w, sx, sx2, trans_counts, _, dur_counts, lz_mean = (
            _hsmm_em_stats_reduced(
            obs,
            self.observation_means[...],
            self.observation_log_vars[...],
            self._log_a(),
            self._log_pi(),
            self.get_duration_log_probs(),
            lengths,
            mesh,
        ))

        # Emissions: occupancy-weighted Gaussian moments.
        mean = sx / w[:, None]
        ex2 = sx2 / w[:, None]
        var = jnp.maximum(ex2 - mean**2, var_floor)
        self.observation_means[...] = mean
        self.observation_log_vars[...] = jnp.log(var)

        # Transitions: normalized expected segment-transition counts
        # (diagonal stays structurally zero via the masked softmax).
        tc = jnp.maximum(trans_counts, 0.0) + 1e-10
        tc = tc * (1.0 - jnp.eye(self.num_states))
        self.transition_logits[...] = jnp.log(
            tc / jnp.sum(tc, axis=-1, keepdims=True)
        )

        # Durations: moment-match the posterior duration pmf — only when
        # the duration parameters are trainable (fixed-duration models
        # keep them as Buffers that EM must not touch).
        if not self.learnable_duration_params:
            return lz_mean
        dc = jnp.maximum(dur_counts, 0.0) + 1e-10  # (S, D)
        d_grid = jnp.arange(1, self.max_duration + 1, dtype=jnp.float32)
        p_d = dc / jnp.sum(dc, axis=-1, keepdims=True)
        m = jnp.sum(p_d * d_grid, axis=-1)
        v = jnp.maximum(
            jnp.sum(p_d * d_grid**2, axis=-1) - m**2, 0.25
        )
        inv_sp = lambda y: jnp.log(jnp.expm1(jnp.maximum(y, 1e-4)))
        if self.duration_distribution == "gamma":
            self.duration_shape[...] = inv_sp(m * m / v)
            self.duration_rate[...] = inv_sp(m / v)
        elif self.duration_distribution == "poisson":
            self.duration_lambda[...] = inv_sp(m)
        else:  # weibull: fall back to matching the mean with fixed k=2
            conc = jax.nn.softplus(self.duration_concentration[...])
            scale = m / jnp.exp(
                jax.scipy.special.gammaln(1.0 + 1.0 / conc)
            )
            self.duration_scale[...] = inv_sp(scale)
        return lz_mean

    def posteriors(
        self,
        observations: jax.Array,
        lengths: Optional[jax.Array] = None,
    ) -> dict:
        """Exact frame occupancy + segment boundary posteriors (keys:
        ``gamma``, ``segment_start``, ``segment_end``, ``log_z``) — new
        capability; the reference can only Viterbi-decode its HSMMs.
        With ``lengths`` (B,), posteriors are zero at padded frames."""
        log_obs = self.get_observation_log_probs(observations)
        return hsmm_posteriors(
            log_obs, self._log_a(), self._log_pi(),
            self.get_duration_log_probs(), lengths,
        )

    # -- generation ------------------------------------------------------------
    def generate_sequence(
        self,
        length: int,
        initial_state: int = 0,
        key: Optional[jax.Array] = None,
    ) -> Tuple[jax.Array, jax.Array]:
        """Ancestral sampling: ``(states (length,), obs (length, F))``
        (``hsmm.py:356-424``). Fixed-shape: a scan over frames carrying
        (state, frames-left); durations are drawn when a segment opens.
        """
        key = key if key is not None else jax.random.PRNGKey(0)
        log_dur = self.get_duration_log_probs()
        log_a = self._log_a()
        means = self.observation_means[...]
        stds = jnp.exp(0.5 * self.observation_log_vars[...])

        def step(carry, key_t):
            state, left = carry
            k_dur, k_tr = jax.random.split(key_t)
            # When the current segment is exhausted, transition and draw a
            # fresh duration; otherwise keep counting down.
            new_state = jax.random.categorical(k_tr, log_a[state])
            new_dur = 1 + jax.random.categorical(k_dur, log_dur[new_state])
            opens = left <= 0
            state = jnp.where(opens, new_state, state)
            left = jnp.where(opens, new_dur, left) - 1
            return (state, left), state

        k0, k_obs, k_seq = jax.random.split(key, 3)
        init_dur = 1 + jax.random.categorical(k0, log_dur[initial_state])
        keys = jax.random.split(k_seq, length)
        _, states = jax.lax.scan(
            step, (jnp.int32(initial_state), init_dur), keys
        )
        noise = jax.random.normal(k_obs, (length, self.feature_dim))
        observations = means[states] + stds[states] * noise
        return states, observations

    # -- introspection ----------------------------------------------------------
    def get_expected_durations(self) -> jax.Array:
        """Closed-form expected duration per state (``hsmm.py:439-452``)."""
        sp = jax.nn.softplus
        if self.duration_distribution == "gamma":
            return sp(self.duration_shape[...]) / sp(self.duration_rate[...])
        if self.duration_distribution == "poisson":
            return sp(self.duration_lambda[...])
        scale = sp(self.duration_scale[...])
        conc = sp(self.duration_concentration[...])
        return scale * jnp.exp(jax.scipy.special.gammaln(1.0 + 1.0 / conc))

    def get_model_info(self) -> dict:
        graphdef, params = nnx.split(self, nnx.Param)
        total = sum(x.size for x in jax.tree.leaves(params))
        return {
            "model_type": "HSMM",
            "num_states": self.num_states,
            "feature_dim": self.feature_dim,
            "duration_distribution": self.duration_distribution,
            "max_duration": self.max_duration,
            "min_duration": self.min_duration,
            "expected_durations": self.get_expected_durations().tolist(),
            "total_parameters": int(total),
            "trainable_parameters": int(total),
            "learnable_durations": self.learnable_duration_params,
        }


class DurationConstrainedHMM(TrainMode):
    """HMM with MLP emissions and soft min/max duration penalties.

    The reference tracks a running duration inside a Python Viterbi and
    adds penalties when segments are too short/long (``hsmm.py:520-590``).
    Here the same soft constraint is a duration log-score
    ``-w·max(0, min_d − d) − w·max(0, d − max_d)`` fed to the shared
    segment DP — one fused scan, exact penalty per segment.
    """

    def __init__(
        self,
        num_states: int,
        feature_dim: int,
        min_duration: int = 3,
        max_duration: int = 30,
        hidden_dim: int = 128,
        duration_penalty_weight: float = 0.1,
        duration_slack: int = 10,
        *,
        rngs: Optional[nnx.Rngs] = None,
    ):
        rngs = rngs or nnx.Rngs(0)
        self.num_states = num_states
        self.feature_dim = feature_dim
        self.min_duration = min_duration
        self.max_duration = max_duration
        self.duration_penalty_weight = duration_penalty_weight
        # Segments may exceed max_duration at a penalty; bound the DP grid.
        self.duration_grid = max_duration + duration_slack

        self.transition_logits = nnx.Param(
            jax.random.normal(rngs.params(), (num_states, num_states)) * 0.1
        )
        self.emission_net = nnx.Sequential(
            nnx.Linear(feature_dim, hidden_dim, rngs=rngs),
            jax.nn.relu,
            nnx.Linear(hidden_dim, num_states, rngs=rngs),
        )

    def _duration_log_score(self) -> jax.Array:
        d = jnp.arange(1, self.duration_grid + 1, dtype=jnp.float32)
        w = self.duration_penalty_weight
        pen = w * jnp.maximum(0.0, self.min_duration - d) + w * jnp.maximum(
            0.0, d - self.max_duration
        )
        return jnp.broadcast_to(-pen, (self.num_states, self.duration_grid))

    def _log_a(self) -> jax.Array:
        # Self-loops are expressed by segment durations; mask the diagonal.
        masked = jnp.where(
            jnp.eye(self.num_states, dtype=bool),
            -jnp.inf,
            self.transition_logits[...],
        )
        return jax.nn.log_softmax(masked, axis=-1)

    def __call__(self, observations: jax.Array) -> jax.Array:
        """Decoded states ``(B, T)`` (``hsmm.py:504-518``)."""
        log_obs = jax.nn.log_softmax(
            self.emission_net(observations), axis=-1
        )
        log_pi = jnp.full(
            (self.num_states,), -math.log(self.num_states)
        )
        states, _ = hsmm_viterbi(
            log_obs, self._log_a(), log_pi, self._duration_log_score()
        )
        return states

    forward = __call__


def _hsmm_em_stats(log_obs, log_a, log_pi, log_dur, lengths=None):
    """E-step sufficient statistics via autodiff: the gradient of
    ``log Z`` w.r.t. each log-parameter tensor is its expected usage
    count under the posterior (segment transitions for ``log_a``,
    initial-state counts for ``log_pi``, per-duration segment counts for
    ``log_dur``, frame occupancy for ``log_obs``). With ``lengths`` the
    gradients at padded frames are identically zero (log Z never reads
    them)."""

    def lz_sum(log_obs, log_a, log_pi, log_dur):
        # hsmm_log_z carries closed-form cotangents (one backward scan
        # + table algebra) — O(B·T·S) residual memory instead of the
        # scan autodiff's O(T·B·D·S) per-step intermediates.
        lz = hsmm_log_z(log_obs, log_a, log_pi, log_dur, lengths)
        return jnp.sum(lz), lz

    grads, lz = jax.grad(lz_sum, argnums=(0, 1, 2, 3), has_aux=True)(
        log_obs, log_a, log_pi, log_dur
    )
    occupancy, trans_counts, pi_counts, dur_counts = grads
    return occupancy, trans_counts, pi_counts, dur_counts, lz


@partial(jax.jit, static_argnames=("mesh",))
def _hsmm_em_stats_reduced(
    obs, means, log_vars, log_a, log_pi, log_dur, lengths=None, mesh=None
):
    """Reduced HSMM E-step statistics, optionally batch-sharded.

    Returns ``(w (S,), sx (S, F), sx2 (S, F), trans_counts (S, S),
    pi_counts (S,), dur_counts (S, D), lz_mean)`` — occupancy mass and
    first/second occupancy-weighted observation moments plus expected
    segment transition / initial-state / duration counts, already summed
    over the (global) batch and frames. With ``mesh`` the per-device
    partial sums are ``psum``-reduced over the ``data`` axis under
    ``shard_map``, so the (B, T, S) occupancy tensor never leaves its
    home device.
    """
    B = obs.shape[0]

    def local(obs_blk, lengths_blk, means, log_vars, log_a, log_pi, log_dur):
        log_obs = diag_gaussian_log_probs(obs_blk, means, log_vars)
        gamma, tc, pc, dc, lz = _hsmm_em_stats(
            log_obs, log_a, log_pi, log_dur, lengths_blk
        )
        w = jnp.sum(gamma, axis=(0, 1))  # (S,)
        sx = jnp.einsum("bts,btd->sd", gamma, obs_blk)
        sx2 = jnp.einsum("bts,btd->sd", gamma, obs_blk * obs_blk)
        return w, sx, sx2, tc, pc, dc, jnp.sum(lz)

    if mesh is None:
        w, sx, sx2, tc, pc, dc, lz_tot = local(
            obs, lengths, means, log_vars, log_a, log_pi, log_dur
        )
        return w + 1e-10, sx, sx2, tc, pc, dc, lz_tot / B

    from jax.sharding import PartitionSpec as P

    from ..parallel.mesh import DATA_AXIS

    if lengths is None:
        lengths = jnp.full((B,), obs.shape[1], dtype=jnp.int32)

    def body(obs_blk, lengths_blk, means, log_vars, log_a, log_pi, log_dur):
        stats = local(
            obs_blk, lengths_blk, means, log_vars, log_a, log_pi, log_dur
        )
        return jax.tree.map(lambda x: jax.lax.psum(x, DATA_AXIS), stats)

    rep = P()
    # check_vma=False: the segment-DP scan initializes carries from
    # unvarying constants, which the vma type system would reject even
    # though the psum-reduced outputs are correctly replicated.
    w, sx, sx2, tc, pc, dc, lz_tot = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS), rep, rep, rep, rep, rep),
        out_specs=(rep, rep, rep, rep, rep, rep, rep),
        check_vma=False,
    )(obs, lengths, means, log_vars, log_a, log_pi, log_dur)
    return w + 1e-10, sx, sx2, tc, pc, dc, lz_tot / B
