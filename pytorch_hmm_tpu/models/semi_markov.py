"""DurationModel / SemiMarkovHMM / AdaptiveDurationHSMM.

Parity targets: reference ``semi_markov.py`` — a second, independent HSMM
stack with a standalone duration module (``semi_markov.py:9-192``), a
segment HMM with supervised & unsupervised forward and Viterbi
(``semi_markov.py:195-633``) and a context-conditioned variant
(``semi_markov.py:636-681``).

Differences from the reference:

* the unsupervised forward and Viterbi run on the shared segment-DP scan
  (``core/hsmm.py``) instead of quintuple-nested Python loops over
  ``(t, s, d, s', d')`` (``semi_markov.py:308-383, 455-570``) — and they
  are batched (the reference silently processes only ``observations[0]``,
  ``semi_markov.py:328``, a bug we do not reproduce);
* parametric duration *sampling* draws from the truncated discrete pmf on
  the DP grid (fixed-shape ``categorical``) rather than sampling the
  continuous distribution and clamping (``semi_markov.py:155-192``) —
  same support, jit-friendly;
* all shapes are static; generation uses a fixed ``max_length`` frame
  buffer with a valid-length, not Python list appends.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from flax import nnx

from ..core.hsmm import hsmm_forward
from ..core.hsmm import hsmm_log_z, hsmm_posteriors, hsmm_viterbi
from ..durations import (
    gamma_duration_log_pmf,
    gaussian_duration_log_pmf,
    poisson_duration_log_pmf,
)
from ..emissions import diag_gaussian_log_probs
from .common import TrainMode

__all__ = ["DurationModel", "SemiMarkovHMM", "AdaptiveDurationHSMM"]


class DurationModel(TrainMode):
    """Standalone per-state duration distribution
    (``semi_markov.py:9-192``): gamma / poisson / gaussian parametric or a
    neural softmax over the duration grid."""

    def __init__(
        self,
        num_states: int,
        max_duration: int = 50,
        distribution_type: str = "gamma",
        min_duration: int = 1,
        hidden_dim: int = 128,
        *,
        rngs: Optional[nnx.Rngs] = None,
    ):
        rngs = rngs or nnx.Rngs(0)
        self.num_states = num_states
        self.max_duration = max_duration
        self.distribution_type = distribution_type
        self.min_duration = min_duration
        self.hidden_dim = hidden_dim

        S = num_states
        if distribution_type == "gamma":
            self.alpha_params = nnx.Param(jnp.ones((S,)))
            self.beta_params = nnx.Param(jnp.ones((S,)))
        elif distribution_type == "poisson":
            self.lambda_params = nnx.Param(jnp.full((S,), 5.0))
        elif distribution_type == "gaussian":
            self.mean_params = nnx.Param(jnp.full((S,), 10.0))
            self.std_params = nnx.Param(jnp.ones((S,)))
        elif distribution_type == "neural":
            self.state_embedding = nnx.Embed(S, hidden_dim, rngs=rngs)
            self.net = nnx.Sequential(
                nnx.Linear(hidden_dim, hidden_dim, rngs=rngs),
                jax.nn.relu,
                nnx.Linear(hidden_dim, max_duration, rngs=rngs),
            )
        else:
            raise ValueError(f"Unknown distribution_type: {distribution_type}")

    def log_pmf_table(self) -> jax.Array:
        """(S, D) duration log-pmf over every state — the view the segment
        DP consumes."""
        sp = jax.nn.softplus
        kw = dict(
            max_duration=self.max_duration, min_duration=self.min_duration
        )
        if self.distribution_type == "gamma":
            return gamma_duration_log_pmf(
                sp(self.alpha_params[...]) + 1e-6,
                sp(self.beta_params[...]) + 1e-6,
                **kw,
            )
        if self.distribution_type == "poisson":
            return poisson_duration_log_pmf(
                sp(self.lambda_params[...]) + 1e-6, **kw
            )
        if self.distribution_type == "gaussian":
            # Mean is softplus-shifted by min_duration (semi_markov.py:142).
            return gaussian_duration_log_pmf(
                sp(self.mean_params[...]) + self.min_duration,
                sp(self.std_params[...]) + 1e-6,
                **kw,
            )
        # neural
        emb = self.state_embedding(jnp.arange(self.num_states))
        logits = self.net(emb)
        log_p = jax.nn.log_softmax(logits, axis=-1)
        d = jnp.arange(1, self.max_duration + 1)
        return jnp.where(d >= self.min_duration, log_p, -jnp.inf)

    def __call__(
        self,
        state_indices: jax.Array,
        durations: Optional[jax.Array] = None,
    ) -> jax.Array:
        """Duration log-probs (``semi_markov.py:63-79``).

        With ``durations=None``: full distributions ``(..., D)`` per state
        index; else the log-prob of each (state, duration) pair.
        """
        table = self.log_pmf_table()  # (S, D)
        out = table[state_indices]  # (..., D)
        if durations is None:
            return out
        idx = jnp.clip(durations - 1, 0, self.max_duration - 1)
        scored = jnp.take_along_axis(
            out, idx[..., None].astype(jnp.int32), axis=-1
        )[..., 0]
        # Durations outside the model's grid have zero probability; the
        # DP could never produce them, so supervised scoring must agree
        # (clipping would silently mis-score them as max_duration).
        in_grid = (durations >= 1) & (durations <= self.max_duration)
        return jnp.where(in_grid, scored, -jnp.inf)

    forward = __call__

    def sample(
        self,
        state_indices: jax.Array,
        num_samples: int = 1,
        key: Optional[jax.Array] = None,
    ) -> jax.Array:
        """Draw durations ``>= min_duration`` from the truncated pmf."""
        key = key if key is not None else jax.random.PRNGKey(0)
        table = self.log_pmf_table()[state_indices]  # (B, D)
        draws = jax.random.categorical(
            key, table[:, None, :], axis=-1, shape=(*table.shape[:1], num_samples)
        ) + 1
        return draws[:, 0] if num_samples == 1 else draws


class SemiMarkovHMM(TrainMode):
    """Segment HMM with pluggable duration + observation models
    (``semi_markov.py:195-633``)."""

    def __init__(
        self,
        num_states: int,
        observation_dim: int,
        max_duration: int = 50,
        duration_distribution: str = "gamma",
        observation_model: str = "gaussian",
        min_duration: int = 1,
        *,
        rngs: Optional[nnx.Rngs] = None,
    ):
        rngs = rngs or nnx.Rngs(0)
        self.num_states = num_states
        self.observation_dim = observation_dim
        self.max_duration = max_duration
        self.min_duration = min_duration
        self.observation_model_type = observation_model

        self.duration_model = DurationModel(
            num_states=num_states,
            max_duration=max_duration,
            distribution_type=duration_distribution,
            min_duration=min_duration,
            rngs=rngs,
        )
        self.transition_logits = nnx.Param(
            jax.random.normal(rngs.params(), (num_states, num_states))
        )
        self.initial_logits = nnx.Param(jnp.zeros((num_states,)))

        if observation_model == "gaussian":
            self.observation_means = nnx.Param(
                jax.random.normal(rngs.params(), (num_states, observation_dim))
            )
            self.observation_logvars = nnx.Param(
                jnp.zeros((num_states, observation_dim))
            )
        elif observation_model == "neural":
            from .neural import NeuralObservationModel

            self.neural_obs_model = NeuralObservationModel(
                num_states=num_states,
                observation_dim=observation_dim,
                model_type="gaussian",
                rngs=rngs,
            )
        else:
            raise ValueError(f"Unknown observation_model: {observation_model}")

    # -- parameter views ------------------------------------------------------
    def _log_a(self) -> jax.Array:
        # Self-loops are structurally impossible in a segment model; mask
        # the diagonal (the reference leaves it in the softmax but skips it
        # in the DP loops, semi_markov.py:346 — same semantics).
        masked = jnp.where(
            jnp.eye(self.num_states, dtype=bool),
            -jnp.inf,
            self.transition_logits[...],
        )
        return jax.nn.log_softmax(masked, axis=-1)

    def _log_pi(self) -> jax.Array:
        return jax.nn.log_softmax(self.initial_logits[...])

    def observation_log_probs(self, observations: jax.Array) -> jax.Array:
        """(B, T, S) per-frame scores from the configured emission model."""
        if self.observation_model_type == "gaussian":
            return diag_gaussian_log_probs(
                observations,
                self.observation_means[...],
                self.observation_logvars[...],
            )
        return self.neural_obs_model.log_probs(observations)

    # -- forward ---------------------------------------------------------------
    def __call__(
        self,
        observations: jax.Array,
        state_sequence: Optional[jax.Array] = None,
        duration_sequence: Optional[jax.Array] = None,
    ) -> Dict[str, jax.Array]:
        """Supervised (given segmentation) or unsupervised (marginal)
        forward (``semi_markov.py:258-306``). Returns a dict with
        ``log_probability`` and mode-specific extras."""
        if observations.ndim == 2:
            observations = observations[None]
        if state_sequence is not None and duration_sequence is not None:
            return self._supervised_forward(
                observations, state_sequence, duration_sequence
            )
        return self._unsupervised_forward(observations)

    forward = __call__

    def _supervised_forward(self, observations, state_sequence,
                            duration_sequence) -> Dict[str, jax.Array]:
        B, T, _ = observations.shape
        if state_sequence.ndim == 1:
            state_sequence = state_sequence[None]
            duration_sequence = duration_sequence[None]
        N = state_sequence.shape[1]

        # Frame-level state labels from the segmentation: frame t belongs
        # to the first segment whose cumulative end exceeds t.
        seg_end = jnp.cumsum(duration_sequence, axis=1)  # (B, N)
        t_idx = jnp.arange(T)[None, :, None]
        seg_of_frame = jnp.sum(t_idx >= seg_end[:, None, :], axis=-1)
        seg_of_frame = jnp.clip(seg_of_frame, 0, N - 1)  # (B, T)
        frame_states = jnp.take_along_axis(
            state_sequence, seg_of_frame, axis=1
        )

        log_obs = self.observation_log_probs(observations)  # (B, T, S)
        valid = t_idx[..., 0] < seg_end[:, -1:]  # frames inside segments
        per_frame = jnp.take_along_axis(
            log_obs, frame_states[..., None], axis=-1
        )[..., 0]
        log_observation = jnp.sum(jnp.where(valid, per_frame, 0.0), axis=1)

        log_duration = jnp.sum(
            self.duration_model(state_sequence, duration_sequence), axis=1
        )

        # Same diagonal-masked transition model as the unsupervised DP —
        # a supervised segmentation with s_t == s_{t+1} is structurally
        # impossible and scores -inf, consistently.
        log_a = self._log_a()
        trans = log_a[state_sequence[:, :-1], state_sequence[:, 1:]]
        log_transition = jnp.sum(trans, axis=1) + self._log_pi()[
            state_sequence[:, 0]
        ]

        total = log_observation + log_duration + log_transition
        return {
            "log_probability": total,
            "log_observation": log_observation,
            "log_duration": log_duration,
            "log_transition": log_transition,
        }

    def _unsupervised_forward(self, observations) -> Dict[str, jax.Array]:
        log_obs = self.observation_log_probs(observations)
        log_alpha, log_z = hsmm_forward(
            log_obs, self._log_a(), self._log_pi(),
            self.duration_model.log_pmf_table(),
        )
        return {"log_probability": log_z, "forward_variables": log_alpha}

    def log_likelihood(self, observations: jax.Array) -> jax.Array:
        if observations.ndim == 2:
            observations = observations[None]
        return self._unsupervised_forward(observations)["log_probability"]

    def compute_loss(self, observations: jax.Array) -> jax.Array:
        return -jnp.mean(self.log_likelihood(observations))

    def em_step(
        self,
        observations: jax.Array,
        var_floor: float = 1e-3,
        lengths: Optional[jax.Array] = None,
        mesh=None,
    ):
        """One Baum-Welch update (gaussian observation model, parametric
        durations). E-step statistics are gradients of ``log Z`` through
        the segment DP; M-step mirrors ``HSMMLayer.em_step``. Returns
        the mean log-likelihood before the update.

        ``lengths`` (B,) restricts statistics to each row's valid prefix;
        ``mesh`` (a ``jax.sharding.Mesh`` with a ``data`` axis) runs the
        E-step batch-sharded with ``psum``-reduced statistics."""
        if self.observation_model_type != "gaussian":
            raise NotImplementedError("em_step requires gaussian emissions")
        if self.duration_model.distribution_type == "neural":
            raise NotImplementedError(
                "em_step requires a parametric duration model"
            )
        from .hsmm import _hsmm_em_stats_reduced

        obs = observations if observations.ndim == 3 else observations[None]
        w, sx, sx2, trans_counts, pi_counts, dur_counts, lz_mean = (
            _hsmm_em_stats_reduced(
                obs,
                self.observation_means[...],
                self.observation_logvars[...],
                self._log_a(),
                self._log_pi(),
                self.duration_model.log_pmf_table(),
                lengths,
                mesh,
            )
        )

        mean = sx / w[:, None]
        ex2 = sx2 / w[:, None]
        self.observation_means[...] = mean
        self.observation_logvars[...] = jnp.log(
            jnp.maximum(ex2 - mean**2, var_floor)
        )

        tc = jnp.maximum(trans_counts, 0.0) + 1e-10
        tc = tc * (1.0 - jnp.eye(self.num_states))
        self.transition_logits[...] = jnp.log(
            tc / jnp.sum(tc, axis=-1, keepdims=True)
        )
        pc = jnp.maximum(pi_counts, 0.0) + 1e-10
        self.initial_logits[...] = jnp.log(pc / jnp.sum(pc))

        dc = jnp.maximum(dur_counts, 0.0) + 1e-10
        d_grid = jnp.arange(1, self.max_duration + 1, dtype=jnp.float32)
        p_d = dc / jnp.sum(dc, axis=-1, keepdims=True)
        m = jnp.sum(p_d * d_grid, axis=-1)
        v = jnp.maximum(jnp.sum(p_d * d_grid**2, axis=-1) - m**2, 0.25)
        inv_sp = lambda y: jnp.log(jnp.expm1(jnp.maximum(y, 1e-4)))
        dm = self.duration_model
        if dm.distribution_type == "gamma":
            dm.alpha_params[...] = inv_sp(m * m / v)
            dm.beta_params[...] = inv_sp(m / v)
        elif dm.distribution_type == "poisson":
            dm.lambda_params[...] = inv_sp(m)
        else:  # gaussian
            dm.mean_params[...] = inv_sp(
                jnp.maximum(m - dm.min_duration, 1e-3)
            )
            dm.std_params[...] = inv_sp(jnp.sqrt(v))
        return lz_mean

    def posteriors(self, observations: jax.Array) -> Dict[str, jax.Array]:
        """Exact frame occupancy + segment boundary posteriors."""
        if observations.ndim == 2:
            observations = observations[None]
        log_obs = self.observation_log_probs(observations)
        return hsmm_posteriors(
            log_obs, self._log_a(), self._log_pi(),
            self.duration_model.log_pmf_table(),
        )

    # -- decoding ---------------------------------------------------------------
    def viterbi_decode(
        self, observations: jax.Array
    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """Best (states, durations, log_prob) segmentation
        (``semi_markov.py:455-570``). Accepts ``(T, D)`` like the
        reference; the frame-level path is run-length encoded into
        segment states + durations."""
        unbatched = observations.ndim == 2
        obs = observations[None] if unbatched else observations
        log_obs = self.observation_log_probs(obs)
        path, score = hsmm_viterbi(
            log_obs, self._log_a(), self._log_pi(),
            self.duration_model.log_pmf_table(),
        )
        if unbatched:
            p = np.asarray(path[0])
            change = np.flatnonzero(np.diff(p)) + 1
            starts = np.concatenate([[0], change])
            ends = np.concatenate([change, [len(p)]])
            states = jnp.asarray(p[starts])
            durations = jnp.asarray(ends - starts)
            return states, durations, score[0]
        return path, None, score

    # -- sampling ---------------------------------------------------------------
    def sample(
        self,
        num_states: int,
        max_length: int = 100,
        key: Optional[jax.Array] = None,
    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """Sample ``num_states`` segments (``semi_markov.py:572-633``).

        Returns ``(state_sequence (N,), duration_sequence (N,),
        observations (L, D))`` with total length capped at ``max_length``
        (durations past the cap are truncated, trailing segments dropped).
        """
        key = key if key is not None else jax.random.PRNGKey(0)
        if self.observation_model_type != "gaussian":
            raise NotImplementedError(
                "sampling requires the gaussian observation model"
            )
        k_init, k_seg, k_obs = jax.random.split(key, 3)
        # Masked transitions: sampled segment chains must obey the same
        # no-self-transition structure the DP scores with.
        log_a = self._log_a()

        s0 = jax.random.categorical(k_init, self._log_pi())
        dur_table = self.duration_model.log_pmf_table()

        def seg_step(carry, key_i):
            state, used = carry
            k_d, k_t = jax.random.split(key_i)
            dur = 1 + jax.random.categorical(k_d, dur_table[state])
            dur = jnp.minimum(dur, jnp.maximum(max_length - used, 0))
            nxt = jax.random.categorical(k_t, log_a[state])
            return (nxt, used + dur), (state, dur)

        keys = jax.random.split(k_seg, num_states)
        _, (states, durations) = jax.lax.scan(seg_step, (s0, jnp.int32(0)), keys)

        # Frame-level expansion into a fixed max_length buffer.
        seg_end = jnp.cumsum(durations)
        t_idx = jnp.arange(max_length)[:, None]
        seg_of_frame = jnp.sum(t_idx >= seg_end[None, :], axis=-1)
        seg_of_frame = jnp.clip(seg_of_frame, 0, num_states - 1)
        frame_states = states[seg_of_frame]
        total = seg_end[-1]

        means = self.observation_means[...][frame_states]
        stds = jnp.exp(0.5 * self.observation_logvars[...][frame_states])
        noise = jax.random.normal(k_obs, (max_length, self.observation_dim))
        obs = means + stds * noise

        total_i = int(total)
        return states, durations, obs[:total_i]


class AdaptiveDurationHSMM(SemiMarkovHMM):
    """SemiMarkovHMM whose duration distribution is modulated by an
    external context vector (``semi_markov.py:636-681``)."""

    def __init__(
        self,
        num_states: int,
        observation_dim: int,
        context_dim: int,
        hidden_dim: int = 128,
        *,
        rngs: Optional[nnx.Rngs] = None,
        **kwargs,
    ):
        rngs = rngs or nnx.Rngs(0)
        super().__init__(num_states, observation_dim, rngs=rngs, **kwargs)
        self.context_dim = context_dim
        self.state_embedding = nnx.Embed(num_states, num_states, rngs=rngs)
        self.context_duration_net = nnx.Sequential(
            nnx.Linear(context_dim + num_states, hidden_dim, rngs=rngs),
            jax.nn.relu,
            nnx.Linear(hidden_dim, hidden_dim, rngs=rngs),
            jax.nn.relu,
            nnx.Linear(hidden_dim, self.max_duration, rngs=rngs),
        )

    def compute_contextual_duration_probs(
        self, state_indices: jax.Array, context: jax.Array
    ) -> jax.Array:
        """Context-conditioned duration log-pmf ``(..., D)``
        (``semi_markov.py:667-681``)."""
        emb = self.state_embedding(state_indices)
        logits = self.context_duration_net(
            jnp.concatenate([context, emb], axis=-1)
        )
        return jax.nn.log_softmax(logits, axis=-1)

    def contextual_log_likelihood(
        self, observations: jax.Array, context: jax.Array
    ) -> jax.Array:
        """Marginal likelihood with the context-conditioned duration pmf
        swapped into the segment DP (new capability — the reference never
        wires its contextual durations into inference)."""
        if observations.ndim == 2:
            observations = observations[None]
        all_states = jnp.arange(self.num_states)
        log_dur = self.compute_contextual_duration_probs(
            all_states, jnp.broadcast_to(context, (self.num_states, self.context_dim))
        )
        log_obs = self.observation_log_probs(observations)
        return hsmm_log_z(
            log_obs, self._log_a(), self._log_pi(), log_dur
        )
