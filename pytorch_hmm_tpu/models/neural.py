"""Neural HMMs: learned transition and observation models.

Parity targets: reference ``neural.py`` — context-dependent dynamic
transition matrices (MLP/LSTM/Transformer, ``neural.py:10-120``), neural
observation models (gaussian/mixture/autoregressive heads over a shared
state-embedding + feature trunk, ``neural.py:123-293``), and their
combination with private forward/backward/Viterbi supporting time-varying
transitions (``neural.py:296-519``) plus a phoneme/prosody contextual
variant (``neural.py:522-588``).

Differences from the reference:

* inference reuses the shared ``core`` scan kernels, which already accept
  time-varying ``(B, T, S, S)`` log-transition tensors — no private DP
  (reference ``neural.py:403-511``);
* per-state observation scoring is one broadcast over a ``(S, H)`` state
  embedding table instead of a Python loop over states
  (``neural.py:198-208``);
* ``compute_likelihood`` stays in log space (the reference exponentiates
  the forward table then re-logs it, ``neural.py:513-519``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from flax import nnx

from ..core.semiring import logsumexp
from ..ops import auto_forward_backward, auto_log_likelihood, auto_viterbi
from ..precision import matmul_precision
from .common import TrainMode


def _f32(x: jax.Array) -> jax.Array:
    """Cast a net output back to float32 at the scoring boundary: the
    Gaussian score algebra and every DP carry stay float32 regardless
    of the net's matmul precision."""
    return x.astype(jnp.float32)

__all__ = [
    "NeuralTransitionModel",
    "NeuralObservationModel",
    "NeuralHMM",
    "ContextualNeuralHMM",
]


class _MLP(nnx.Module):
    def __init__(self, din, dhid, dout, dropout, rngs, n_hidden=2):
        # Matmul precision bound at construction (precision policy):
        # None = backend default (TF32 on the GPU), HIGHEST = true f32
        # when mixed precision is off.
        prec = matmul_precision()
        dims = [din] + [dhid] * (n_hidden - 1)
        for i, d in enumerate(dims):
            setattr(
                self, f"lin{i}",
                nnx.Linear(d, dhid, precision=prec, rngs=rngs),
            )
        self.out = nnx.Linear(dhid, dout, precision=prec, rngs=rngs)
        self.drop = nnx.Dropout(dropout, rngs=rngs)
        self.n_hidden = n_hidden

    def __call__(self, x, deterministic=True):
        for i in range(self.n_hidden):
            x = jax.nn.relu(getattr(self, f"lin{i}")(x))
            x = self.drop(x, deterministic=deterministic)
        return self.out(x)


class _TransformerBlock(nnx.Module):
    def __init__(self, d_model, n_heads, d_ff, dropout, rngs):
        prec = matmul_precision()
        self.attn = nnx.MultiHeadAttention(
            num_heads=n_heads, in_features=d_model, decode=False,
            precision=prec, rngs=rngs
        )
        self.ff1 = nnx.Linear(d_model, d_ff, precision=prec, rngs=rngs)
        self.ff2 = nnx.Linear(d_ff, d_model, precision=prec, rngs=rngs)
        self.ln1 = nnx.LayerNorm(d_model, rngs=rngs)
        self.ln2 = nnx.LayerNorm(d_model, rngs=rngs)
        self.drop = nnx.Dropout(dropout, rngs=rngs)

    def __call__(self, x, deterministic=True):
        h = self.attn(self.ln1(x), deterministic=deterministic)
        x = x + self.drop(h, deterministic=deterministic)
        h = self.ff2(jax.nn.relu(self.ff1(self.ln2(x))))
        return x + self.drop(h, deterministic=deterministic)


class NeuralTransitionModel(TrainMode):
    """Context-dependent transition matrices ``(B, T, S, S)``
    (``neural.py:10-120``). ``model_type``: ``mlp`` | ``rnn`` (LSTM) |
    ``transformer`` (self-attention encoder)."""

    def __init__(
        self,
        num_states: int,
        context_dim: int,
        hidden_dim: int = 256,
        model_type: str = "mlp",
        dropout: float = 0.1,
        num_transformer_layers: int = 3,
        num_heads: int = 8,
        *,
        rngs: Optional[nnx.Rngs] = None,
    ):
        rngs = rngs or nnx.Rngs(0)
        self.num_states = num_states
        self.context_dim = context_dim
        self.hidden_dim = hidden_dim
        self.model_type = model_type

        S = num_states
        if model_type == "mlp":
            self.network = _MLP(
                context_dim + S, hidden_dim, S * S, dropout, rngs
            )
        elif model_type == "rnn":
            self.rnn = nnx.RNN(
                nnx.OptimizedLSTMCell(context_dim, hidden_dim, rngs=rngs),
            )
            self.output_layer = nnx.Linear(hidden_dim + S, S * S, rngs=rngs)
        elif model_type == "transformer":
            # Attention wants a lane-friendly model dim; project context up.
            self.in_proj = nnx.Linear(context_dim, hidden_dim, rngs=rngs)
            self.blocks = nnx.List(
                _TransformerBlock(hidden_dim, num_heads, hidden_dim, dropout, rngs)
                for _ in range(num_transformer_layers)
            )
            self.output_layer = nnx.Linear(hidden_dim + S, S * S, rngs=rngs)
        else:
            raise ValueError(f"Unknown model_type: {model_type}")

    def transition_logits(
        self,
        context: jax.Array,
        current_state: Optional[jax.Array] = None,
    ) -> jax.Array:
        """Raw next-state logits ``(B, T, S, S)`` (pre-softmax)."""
        single = context.ndim == 2
        if single:
            context = context[:, None]
        B, T, _ = context.shape
        S = self.num_states
        det = not self.training

        if current_state is None:
            current_state = jnp.full((B, T, S), 1.0 / S, context.dtype)
        elif current_state.ndim == 2:
            current_state = current_state[:, None]

        if self.model_type == "mlp":
            logits = self.network(
                jnp.concatenate([context, current_state], -1),
                deterministic=det,
            )
        elif self.model_type == "rnn":
            h = self.rnn(context)
            logits = self.output_layer(
                jnp.concatenate([h, current_state], -1)
            )
        else:
            h = self.in_proj(context)
            for block in self.blocks:
                h = block(h, deterministic=det)
            logits = self.output_layer(
                jnp.concatenate([h, current_state], -1)
            )
        logits = _f32(logits).reshape(B, T, S, S)
        return logits[:, 0] if single else logits

    def __call__(
        self,
        context: jax.Array,
        current_state: Optional[jax.Array] = None,
    ) -> jax.Array:
        """Transition probabilities, softmax over the next-state axis
        (``neural.py:112-115``)."""
        return jax.nn.softmax(
            self.transition_logits(context, current_state), axis=-1
        )

    forward = __call__


class NeuralObservationModel(TrainMode):
    """Neural per-state observation scores (``neural.py:123-293``).

    A shared trunk (``feature_net``) embeds observations; a per-state
    embedding shifts the trunk features; a head (gaussian / mixture /
    autoregressive) scores the observation under each state.
    """

    def __init__(
        self,
        num_states: int,
        observation_dim: int,
        hidden_dim: int = 256,
        model_type: str = "gaussian",
        num_components: int = 3,
        dropout: float = 0.1,
        *,
        rngs: Optional[nnx.Rngs] = None,
    ):
        rngs = rngs or nnx.Rngs(0)
        self.num_states = num_states
        self.observation_dim = observation_dim
        self.hidden_dim = hidden_dim
        self.model_type = model_type
        self.num_components = num_components

        H, D, C = hidden_dim, observation_dim, num_components
        prec = matmul_precision()  # precision policy, see precision.py
        if model_type == "gaussian":
            self.mean_net = nnx.Linear(H, D, precision=prec, rngs=rngs)
            self.logvar_net = nnx.Linear(H, D, precision=prec, rngs=rngs)
        elif model_type == "mixture":
            self.weight_net = nnx.Linear(H, C, precision=prec, rngs=rngs)
            self.mean_net = nnx.Linear(
                H, C * D, precision=prec, rngs=rngs
            )
            self.logvar_net = nnx.Linear(
                H, C * D, precision=prec, rngs=rngs
            )
        elif model_type == "autoregressive":
            # Recurrent cell stays at backend default: its sequential
            # feedback is latency-bound, not multiply-bound.
            self.ar_net = nnx.RNN(
                nnx.OptimizedLSTMCell(D, H, rngs=rngs)
            )
            self.output_net = nnx.Linear(H, D, rngs=rngs)
        else:
            raise ValueError(f"Unknown model_type: {model_type}")

        self.state_embedding = nnx.Embed(num_states, H, rngs=rngs)
        self.fe1 = nnx.Linear(D, H, precision=prec, rngs=rngs)
        self.fe2 = nnx.Linear(H, H, precision=prec, rngs=rngs)
        self.drop = nnx.Dropout(dropout, rngs=rngs)

    def _trunk(self, observations: jax.Array) -> jax.Array:
        det = not self.training
        h = self.drop(jax.nn.relu(self.fe1(observations)), deterministic=det)
        return _f32(self.drop(jax.nn.relu(self.fe2(h)), deterministic=det))

    def _head_log_prob(self, feats: jax.Array, obs: jax.Array) -> jax.Array:
        """Score ``obs (..., D)`` given combined features ``(..., H)``."""
        D = self.observation_dim
        if self.model_type == "gaussian":
            mean = _f32(self.mean_net(feats))
            log_var = _f32(self.logvar_net(feats))
            return self._gaussian(obs, mean, log_var)
        if self.model_type == "mixture":
            C = self.num_components
            w = jax.nn.log_softmax(_f32(self.weight_net(feats)), axis=-1)
            mean = _f32(self.mean_net(feats)).reshape(
                *feats.shape[:-1], C, D
            )
            log_var = _f32(self.logvar_net(feats)).reshape(
                *feats.shape[:-1], C, D
            )
            comp = self._gaussian(obs[..., None, :], mean, log_var)
            return logsumexp(w + comp, axis=-1)
        raise AssertionError

    @staticmethod
    def _gaussian(x, mean, log_var):
        d = x.shape[-1]
        log_norm = -0.5 * (
            d * jnp.log(2.0 * jnp.pi) + jnp.sum(log_var, axis=-1)
        )
        mahal = jnp.sum((x - mean) ** 2 * jnp.exp(-log_var), axis=-1)
        return log_norm - 0.5 * mahal

    def log_probs(
        self,
        observations: jax.Array,
        state_indices: Optional[jax.Array] = None,
    ) -> jax.Array:
        """``(B, T, S)`` scores for all states, or ``(B, T)`` for given
        ``state_indices`` (``neural.py:183-208``)."""
        B, T, D = observations.shape

        if self.model_type == "autoregressive":
            # State-independent AR surrogate score (reference behavior:
            # the AR head ignores the state, neural.py:248-255).
            h = self.ar_net(observations)
            pred = self.output_net(h)
            mse = jnp.mean((pred - observations) ** 2, axis=-1)
            score = -mse  # (B, T)
            if state_indices is None:
                return jnp.broadcast_to(
                    score[..., None], (B, T, self.num_states)
                )
            return score

        obs_feats = self._trunk(observations)  # (B, T, H)
        if state_indices is None:
            return self._all_state_log_probs(obs_feats, observations)
        emb = self.state_embedding(state_indices)  # (B, T, H)
        return self._head_log_prob(obs_feats + emb, observations)

    def _all_state_log_probs(
        self, obs_feats: jax.Array, observations: jax.Array
    ) -> jax.Array:
        """``(B, T, S)`` head scores for every state without the
        ``(B, T, S, H)`` feature tensor the broadcast form materializes
        (~200 MB at the benchmark shape, plus S redundant head passes).

        The linear heads distribute over ``obs_feats + state_emb``:
        ``W(f + e) + b = (Wf + b) + We``, so per-state head outputs are
        a shared observation part plus a tiny per-state table. The
        quadratic runs in the CENTERED expanded form as matmuls —
        ``Σ(u' − m'_s)²·w·w_s = u'²w·w_s − 2(u'w)·(m'_s w_s) +
        w·(m'²_s w_s)`` as three ``(B·T, D) @ (D, S)`` dots — after
        shifting both ``u`` and ``m_s`` by the mean of the state means
        (exact; bounds the cross term so the expansion stays
        O(Mahalanobis distance), the same conditioning trick as
        ``emissions.fullcov_prepare``). The dots run at HIGHEST
        precision: true-f32 passes keep this path within ~1e-5 of the
        indexed path.
        """
        D = self.observation_dim
        S = self.num_states
        x = observations
        emb = self.state_embedding(jnp.arange(S))          # (S, H)
        hi = jax.lax.Precision.HIGHEST
        if self.model_type == "gaussian":
            mo = _f32(self.mean_net(obs_feats))            # (B,T,D) + bias
            lvo = _f32(self.logvar_net(obs_feats))
            ms = emb @ self.mean_net.kernel[...]           # (S,D), no bias
            lvs = emb @ self.logvar_net.kernel[...]
            center = jnp.mean(ms, axis=0)
            u = (x - mo) - center
            msc = ms - center
            wo = jnp.exp(-lvo)
            ws = jnp.exp(-lvs)                             # (S, D)
            uw = u * wo
            t_uu = jnp.einsum("btd,sd->bts", u * uw, ws, precision=hi)
            t_um = jnp.einsum("btd,sd->bts", uw, msc * ws, precision=hi)
            t_mm = jnp.einsum("btd,sd->bts", wo, msc * msc * ws,
                              precision=hi)
            # A true Mahalanobis distance is non-negative; clamp so
            # expansion rounding can never push log-probs above log_norm.
            mahal = jnp.maximum(t_uu - 2.0 * t_um + t_mm, 0.0)
            log_norm = -0.5 * (
                D * jnp.log(2.0 * jnp.pi)
                + jnp.sum(lvo, axis=-1, keepdims=True)
                + jnp.sum(lvs, axis=-1)[None, None]
            )
            return log_norm - 0.5 * mahal
        # mixture
        C = self.num_components
        B, T = x.shape[:2]
        w_log = jax.nn.log_softmax(
            _f32(self.weight_net(obs_feats))[:, :, None, :]
            + (emb @ self.weight_net.kernel[...])[None, None],
            axis=-1,
        )                                                  # (B, T, S, C)
        mo = _f32(self.mean_net(obs_feats)).reshape(B, T, C, D)
        lvo = _f32(self.logvar_net(obs_feats)).reshape(B, T, C, D)
        ms = (emb @ self.mean_net.kernel[...]).reshape(S, C, D)
        lvs = (emb @ self.logvar_net.kernel[...]).reshape(S, C, D)
        u = x[:, :, None, :] - mo                          # (B, T, C, D)
        wo = jnp.exp(-lvo)
        ws = jnp.exp(-lvs)                                 # (S, C, D)
        mahal = jnp.stack(
            [
                jnp.sum((u - ms[s]) ** 2 * wo * ws[s], axis=-1)
                for s in range(S)
            ],
            axis=2,
        )                                                  # (B, T, S, C)
        log_norm = -0.5 * (
            D * jnp.log(2.0 * jnp.pi)
            + jnp.sum(lvo, axis=-1)[:, :, None, :]         # (B, T, 1, C)
            + jnp.sum(lvs, axis=-1)[None, None]            # (S, C)
        )
        comp = log_norm - 0.5 * mahal                      # (B, T, S, C)
        return logsumexp(w_log + comp, axis=-1)

    def __call__(self, observations, state_indices=None):
        return self.log_probs(observations, state_indices)

    forward = __call__

    def sample(
        self,
        state_indices: jax.Array,
        key: Optional[jax.Array] = None,
    ) -> jax.Array:
        """Sample observations for a state sequence (gaussian head only,
        ``neural.py:272-293``)."""
        if self.model_type != "gaussian":
            raise NotImplementedError(
                f"sampling is implemented for the gaussian head only, "
                f"not {self.model_type!r}"
            )
        key = key if key is not None else jax.random.PRNGKey(0)
        emb = self.state_embedding(state_indices)
        mean = self.mean_net(emb)
        std = jnp.exp(0.5 * self.logvar_net(emb))
        return mean + std * jax.random.normal(key, mean.shape)


class NeuralHMM(TrainMode):
    """HMM with neural transition + observation models
    (``neural.py:296-519``). With ``context_dim == 0`` the transitions
    fall back to a learnable static matrix."""

    def __init__(
        self,
        num_states: int,
        observation_dim: int,
        context_dim: int = 0,
        hidden_dim: int = 256,
        transition_type: str = "mlp",
        observation_type: str = "gaussian",
        dropout: float = 0.1,
        *,
        rngs: Optional[nnx.Rngs] = None,
    ):
        rngs = rngs or nnx.Rngs(0)
        self.num_states = num_states
        self.observation_dim = observation_dim
        self.context_dim = context_dim

        if context_dim > 0:
            self.transition_model = NeuralTransitionModel(
                num_states=num_states,
                context_dim=context_dim,
                hidden_dim=hidden_dim,
                model_type=transition_type,
                dropout=dropout,
                rngs=rngs,
            )
        else:
            self.transition_model = None
        # The static fallback matrix always exists: calling a contextual
        # model without a context falls back to it (the reference raises
        # AttributeError in that case, neural.py:339-341 — a latent crash
        # we do not reproduce).
        self.transition_matrix = nnx.Param(
            jax.random.normal(rngs.params(), (num_states, num_states))
        )

        self.observation_model = NeuralObservationModel(
            num_states=num_states,
            observation_dim=observation_dim,
            hidden_dim=hidden_dim,
            model_type=observation_type,
            dropout=dropout,
            rngs=rngs,
        )
        self.initial_logits = nnx.Param(jnp.zeros((num_states,)))

    # -- parameter views ------------------------------------------------------
    def _log_transitions(
        self, context: Optional[jax.Array], B: int, T: int
    ) -> jax.Array:
        """Static ``(S, S)`` or time-varying ``(B, T, S, S)`` log
        transitions in the core kernels' convention (entry ``[:, t]``
        governs the step into frame ``t``)."""
        if self.transition_model is not None and context is not None:
            logits = self.transition_model.transition_logits(context)
            log_a = jax.nn.log_softmax(logits, axis=-1)
            # The reference applies the matrix computed at frame t-1 to the
            # step t-1 → t (neural.py:418-421); shift to core's layout.
            return jnp.concatenate([log_a[:, :1], log_a[:, :-1]], axis=1)
        return jax.nn.log_softmax(self.transition_matrix[...], axis=-1)

    def _log_pi(self) -> jax.Array:
        return jax.nn.log_softmax(self.initial_logits[...])

    # -- inference ------------------------------------------------------------
    def __call__(
        self,
        observations: jax.Array,
        context: Optional[jax.Array] = None,
        mesh=None,
    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """Forward-backward: ``(posteriors, forward, backward)`` in
        probability space, matching the reference's return convention
        (``neural.py:355-421``). With ``mesh`` (a ``(data, time)``
        ``jax.sharding.Mesh``), the recursions run on the block-parallel
        sharded layer — time-varying ``(B, T, S, S)`` transitions shard
        over the time axis like the observations, so long contexts scale
        across devices."""
        B, T, _ = observations.shape
        log_obs = self.observation_model.log_probs(observations)
        log_a = self._log_transitions(context, B, T)
        if mesh is not None:
            from ..parallel.sharded import sharded_forward_backward

            log_gamma, log_alpha, log_beta, _ = sharded_forward_backward(
                log_obs, log_a, self._log_pi(), mesh
            )
        else:
            log_gamma, log_alpha, log_beta, _ = auto_forward_backward(
                log_obs, log_a, self._log_pi()
            )
        return jnp.exp(log_gamma), jnp.exp(log_alpha), jnp.exp(log_beta)

    forward = __call__

    def viterbi_decode(
        self,
        observations: jax.Array,
        context: Optional[jax.Array] = None,
        mesh=None,
    ) -> Tuple[jax.Array, jax.Array]:
        """Best path + score with (possibly dynamic) transitions
        (``neural.py:463-511``); ``mesh`` routes through the sharded
        time-block decoder."""
        B, T, _ = observations.shape
        log_obs = self.observation_model.log_probs(observations)
        log_a = self._log_transitions(context, B, T)
        if mesh is not None:
            from ..parallel.sharded import sharded_viterbi

            return sharded_viterbi(log_obs, log_a, self._log_pi(), mesh)
        return auto_viterbi(log_obs, log_a, self._log_pi())

    def compute_likelihood(
        self,
        observations: jax.Array,
        context: Optional[jax.Array] = None,
        mesh=None,
    ) -> jax.Array:
        """Sequence log-likelihood ``(B,)`` — log-space end to end (the
        reference round-trips through probabilities, ``neural.py:513-519``).
        ``mesh`` distributes the forward recursion (differentiable, so
        sharded training losses work)."""
        B, T, _ = observations.shape
        log_obs = self.observation_model.log_probs(observations)
        log_a = self._log_transitions(context, B, T)
        if mesh is not None:
            from ..parallel.sharded import sharded_log_likelihood

            return sharded_log_likelihood(
                log_obs, log_a, self._log_pi(), mesh
            )
        return auto_log_likelihood(log_obs, log_a, self._log_pi())

    def compute_loss(
        self,
        observations: jax.Array,
        context: Optional[jax.Array] = None,
        mesh=None,
    ) -> jax.Array:
        return -jnp.mean(
            self.compute_likelihood(observations, context, mesh)
        )


class ContextualNeuralHMM(NeuralHMM):
    """NeuralHMM driven by phoneme + prosody context
    (``neural.py:522-588``)."""

    def __init__(
        self,
        num_states: int,
        observation_dim: int,
        phoneme_vocab_size: int,
        linguistic_context_dim: int = 64,
        prosody_dim: int = 16,
        *,
        rngs: Optional[nnx.Rngs] = None,
        **kwargs,
    ):
        rngs = rngs or nnx.Rngs(0)
        self.phoneme_vocab_size = phoneme_vocab_size
        self.linguistic_context_dim = linguistic_context_dim
        self.prosody_dim = prosody_dim
        super().__init__(
            num_states=num_states,
            observation_dim=observation_dim,
            context_dim=linguistic_context_dim + prosody_dim,
            rngs=rngs,
            **kwargs,
        )
        self.phoneme_embedding = nnx.Embed(
            phoneme_vocab_size, linguistic_context_dim, rngs=rngs
        )
        self.prosody_encoder = nnx.Linear(prosody_dim, prosody_dim, rngs=rngs)

    def encode_context(
        self, phoneme_sequence: jax.Array, prosody_features: jax.Array
    ) -> jax.Array:
        """``(B, T)`` phonemes + ``(B, T, P)`` prosody → ``(B, T, C)``
        context (``neural.py:553-580``)."""
        return jnp.concatenate(
            [
                self.phoneme_embedding(phoneme_sequence),
                self.prosody_encoder(prosody_features),
            ],
            axis=-1,
        )

    def forward_with_context(
        self,
        observations: jax.Array,
        phoneme_sequence: jax.Array,
        prosody_features: jax.Array,
    ):
        """(``neural.py:582-588``)."""
        context = self.encode_context(phoneme_sequence, prosody_features)
        return self(observations, context)
