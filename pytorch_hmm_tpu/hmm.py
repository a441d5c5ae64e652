"""User-facing HMM class — parity surface for reference ``HMM``/``HMMPyTorch``.

The reference splits a parameter container (``hmm.py:7-55``) from a torch
implementation subclass (``HMMPyTorch``, ``hmm.py:58-254``). Here one class
covers both: it is a frozen pytree (usable directly inside ``jax.jit`` /
``shard_map``) whose methods delegate to the shared scan kernels in
``pytorch_hmm_tpu.core``.

Behavioral parity notes (what matches the reference):

* ``P`` is row-normalized on construction (``hmm.py:39``).
* ``p0`` defaults to uniform (``hmm.py:45-55``).
* ``forward_backward``/``viterbi_decode``/``compute_likelihood`` accept
  per-state observation **probabilities** (log is taken internally with a
  1e-8 epsilon, ``hmm.py:42,86``), shaped ``(T, K)`` or ``(B, T, K)``, and
  unbatched inputs get unbatched outputs.
* ``sample`` returns one-hot observations + integer paths.

What deliberately differs:

* ``compute_likelihood`` stays in log space end-to-end instead of the
  reference's ``log(exp(...))`` round-trip (``hmm.py:203-206``) — same
  mathematical value, without the overflow hazard.
* There is no ``.to(device)`` — placement is JAX sharding's job.
"""

from __future__ import annotations

from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from . import core
from .core.semiring import safe_log

__all__ = ["HMM", "HMMJax", "HMMPyTorch"]

ArrayLike = Union[np.ndarray, jax.Array, list]


@jax.tree_util.register_pytree_node_class
class HMM:
    """Hidden Markov model with fixed parameters.

    Args:
        P: ``(K, K)`` transition matrix (row-stochastic; renormalized here).
        p0: ``(K,)`` initial state probabilities (uniform if ``None``).
    """

    def __init__(self, P: ArrayLike, p0: Optional[ArrayLike] = None,
                 dtype=jnp.float32):
        P = jnp.asarray(P, dtype=dtype)
        if P.ndim != 2 or P.shape[0] != P.shape[1]:
            raise ValueError(f"P must be a square matrix, got {P.shape}")
        self.P = P / jnp.sum(P, axis=-1, keepdims=True)
        if p0 is None:
            k = P.shape[0]
            self.p0 = jnp.full((k,), 1.0 / k, dtype=dtype)
        else:
            self.p0 = jnp.asarray(p0, dtype=dtype)
            self.p0 = self.p0 / jnp.sum(self.p0)

    # -- pytree protocol ----------------------------------------------------
    def tree_flatten(self):
        return (self.P, self.p0), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.P, obj.p0 = children
        return obj

    # -- derived quantities --------------------------------------------------
    @property
    def num_states(self) -> int:
        return self.P.shape[-1]

    @property
    def log_P(self) -> jax.Array:
        return safe_log(self.P)

    @property
    def log_p0(self) -> jax.Array:
        return safe_log(self.p0)

    # -- inference ------------------------------------------------------------
    @staticmethod
    def _batched(observations: jax.Array) -> tuple[jax.Array, bool]:
        obs = jnp.asarray(observations)
        if obs.ndim == 2:
            return obs[None], False
        if obs.ndim == 3:
            return obs, True
        raise ValueError(f"observations must be (T,K) or (B,T,K), got {obs.shape}")

    def forward_backward(self, observations: ArrayLike, method: str = "scan",
                         lengths: Optional[ArrayLike] = None):
        """Posteriors from per-state observation probabilities.

        Returns ``(posterior, alpha, beta)`` in probability space with the
        input's batchedness, mirroring ``HMMPyTorch.forward_backward``
        (``hmm.py:66-130``). ``alpha``/``beta`` are exponentiated log values
        (unnormalized, like the reference's log-space tables exp'd).
        ``lengths`` (B,) marks ragged batches: padded frames get zero
        posteriors and results match per-sequence unpadded calls exactly.
        """
        obs, batched = self._batched(observations)
        log_obs = safe_log(obs)
        lengths = None if lengths is None else jnp.asarray(lengths)
        if method == "scan":
            # The trellis kernel on the GPU, the core scans elsewhere.
            from .ops import auto_forward_backward

            log_gamma, log_alpha, log_beta, _ = auto_forward_backward(
                log_obs, self.log_P, self.log_p0, lengths
            )
        else:
            log_gamma, log_alpha, log_beta, _ = core.forward_backward(
                log_obs, self.log_P, self.log_p0, method=method,
                lengths=lengths,
            )
        out = (jnp.exp(log_gamma), jnp.exp(log_alpha), jnp.exp(log_beta))
        if lengths is not None:
            # The kernels freeze the carry past each row's length; the
            # user-facing convention is zero posteriors on padding.
            valid = (jnp.arange(obs.shape[1])[None, :]
                     < lengths[:, None])[..., None]
            out = tuple(jnp.where(valid, o, 0.0) for o in out)
        if not batched:
            out = tuple(o[0] for o in out)
        return out

    def viterbi_decode(self, observations: ArrayLike, method: str = "scan",
                       lengths: Optional[ArrayLike] = None):
        """Best path + its log score (``hmm.py:132-184``).

        ``method``: ``scan`` (sequential, default) | ``associative``
        (O(log T) depth) | ``blocked`` (single-chip time-block parallel)
        — all exact. ``lengths`` (B,) marks ragged batches (padded frames
        repeat each row's final valid state).
        """
        obs, batched = self._batched(observations)
        log_obs = safe_log(obs)
        lengths = None if lengths is None else jnp.asarray(lengths)
        if method == "associative":
            states, score = core.viterbi_associative(
                log_obs, self.log_P, self.log_p0, lengths=lengths
            )
        elif method == "blocked":
            from .core.viterbi import viterbi_blocked

            states, score = viterbi_blocked(log_obs, self.log_P, self.log_p0,
                                            lengths=lengths)
        else:
            states, score = core.viterbi(log_obs, self.log_P, self.log_p0,
                                         lengths=lengths)
        if not batched:
            return states[0], score[0]
        return states, score

    def compute_likelihood(self, observations: ArrayLike,
                           method: str = "scan",
                           lengths: Optional[ArrayLike] = None) -> jax.Array:
        """Sequence log-likelihood ``(B,)`` (or scalar if unbatched)."""
        obs, batched = self._batched(observations)
        ll = core.log_likelihood(
            safe_log(obs), self.log_P, self.log_p0, method=method,
            lengths=None if lengths is None else jnp.asarray(lengths),
        )
        return ll if batched else ll[0]

    def sample(self, seq_length: int, batch_size: int = 1,
               key: Optional[jax.Array] = None):
        """One-hot observations + state paths (``hmm.py:213-245``)."""
        if key is None:
            key = jax.random.PRNGKey(0)
        return core.sample_one_hot(key, self.log_P, self.log_p0,
                                   seq_length, batch_size)


# The reference exposes the torch implementation as ``HMMPyTorch``; users
# migrating can keep either spelling.
HMMJax = HMM
HMMPyTorch = HMM
