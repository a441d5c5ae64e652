"""Transition-matrix toolbox and sequence utilities.

Functional parity with reference ``pytorch_hmm/utils.py`` (~20 functions +
1 module; see SURVEY.md §2.2 row 22), rebuilt vectorized: matrices are
assembled from index arithmetic (``arange``/``eye``/``where``) instead of
per-state Python loops, so every builder is jit-safe and can run on device
— including the time-varying prosody builder, which becomes a single
vectorized ``(T, K, K)`` computation instead of a Python loop over frames
(reference ``utils.py:739-787``).

Probability-space conventions match the reference: row-stochastic
matrices, 1e-8 epsilon in normalizations.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from flax import nnx

__all__ = [
    "create_transition_matrix",
    "create_left_to_right_matrix",
    "create_skip_state_matrix",
    "create_phoneme_aware_transitions",
    "create_hierarchical_transitions",
    "AdaptiveTransitionMatrix",
    "create_duration_constrained_matrix",
    "create_gaussian_observation_model",
    "gaussian_log_likelihood",
    "align_sequences",
    "compute_state_durations",
    "interpolate_features",
    "create_attention_based_transitions",
    "AttentionTransition",
    "optimize_transition_matrix",
    "validate_transition_matrix",
    "benchmark_transition_operations",
    "create_prosody_aware_transitions",
    "analyze_transition_patterns",
]

_EPS = 1e-8


def _normalize_rows(p: jax.Array) -> jax.Array:
    return p / (jnp.sum(p, axis=-1, keepdims=True) + _EPS)


# ---------------------------------------------------------------------------
# Matrix builders (reference utils.py:9-153)
# ---------------------------------------------------------------------------

def create_transition_matrix(
    num_states: int,
    transition_type: str = "ergodic",
    self_loop_prob: float = 0.5,
    forward_prob: float = 0.4,
    skip_prob: float = 0.1,
    dtype=jnp.float32,
) -> jax.Array:
    """Standard speech-HMM transition topologies (reference ``utils.py:9-77``).

    Types: ``ergodic`` (fully connected, boosted diagonal),
    ``left_to_right`` (Bakis), ``left_to_right_skip``, ``circular``.
    Rows are normalized to sum to 1.
    """
    k = num_states
    i = jnp.arange(k)[:, None]
    j = jnp.arange(k)[None, :]
    eye = (i == j).astype(dtype)
    nxt = (j == i + 1).astype(dtype)
    skip2 = (j == i + 2).astype(dtype)
    last = (i == k - 1).astype(dtype)

    if transition_type == "ergodic":
        p = jnp.ones((k, k), dtype) + jnp.eye(k, dtype=dtype) * self_loop_prob * k
    elif transition_type == "left_to_right":
        p = (1 - last) * (self_loop_prob * eye + forward_prob * nxt) + last * eye
    elif transition_type == "left_to_right_skip":
        can_skip = (i < k - 2).astype(dtype)
        non_last = 1 - last
        p = (
            non_last * (self_loop_prob * eye + forward_prob * nxt)
            + can_skip * skip_prob * skip2
            + last * eye
        )
    elif transition_type == "circular":
        circ = (j == (i + 1) % k).astype(dtype)
        p = self_loop_prob * eye + forward_prob * circ
    else:
        raise ValueError(f"Unknown transition_type: {transition_type}")

    return _normalize_rows(p)


def create_left_to_right_matrix(
    num_states: int, self_loop_prob: float = 0.7, dtype=jnp.float32
) -> jax.Array:
    """Bakis-model matrix, the common TTS topology (``utils.py:80-104``)."""
    return create_transition_matrix(
        num_states,
        "left_to_right",
        self_loop_prob=self_loop_prob,
        forward_prob=1.0 - self_loop_prob,
        dtype=dtype,
    )


def create_skip_state_matrix(
    num_states: int,
    self_loop_prob: float = 0.6,
    forward_prob: float = 0.3,
    skip_prob: float = 0.1,
    max_skip: int = 2,
    dtype=jnp.float32,
) -> jax.Array:
    """Skip-state topology for fast speech / elision (``utils.py:106-153``).

    Skip mass is split across skip distances 2..max_skip with weights
    proportional to 1/skip, matching the reference's weighting.
    """
    k = num_states
    i = jnp.arange(k)[:, None]
    j = jnp.arange(k)[None, :]
    dist = j - i
    non_last = i < k - 1

    skips = np.arange(2, max_skip + 1)
    w = (1.0 / skips) / np.sum(1.0 / skips) if len(skips) else skips
    skip_w = np.zeros(max(k, max_skip + 1))
    for s, ws in zip(skips, w):
        skip_w[s] = ws
    skip_w = jnp.asarray(skip_w[:k], dtype)

    p = jnp.where(non_last & (dist == 0), self_loop_prob, 0.0)
    p = jnp.where(non_last & (dist == 1), forward_prob, p)
    in_range = non_last & (dist >= 2) & (dist <= max_skip)
    p = jnp.where(in_range, skip_prob * skip_w[jnp.clip(dist, 0, k - 1)], p)
    p = jnp.where(~non_last & (dist == 0), 1.0, p)
    return _normalize_rows(p.astype(dtype))


def create_phoneme_aware_transitions(
    phoneme_durations: Sequence[float],
    duration_variance: float = 0.2,
    key: Optional[jax.Array] = None,
    dtype=jnp.float32,
) -> jax.Array:
    """Duration-informed L2R matrix (``utils.py:155-186``).

    Self-loop probability grows with expected phoneme duration; a
    per-phoneme Gaussian jitter (scaled by ``duration_variance``) models
    natural variability. RNG is an explicit JAX key (seed 0 by default)
    instead of the reference's global ``np.random``.
    """
    dur = jnp.asarray(phoneme_durations, dtype)
    n = dur.shape[0]
    base = jnp.clip(1.0 - 1.0 / jnp.maximum(dur, _EPS), 0.5, 0.9)
    if key is None:
        key = jax.random.PRNGKey(0)
    noise = jax.random.normal(key, (n,), dtype) * duration_variance * dur
    self_p = jnp.clip(base + noise, 0.3, 0.95)
    self_p = self_p.at[-1].set(1.0)

    p = jnp.diag(self_p)
    off = (1.0 - self_p[:-1])
    p = p + jnp.diag(off, k=1) if n > 1 else p
    return p.astype(dtype)


def create_hierarchical_transitions(
    word_boundaries: Sequence[int],
    syllable_boundaries: Sequence[int],
    phoneme_level_prob: float = 0.8,
    syllable_level_prob: float = 0.15,
    word_level_prob: float = 0.05,
    dtype=jnp.float32,
) -> jax.Array:
    """Phoneme/syllable/word hierarchy boosts (``utils.py:189-228``)."""
    n = int(max(max(word_boundaries), max(syllable_boundaries))) + 1
    i = np.arange(n)
    fwd = np.full(n, phoneme_level_prob)
    syl = np.isin(i, np.asarray(syllable_boundaries)) & (i < n - 1)
    wrd = np.isin(i, np.asarray(word_boundaries)) & (i < n - 1)
    fwd = fwd + syl * syllable_level_prob + wrd * word_level_prob

    p = np.zeros((n, n))
    p[i[:-1], i[:-1]] = 0.7
    p[i[:-1], i[:-1] + 1] = fwd[:-1]
    p[n - 1, n - 1] = 1.0
    return _normalize_rows(jnp.asarray(p, dtype))


class AdaptiveTransitionMatrix(nnx.Module):
    """Context-modulated learnable transition matrix (``utils.py:231-286``).

    A learnable base logit matrix plus a bounded (tanh) MLP modulation from
    a context vector (e.g. speaker embedding), combined in log space and
    re-normalized with softmax.
    """

    def __init__(self, num_states: int, context_dim: int = 128, *,
                 rngs: Optional[nnx.Rngs] = None):
        rngs = rngs or nnx.Rngs(0)
        self.num_states = num_states
        self.context_dim = context_dim
        self.base_transition_logits = nnx.Param(
            jax.random.normal(rngs.params(), (num_states, num_states)) * 0.1
        )
        self.fc1 = nnx.Linear(context_dim, 64, rngs=rngs)
        self.fc2 = nnx.Linear(64, num_states * num_states, rngs=rngs)

    def __call__(self, context: Optional[jax.Array] = None) -> jax.Array:
        base = jax.nn.softmax(self.base_transition_logits[...], axis=-1)
        if context is None:
            return base[None]
        mod = jnp.tanh(self.fc2(jax.nn.relu(self.fc1(context))))
        mod = mod.reshape(context.shape[0], self.num_states, self.num_states)
        logits = jnp.log(base + _EPS)[None] + 0.1 * mod
        return jax.nn.softmax(logits, axis=-1)


def create_duration_constrained_matrix(
    num_states: int,
    min_duration: int = 1,
    max_duration: Optional[int] = None,
    dtype=jnp.float32,
) -> jax.Array:
    """Expanded-state-space duration constraints (``utils.py:289-341``).

    Encodes min/max dwell time by expanding each state into
    ``max_duration`` sub-states — (state, dwell) pairs. This construction
    is the accelerator-friendly formulation of hard duration constraints
    (static shapes, a plain HMM afterwards), so we keep it exactly.
    Returns ``(num_states * max_duration, num_states * max_duration)``.
    """
    if max_duration is None:
        max_duration = min_duration * 3
    d = max_duration
    n = num_states * d
    p = np.zeros((n, n))

    s = np.repeat(np.arange(num_states), d)
    dd = np.tile(np.arange(d), num_states)
    idx = np.arange(n)

    below_min = dd < min_duration - 1
    mid = (~below_min) & (dd < d - 1)
    at_max = dd == d - 1

    # Forced dwell-advance below min duration.
    m = below_min & (dd < d - 1)
    p[idx[m], idx[m] + 1] = 1.0
    # Stay-in-state dwell advance, or hop to next phone (dwell resets).
    p[idx[mid], idx[mid] + 1] = 0.7
    hop = mid & (s < num_states - 1)
    p[idx[hop], (s[hop] + 1) * d] = 0.3
    # Forced exit at max duration.
    force = at_max & (s < num_states - 1)
    p[idx[force], (s[force] + 1) * d] = 1.0
    stay = at_max & (s == num_states - 1)
    p[idx[stay], idx[stay]] = 1.0

    return jnp.asarray(p, dtype)


# ---------------------------------------------------------------------------
# Gaussian observation utilities (utils.py:344-419)
# ---------------------------------------------------------------------------

def create_gaussian_observation_model(
    num_states: int,
    feature_dim: int,
    means: Optional[jax.Array] = None,
    covariances: Optional[jax.Array] = None,
    key: Optional[jax.Array] = None,
    dtype=jnp.float32,
) -> Tuple[jax.Array, jax.Array]:
    """Init (means, covariances) for per-state Gaussians (``utils.py:344-370``)."""
    if means is None:
        key = key if key is not None else jax.random.PRNGKey(0)
        means = jax.random.normal(key, (num_states, feature_dim), dtype)
    if covariances is None:
        covariances = jnp.broadcast_to(
            jnp.eye(feature_dim, dtype=dtype), (num_states, feature_dim, feature_dim)
        )
    return jnp.asarray(means, dtype), jnp.asarray(covariances, dtype)


def gaussian_log_likelihood(
    observations: jax.Array, means: jax.Array, covariances: jax.Array
) -> jax.Array:
    """Full-covariance Gaussian log-likelihoods ``(B, T, K)``.

    Reference loops over states with explicit ``inverse``/``det``
    (``utils.py:373-419``); here all K states are scored in one batched
    Cholesky + triangular solve — O(K D³) once plus O(B T K D²) solves, all
    batched matmuls.
    """
    obs = jnp.asarray(observations)
    squeeze = obs.ndim == 2
    if squeeze:
        obs = obs[None]
    B, T, D = obs.shape
    chol = jnp.linalg.cholesky(covariances)  # (K, D, D)
    diff = obs[:, :, None, :] - means[None, None]  # (B, T, K, D)
    # Whiten with the precomputed L^{-1} (one K-batched O(D³) solve)
    # instead of a (B, T, K)-batched triangular solve per frame: the
    # whitening becomes one matmul contraction, and broadcasting a (K,D,D)
    # solve against (B,T,K,D) batch dims is not supported anyway.
    from .emissions import tril_inverse
    from .precision import mxu_einsum
    inv_chol = tril_inverse(chol)  # (K, D, D)
    # Explicit f32 request: this is a general-purpose toolbox function
    # with no precision policy knob in its contract — always exact
    # (mixed precision applies to the model emission paths instead).
    y = mxu_einsum("kde,btke->btkd", inv_chol, diff, dtype=jnp.float32)
    mahal = jnp.sum(y * y, axis=-1)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
    ll = -0.5 * (D * jnp.log(2 * jnp.pi) + logdet)[None, None] - 0.5 * mahal
    return ll[0] if squeeze else ll


# ---------------------------------------------------------------------------
# Sequence utilities (utils.py:422-518)
# ---------------------------------------------------------------------------

def align_sequences(reference_states: jax.Array, observations: jax.Array, hmm):
    """Viterbi-align observations to a reference chain (``utils.py:422-444``)."""
    optimal_states, _ = hmm.viterbi_decode(observations)
    return optimal_states


def compute_state_durations(state_sequence: jax.Array) -> jax.Array:
    """Run lengths of each visited state segment (``utils.py:447-474``).

    Vectorized run-length encoding: boundary mask → segment ids →
    bincount. Output length is data-dependent, so this is a host-side
    utility (not jittable) like the reference.
    """
    seq = np.asarray(state_sequence)
    if seq.size == 0:
        return jnp.asarray([], dtype=jnp.int32)
    change = np.flatnonzero(seq[1:] != seq[:-1]) + 1
    bounds = np.concatenate([[0], change, [seq.size]])
    return jnp.asarray(np.diff(bounds), dtype=jnp.int32)


def interpolate_features(
    features: jax.Array,
    source_durations: jax.Array,
    target_durations: jax.Array,
) -> jax.Array:
    """Retime features to new per-state durations (``utils.py:477-518``).

    Each source segment is mean-pooled, then repeated to the target
    duration (the reference's behavior). Host-side (ragged output).
    """
    feats = np.asarray(features)
    src = np.asarray(source_durations).astype(int)
    tgt = np.asarray(target_durations).astype(int)
    seg_ends = np.cumsum(src)
    seg_starts = seg_ends - src
    pooled = np.stack(
        [feats[a:b].mean(axis=0) for a, b in zip(seg_starts, seg_ends)]
    )
    return jnp.asarray(np.repeat(pooled, tgt, axis=0), features.dtype)


# ---------------------------------------------------------------------------
# Attention / prosody builders (utils.py:523-589, 739-787)
# ---------------------------------------------------------------------------

class AttentionTransition(nnx.Module):
    """Self-attention-driven per-timestep transition matrices
    (``utils.py:523-589``): Q/K/V nets over a context sequence produce a
    (B, T, S, S) modulation added to learnable base logits in log space.
    """

    def __init__(self, num_states: int, attention_dim: int = 64, *,
                 rngs: Optional[nnx.Rngs] = None):
        rngs = rngs or nnx.Rngs(0)
        self.num_states = num_states
        self.attention_dim = attention_dim
        self.query_net = nnx.Linear(attention_dim, attention_dim, rngs=rngs)
        self.key_net = nnx.Linear(attention_dim, attention_dim, rngs=rngs)
        self.value_net = nnx.Linear(attention_dim, num_states * num_states, rngs=rngs)
        self.base_transitions = nnx.Param(
            jax.random.normal(rngs.params(), (num_states, num_states)) * 0.1
        )

    def __call__(self, context: jax.Array) -> jax.Array:
        B, T, _ = context.shape
        q = self.query_net(context)
        k = self.key_net(context)
        v = self.value_net(context)
        attn = jax.nn.softmax(
            jnp.einsum("btd,bsd->bts", q, k) / (self.attention_dim ** 0.5), axis=-1
        )
        dyn = jnp.einsum("bts,bsv->btv", attn, v).reshape(
            B, T, self.num_states, self.num_states
        )
        base = jax.nn.log_softmax(self.base_transitions[...], axis=-1)
        return jax.nn.softmax(base[None, None] + 0.1 * dyn, axis=-1)


def create_attention_based_transitions(
    num_states: int, attention_dim: int = 64, *, rngs: Optional[nnx.Rngs] = None
) -> AttentionTransition:
    """Factory matching the reference's closure-class API (``utils.py:523``)."""
    return AttentionTransition(num_states, attention_dim, rngs=rngs)


def create_prosody_aware_transitions(
    f0_contour: jax.Array, energy_contour: jax.Array, num_states: int
) -> jax.Array:
    """F0/energy-modulated per-frame matrices ``(T, K, K)``
    (``utils.py:739-787``), fully vectorized over time: rising F0 speeds up
    transitions (self-loop ×0.8, forward ×1.2), high energy boosts dwell
    (self-loop ×1.1).
    """
    f0 = jnp.asarray(f0_contour, jnp.float32)
    en = jnp.asarray(energy_contour, jnp.float32)
    f0n = (f0 - f0.mean()) / (f0.std() + _EPS)
    enn = (en - en.mean()) / (en.std() + _EPS)
    f0d = jnp.diff(f0n, prepend=f0n[:1])

    base = create_left_to_right_matrix(num_states)  # (K, K)
    k = num_states
    eye = jnp.eye(k)
    nxt = jnp.eye(k, k, 1)
    non_last = jnp.concatenate([jnp.ones(k - 1), jnp.zeros(1)])[:, None]

    rising = (f0d > 0.5).astype(jnp.float32)[:, None, None]
    loud = (enn > 1.0).astype(jnp.float32)[:, None, None]

    p = base[None] * (
        1.0
        + rising * non_last * (eye * -0.2 + nxt * 0.2)
        + loud * eye * 0.1
    )
    return p / jnp.sum(p, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# Analysis / validation (utils.py:592-734, 790-850)
# ---------------------------------------------------------------------------

def optimize_transition_matrix(
    transition_matrix: jax.Array,
    target_durations: Optional[Sequence[float]] = None,
    smoothness_weight: float = 0.1,
) -> jax.Array:
    """Nudge self-loops toward target dwell times (``utils.py:592-632``)."""
    p = jnp.asarray(transition_matrix)
    n = p.shape[0]
    if target_durations is not None:
        tgt = jnp.clip(
            1.0 - 1.0 / jnp.maximum(jnp.asarray(target_durations, p.dtype), 1.0),
            0.1, 0.95,
        )
        cur = jnp.diagonal(p)
        adj = (1 - smoothness_weight) * cur + smoothness_weight * tgt
        new = jnp.diag(adj)
        if n > 1:
            new = new + jnp.diag(1.0 - adj[:-1], k=1)
        new = new.at[n - 1, n - 1].set(1.0)
        if n > 1:
            # Last row keeps only its self-loop (matches reference branch).
            new = new.at[n - 1, :n - 1].set(0.0)
        p = new
    return _normalize_rows(p)


def validate_transition_matrix(
    transition_matrix: jax.Array, tolerance: float = 1e-6
) -> Dict[str, bool]:
    """Structural validity checks (``utils.py:635-677``): row sums,
    non-negativity, finiteness, L2R band pattern, reachability of the final
    state via matrix powers."""
    p = jnp.asarray(transition_matrix)
    n = p.shape[0]
    results = {
        "row_sums_valid": bool(jnp.all(jnp.abs(p.sum(axis=1) - 1.0) < tolerance)),
        "non_negative": bool(jnp.all(p >= 0)),
        "finite": bool(jnp.all(jnp.isfinite(p))),
        "left_to_right_pattern": bool(jnp.all(jnp.triu(p, k=2) == 0)),
    }
    reach = jnp.linalg.matrix_power(p, n)
    results["reachable_to_final"] = (
        bool(jnp.all(reach[:-1, -1] > tolerance)) if n > 1 else True
    )
    return results


def benchmark_transition_operations(
    num_states_list: List[int], num_trials: int = 100
) -> Dict[str, Dict[int, float]]:
    """Micro-benchmark of builder/matmul/softmax/validation ops
    (``utils.py:680-734``), with proper device synchronization."""
    import time

    results: Dict[str, Dict[int, float]] = {
        "matrix_creation": {},
        "matrix_multiplication": {},
        "softmax_normalization": {},
        "validation": {},
    }
    for k in num_states_list:
        t0 = time.perf_counter()
        for _ in range(num_trials):
            create_transition_matrix(k, "left_to_right").block_until_ready()
        results["matrix_creation"][k] = (time.perf_counter() - t0) / num_trials * 1e3

        p = create_transition_matrix(k, "left_to_right")
        mm = jax.jit(jnp.matmul)
        mm(p, p).block_until_ready()
        t0 = time.perf_counter()
        for _ in range(num_trials):
            mm(p, p).block_until_ready()
        results["matrix_multiplication"][k] = (
            (time.perf_counter() - t0) / num_trials * 1e3
        )

        logits = jax.random.normal(jax.random.PRNGKey(0), (k, k))
        sm = jax.jit(lambda x: jax.nn.softmax(x, axis=-1))
        sm(logits).block_until_ready()
        t0 = time.perf_counter()
        for _ in range(num_trials):
            sm(logits).block_until_ready()
        results["softmax_normalization"][k] = (
            (time.perf_counter() - t0) / num_trials * 1e3
        )

        t0 = time.perf_counter()
        for _ in range(num_trials):
            validate_transition_matrix(p)
        results["validation"][k] = (time.perf_counter() - t0) / num_trials * 1e3
    return results


def analyze_transition_patterns(
    state_sequences: List[jax.Array],
) -> Dict[str, float]:
    """Self-loop/forward/backward/skip statistics over decoded paths
    (``utils.py:790-850``), vectorized with numpy on host."""
    total = self_loops = fwd = bwd = skip = 0
    all_durations: list = []
    for seq in state_sequences:
        s = np.asarray(seq)
        if s.size < 2:
            continue
        all_durations.extend(np.asarray(compute_state_durations(s)).tolist())
        d = s[1:] - s[:-1]
        total += d.size
        self_loops += int(np.sum(d == 0))
        fwd += int(np.sum(d == 1))
        bwd += int(np.sum(d < 0))
        skip += int(np.sum(d > 1))

    if total > 0:
        stats = {
            "self_loop_ratio": self_loops / total,
            "forward_ratio": fwd / total,
            "backward_ratio": bwd / total,
            "skip_ratio": skip / total,
            "avg_duration": float(np.mean(all_durations)) if all_durations else 0.0,
            "std_duration": float(np.std(all_durations)) if all_durations else 0.0,
        }
    else:
        stats = {k: 0.0 for k in [
            "self_loop_ratio", "forward_ratio", "backward_ratio", "skip_ratio",
            "avg_duration", "std_duration",
        ]}
    stats.update({"total_transitions": total,
                  "total_sequences": len(state_sequences)})
    return stats
