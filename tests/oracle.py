"""Pure-NumPy float64 reference implementations (value-exact oracle).

The reference repo's tests are structural only (shapes, normalization,
monotonicity — SURVEY.md §4); we additionally pin values against these
tiny, obviously-correct sequential implementations.
"""

import numpy as np


def logsumexp(x, axis=None):
    m = np.max(x, axis=axis, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    out = np.log(np.sum(np.exp(x - m), axis=axis)) + np.squeeze(m, axis=axis)
    return out


def forward(log_obs, log_a, log_pi):
    """log_obs (T,K); log_a (K,K) or (T,K,K); returns (log_alpha, log_z)."""
    T, K = log_obs.shape
    la = np.zeros((T, K))
    la[0] = log_pi + log_obs[0]
    for t in range(1, T):
        a = log_a[t] if log_a.ndim == 3 else log_a
        la[t] = log_obs[t] + logsumexp(la[t - 1][:, None] + a, axis=0)
    return la, logsumexp(la[-1], axis=0)


def backward(log_obs, log_a):
    T, K = log_obs.shape
    lb = np.zeros((T, K))
    for t in range(T - 2, -1, -1):
        a = log_a[t + 1] if log_a.ndim == 3 else log_a
        lb[t] = logsumexp(a + (log_obs[t + 1] + lb[t + 1])[None, :], axis=1)
    return lb


def posteriors(log_obs, log_a, log_pi):
    la, lz = forward(log_obs, log_a, log_pi)
    lb = backward(log_obs, log_a)
    lg = la + lb
    lg = lg - logsumexp(lg, axis=1)[:, None]
    return np.exp(lg), la, lb, lz


def viterbi(log_obs, log_a, log_pi):
    T, K = log_obs.shape
    delta = np.zeros((T, K))
    psi = np.zeros((T, K), dtype=int)
    delta[0] = log_pi + log_obs[0]
    for t in range(1, T):
        a = log_a[t] if log_a.ndim == 3 else log_a
        scores = delta[t - 1][:, None] + a
        psi[t] = np.argmax(scores, axis=0)
        delta[t] = np.max(scores, axis=0) + log_obs[t]
    path = np.zeros(T, dtype=int)
    path[-1] = np.argmax(delta[-1])
    for t in range(T - 2, -1, -1):
        path[t] = psi[t + 1][path[t + 1]]
    return path, np.max(delta[-1])


def hsmm_brute(log_obs, log_a, log_pi, log_dur):
    """Every segmentation of ``T`` frames into (state, duration) segments,
    durations ``1..D``: returns ``(best path, best score, log Z, gamma)``.
    Tiny T only (the count grows exponentially)."""
    T, S = log_obs.shape
    D = log_dur.shape[1]

    def segmentations(t):
        if t == T:
            yield ()
            return
        for d in range(1, min(D, T - t) + 1):
            for s in range(S):
                for rest in segmentations(t + d):
                    yield ((s, d),) + rest

    scores, paths = [], []
    for seg in segmentations(0):
        score, t, prev, path = 0.0, 0, None, []
        for s, d in seg:
            score += log_pi[s] if prev is None else log_a[prev, s]
            score += log_dur[s, d - 1] + log_obs[t:t + d, s].sum()
            path += [s] * d
            t, prev = t + d, s
        scores.append(score)
        paths.append(path)
    scores = np.asarray(scores)
    paths = np.asarray(paths)
    lz = logsumexp(scores)
    w = np.exp(scores - lz)
    gamma = np.zeros((T, S))
    for s in range(S):
        gamma[:, s] = (w[:, None] * (paths == s)).sum(axis=0)
    best = int(np.argmax(scores))
    return paths[best], scores[best], lz, gamma


def dtw(dist, pattern="symmetric"):
    """Cell-by-cell DTW in float32 (the XLA wavefront's arithmetic and its
    tie order: diagonal, up, left). Returns ``(cost (N, M), path)`` with
    the path as a list of (i, j) from (0, 0) to (N-1, M-1)."""
    dist = np.asarray(dist, np.float32)
    N, M = dist.shape
    inf = np.float32(np.inf)
    cost = np.full((N, M), inf, np.float32)
    choice = np.zeros((N, M), np.int64)
    for i in range(N):
        for j in range(M):
            d = dist[i, j]
            if i == 0 and j == 0:
                cost[i, j] = d
                continue
            diag = cost[i - 1, j - 1] if i and j else inf
            up = cost[i - 1, j] if i else inf
            left = cost[i, j - 1] if j else inf
            if pattern == "rabiner_juang":
                cands = [diag + np.float32(2.0) * d, up + d, left + d]
            else:
                cands = [diag + d, up + d, left + d]
            k = int(np.argmin(cands))
            cost[i, j], choice[i, j] = cands[k], k
    path, i, j = [(N - 1, M - 1)], N - 1, M - 1
    while (i, j) != (0, 0):
        k = choice[i, j]
        i, j = (i - 1, j - 1) if k == 0 else (i - 1, j) if k == 1 else (i, j - 1)
        path.append((i, j))
    return cost, path[::-1]


def ctc_viterbi_brute(log_probs, target, blank=0):
    """Best frame labelling of ``log_probs (T, C)`` that collapses (merge
    repeats, drop blanks) to ``target``: ``(labels, score)``."""
    import itertools

    T, C = log_probs.shape
    best, best_score = None, -np.inf
    for labels in itertools.product(range(C), repeat=T):
        collapsed = [c for k, c in enumerate(labels)
                     if c != blank and (k == 0 or labels[k - 1] != c)]
        if collapsed != list(target):
            continue
        score = sum(log_probs[t, c] for t, c in enumerate(labels))
        if score > best_score:
            best, best_score = labels, score
    return np.asarray(best), best_score


def greedy_stream(log_a, log_obs, n_valid, prev, has):
    """Frame-greedy chunk decode: each frame takes the argmax of
    ``log_a[prev] + obs`` (uniform prior before the first valid frame).
    Returns ``(prev, has, states, scores)`` in float32."""
    log_a = np.asarray(log_a, np.float32)
    S = log_a.shape[0]
    states, scores = [], []
    for t, lo in enumerate(np.asarray(log_obs, np.float32)):
        sc = log_a[prev] + lo if has else lo - np.float32(np.log(S))
        s = int(np.argmax(sc))
        states.append(s)
        scores.append(sc[s])
        if t < n_valid:
            prev, has = s, True
    return prev, has, np.asarray(states), np.asarray(scores, np.float32)


def beam_stream(log_a, log_obs, n_valid, scores, last, paths, plen):
    """Fixed-width beam chunk decode with one best parent per state (ties
    to the lowest index, as argmax / top_k order them). Returns the raw
    carry ``(scores, last_states, paths, path_len)``."""
    log_a = np.asarray(log_a, np.float32)
    scores = np.asarray(scores, np.float32).copy()
    last = np.asarray(last).copy()
    paths = np.asarray(paths).copy()
    W, H = paths.shape
    for t, lo in enumerate(np.asarray(log_obs, np.float32)):
        if t >= n_valid:
            continue
        if plen == 0:
            table = scores[:, None] + lo[None, :]
        else:
            table = scores[:, None] + log_a[last] + lo[None, :]
        best = table.max(axis=0)
        parent = table.argmax(axis=0)
        new_state = np.argsort(-best, kind="stable")[:W]
        par = parent[new_state]
        paths = np.concatenate([paths[par][:, 1:], new_state[:, None]], 1)
        scores, last, plen = best[new_state], new_state, min(plen + 1, H)
    return scores, last, paths, plen
