"""DTW anti-diagonal wavefront + backtrace vs a cell-by-cell float32 oracle:
cost matrices, paths and tie order, Sakoe-Chiba bands, jit composition."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oracle import dtw as oracle_dtw
from pytorch_hmm_tpu.alignment.dtw import (
    _backtrace,
    _bandwidth_mask,
    _dtw_wavefront,
    compute_distance_matrix,
    compute_dtw_path,
    dtw_path_padded,
)


def _dist(n, m, seed):
    kx, ky = jax.random.split(jax.random.PRNGKey(seed))
    x = jax.random.normal(kx, (n, 7), jnp.float32)
    y = jax.random.normal(ky, (m, 7), jnp.float32)
    return compute_distance_matrix(x, y)


def _check(dist, pattern="symmetric"):
    cost0, path0 = oracle_dtw(np.asarray(dist), pattern)
    cost, choices = _dtw_wavefront(dist, pattern)
    np.testing.assert_array_equal(np.asarray(cost), cost0)
    pi, pj, length, final = dtw_path_padded(dist, pattern)
    L = int(length)
    assert L == len(path0)
    got = list(zip(np.asarray(pi)[-L:].tolist(), np.asarray(pj)[-L:].tolist()))
    assert got == path0
    assert float(final) == float(cost0[-1, -1])


@pytest.mark.parametrize("pattern", ["symmetric", "rabiner_juang"])
@pytest.mark.parametrize(
    "n,m", [(5, 9), (16, 16), (37, 23), (64, 128), (130, 40)]
)
def test_dtw_matches_oracle(n, m, pattern):
    _check(_dist(n, m, n + m), pattern)


def test_dtw_banded_inf():
    """INF-masked cells (Sakoe-Chiba band) propagate like the oracle's."""
    dist = _bandwidth_mask(_dist(40, 40, 3), bandwidth=6)
    assert np.isinf(np.asarray(dist)).any()
    _check(dist)


def test_dtw_path_padded_matches_host_path():
    dist = _dist(24, 30, 11)
    pi, pj, length, cost = dtw_path_padded(dist)
    hi, hj, hcost = compute_dtw_path(dist)
    L = int(length)
    np.testing.assert_array_equal(np.asarray(pi)[-L:], np.asarray(hi))
    np.testing.assert_array_equal(np.asarray(pj)[-L:], np.asarray(hj))
    rpi, rpj, rlen = _backtrace(_dtw_wavefront(dist)[1])
    np.testing.assert_array_equal(np.asarray(pi), np.asarray(rpi))
    assert int(rlen) == L


def test_dtw_path_padded_inside_jit():
    # Composes under jit (no host-side trimming).
    dist = _dist(16, 20, 5)

    @jax.jit
    def f(d):
        pi, pj, length, cost = dtw_path_padded(d)
        return pi.sum() + pj.sum() + length + cost

    assert np.isfinite(float(f(dist)))
