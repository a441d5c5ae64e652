"""Diagonal-Gaussian emission scoring (one augmented matmul) vs the direct
float64 log-density."""
import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_hmm_tpu import precision
from pytorch_hmm_tpu.emissions import diag_gaussian_log_probs


def _direct(obs, means, log_vars):
    x = np.asarray(obs, np.float64)[:, :, None, :]
    mu = np.asarray(means, np.float64)
    lv = np.asarray(log_vars, np.float64)
    D = x.shape[-1]
    return -0.5 * (D * np.log(2 * np.pi) + lv.sum(-1)
                   + ((x - mu) ** 2 * np.exp(-lv)).sum(-1))


@pytest.mark.parametrize("B,T,D,N", [(2, 100, 20, 12), (3, 257, 80, 48),
                                     (1, 33, 7, 5)])
def test_diag_gaussian_matches_direct_density(rng, B, T, D, N):
    obs = jnp.asarray(rng.normal(size=(B, T, D)), jnp.float32)
    means = jnp.asarray(rng.normal(size=(N, D)), jnp.float32)
    log_vars = jnp.asarray(0.3 * rng.normal(size=(N, D)), jnp.float32)
    got = diag_gaussian_log_probs(obs, means, log_vars, jnp.float32)
    want = _direct(obs, means, log_vars)
    # The expanded quadratic cancels x^2 against -2 x mu: float32 keeps
    # ~1e-6 of its terms' magnitude (~1e2 at D=80).
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-5)


def test_mixed_precision_flag_keeps_float32_on_the_cpu(rng):
    """The flag picks the multiply precision only; on the CPU both
    settings score in float32 and agree."""
    obs = jnp.asarray(rng.normal(size=(2, 30, 16)), jnp.float32)
    means = jnp.asarray(rng.normal(size=(6, 16)), jnp.float32)
    log_vars = jnp.asarray(0.1 * rng.normal(size=(6, 16)), jnp.float32)
    mp = precision.mixed_precision_enabled()
    try:
        precision.set_mixed_precision(True)
        on = diag_gaussian_log_probs(obs, means, log_vars)
        precision.set_mixed_precision(False)
        off = diag_gaussian_log_probs(obs, means, log_vars)
    finally:
        precision.set_mixed_precision(mp)
    assert on.dtype == off.dtype == jnp.float32
    np.testing.assert_allclose(on, off, atol=1e-4)
