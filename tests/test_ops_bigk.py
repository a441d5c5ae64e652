"""Large-state likelihood (K = 96..1024, above the trellis kernels' cap):
the XLA scan that serves it, against the float64 oracle, and the
batch-parallel sharded scoring path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oracle import forward as oracle_forward
from pytorch_hmm_tpu import ops
from pytorch_hmm_tpu.core import log_likelihood as core_ll


def _problem(rng, B, T, K):
    lo = jnp.asarray(rng.normal(size=(B, T, K)), jnp.float32)
    la = jax.nn.log_softmax(
        jnp.asarray(rng.normal(size=(K, K)), jnp.float32), axis=-1
    )
    lpi = jax.nn.log_softmax(jnp.asarray(rng.normal(size=(K,)), jnp.float32))
    return lo, la, lpi


@pytest.mark.parametrize("B,T,K", [(2, 24, 256), (2, 16, 512),
                                   (3, 40, 96), (1, 8, 1024)])
def test_large_k_likelihood_matches_oracle(rng, B, T, K):
    lo, la, lpi = _problem(rng, B, T, K)
    z = np.asarray(ops.auto_log_likelihood(lo, la, lpi))
    for b in range(B):
        _, ref = oracle_forward(np.asarray(lo[b], np.float64),
                                np.asarray(la, np.float64),
                                np.asarray(lpi, np.float64))
        np.testing.assert_allclose(z[b], ref, rtol=1e-5)


def test_large_k_goes_to_core_even_on_gpu(rng, monkeypatch):
    """Above ``TRELLIS_MAX_K`` the dispatch never calls a kernel."""
    def boom(*a, **k):
        raise AssertionError("kernel called above the cap")

    monkeypatch.setattr(ops.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(ops, "trellis_forward_backward", boom)
    lo, la, lpi = _problem(rng, 2, 10, ops.TRELLIS_MAX_K + 1)
    np.testing.assert_allclose(ops.auto_log_likelihood(lo, la, lpi),
                               core_ll(lo, la, lpi), rtol=1e-6)


def test_sharded_scoring_matches_core(rng):
    """``sharded_scoring_log_likelihood`` (batch over the data axis, no
    communication) equals the one-device likelihood at K=512."""
    from pytorch_hmm_tpu.parallel import (
        make_mesh, sharded_scoring_log_likelihood)

    mesh = make_mesh(data=4, time=1, devices=jax.devices()[:4])
    lo, la, lpi = _problem(rng, 8, 16, 512)
    z = sharded_scoring_log_likelihood(lo, la, lpi, mesh)
    np.testing.assert_allclose(z, core_ll(lo, la, lpi), rtol=1e-6)
