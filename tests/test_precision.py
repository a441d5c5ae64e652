"""Mixed precision + checkpointing flags must be LIVE (VERDICT r2 item 2).

The reference declares USE_MIXED_PRECISION / USE_CHECKPOINTING and never
reads them (reference ``__init__.py:198-205``); here they change compiled
dtypes / remat structure, and the bf16 path agrees with f32 within the
documented bounds (precision.py docstring).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pytorch_hmm_tpu as ph
from pytorch_hmm_tpu import precision
from pytorch_hmm_tpu.emissions import (
    diag_gaussian_log_probs,
    full_gaussian_log_probs,
    gmm_log_probs,
)


@pytest.fixture(autouse=True)
def _restore_flags():
    mp, cp = (precision.mixed_precision_enabled(),
              precision.checkpointing_enabled())
    yield
    precision.set_mixed_precision(mp)
    precision.set_checkpointing(cp)


def _problem(seed=0, B=2, T=32, S=6, C=3, D=16):
    rng = np.random.default_rng(seed)
    obs = jnp.asarray(rng.normal(size=(B, T, D)), jnp.float32)
    means = jnp.asarray(rng.normal(size=(S, C, D)), jnp.float32)
    log_vars = jnp.asarray(rng.normal(size=(S, C, D)) * 0.1, jnp.float32)
    logits = jnp.asarray(rng.normal(size=(S, C)), jnp.float32)
    return obs, means, log_vars, logits


class TestComputeDtypePolicy:
    def test_override_wins(self):
        assert precision.compute_dtype(jnp.bfloat16) == jnp.bfloat16
        assert precision.compute_dtype(jnp.float32) == jnp.float32

    def test_cpu_resolves_f32_even_when_enabled(self):
        precision.set_mixed_precision(True)
        # Tests run on the CPU backend (conftest): no bf16 MXU there.
        assert precision.compute_dtype() == jnp.float32

    def test_gpu_resolves_f32_either_way(self, monkeypatch):
        # The flag picks the multiply precision (TF32 or HIGHEST on the
        # GPU), never the operand dtype.
        monkeypatch.setattr(
            precision.jax, "default_backend", lambda: "gpu"
        )
        precision.set_mixed_precision(True)
        assert precision.compute_dtype() == jnp.float32
        precision.set_mixed_precision(False)
        assert precision.compute_dtype() == jnp.float32

    def test_config_delegates(self):
        ph.config.USE_MIXED_PRECISION = False
        assert precision.mixed_precision_enabled() is False
        ph.config.set_precision(True)
        assert ph.config.USE_MIXED_PRECISION is True
        ph.config.USE_CHECKPOINTING = False
        assert precision.checkpointing_enabled() is False
        ph.config.USE_CHECKPOINTING = True
        info = ph.config.get_info()
        assert info["mixed_precision"] is True
        assert info["checkpointing"] is True


class TestBf16CompiledDtype:
    def test_flag_changes_compiled_precision(self, monkeypatch):
        """Flag ON → contractions at backend-default precision (TF32 on
        the GPU); OFF → Precision.HIGHEST (true f32) appears in the
        compiled program."""
        obs, means, log_vars, logits = _problem()

        def make_fn():
            # Fresh function object per flag state: jax caches traces by
            # function identity, which would mask the flag flip.
            def fn(o):
                return gmm_log_probs(o, means, log_vars, logits, "diag")
            return fn

        precision.set_mixed_precision(True)
        assert "HIGHEST" not in str(jax.make_jaxpr(make_fn())(obs))
        precision.set_mixed_precision(False)
        assert "HIGHEST" in str(jax.make_jaxpr(make_fn())(obs))

    def test_explicit_bf16_casts_operands(self):
        obs, means, log_vars, logits = _problem()

        def fn(o):
            return gmm_log_probs(
                o, means, log_vars, logits, "diag",
                compute_dtype=jnp.bfloat16,
            )

        assert "bf16" in str(jax.make_jaxpr(fn)(obs))

    def test_output_stays_f32(self):
        obs, means, log_vars, logits = _problem()
        out = gmm_log_probs(
            obs, means, log_vars, logits, "diag",
            compute_dtype=jnp.bfloat16,
        )
        assert out.dtype == jnp.float32


class TestBf16Parity:
    @pytest.mark.parametrize("cov", ["diag", "tied", "spherical", "full"])
    def test_gmm_scores_within_bounds(self, cov):
        """Documented bound: per-frame log-prob error O(0.1-0.5) abs at
        speech shapes; this small shape should sit well inside it."""
        obs, means, log_vars, logits = _problem(D=16)
        S, C, D = means.shape
        if cov == "tied":
            cov_params = jnp.zeros((D,))
        elif cov == "spherical":
            cov_params = log_vars[..., 0]
        elif cov == "full":
            from pytorch_hmm_tpu.emissions import flat_dim
            cov_params = jnp.zeros((S, C, flat_dim(D)))
            rows = jnp.asarray([i * (i + 1) // 2 + i for i in range(D)])
            cov_params = cov_params.at[..., rows].set(0.5413)
        else:
            cov_params = log_vars
        exact = gmm_log_probs(
            obs, means, cov_params, logits, cov, compute_dtype=jnp.float32
        )
        half = gmm_log_probs(
            obs, means, cov_params, logits, cov, compute_dtype=jnp.bfloat16
        )
        err = np.max(np.abs(np.asarray(exact) - np.asarray(half)))
        assert err < 0.5, f"{cov}: max abs log-prob error {err}"

    def test_viterbi_paths_mostly_agree(self):
        """bf16 emission scoring may flip genuinely ambiguous frames
        only; on a well-separated problem paths agree everywhere."""
        rng = np.random.default_rng(1)
        S, D, B, T = 5, 16, 3, 64
        means = jnp.asarray(rng.normal(size=(S, 1, D)) * 4.0, jnp.float32)
        log_vars = jnp.zeros((S, 1, D))
        logits = jnp.zeros((S, 1))
        states = rng.integers(0, S, size=(B, T))
        obs = jnp.asarray(
            np.asarray(means)[states, 0] + rng.normal(size=(B, T, D)) * 0.5,
            jnp.float32,
        )
        la = jnp.full((S, S), np.log(1.0 / S))
        lp = jnp.full((S,), np.log(1.0 / S))
        lo32 = gmm_log_probs(obs, means, log_vars, logits, "diag",
                             compute_dtype=jnp.float32)
        lo16 = gmm_log_probs(obs, means, log_vars, logits, "diag",
                             compute_dtype=jnp.bfloat16)
        p32, _ = ph.core.viterbi(lo32, la, lp)
        p16, _ = ph.core.viterbi(lo16, la, lp)
        agree = np.mean(np.asarray(p32) == np.asarray(p16))
        assert agree >= 0.99, agree


class TestFullGaussianBf16:
    def test_full_cov_parity(self):
        rng = np.random.default_rng(2)
        K, D, B, T = 4, 8, 2, 16
        obs = jnp.asarray(rng.normal(size=(B, T, D)), jnp.float32)
        means = jnp.asarray(rng.normal(size=(K, D)), jnp.float32)
        a = rng.normal(size=(K, D, D)) * 0.2
        cov = np.einsum("kde,kfe->kdf", a, a) + np.eye(D)
        chol = jnp.asarray(np.linalg.cholesky(cov), jnp.float32)
        exact = full_gaussian_log_probs(
            obs, means, chol, compute_dtype=jnp.float32
        )
        half = full_gaussian_log_probs(
            obs, means, chol, compute_dtype=jnp.bfloat16
        )
        err = np.max(np.abs(np.asarray(exact) - np.asarray(half)))
        assert err < 0.5, err


class TestCheckpointing:
    def test_remat_grads_match(self):
        """Remat must change memory structure, never values: gradients
        with the flag on and off are identical."""
        from flax import nnx

        model = ph.GaussianHMMLayer(4, 8, rngs=nnx.Rngs(0))
        obs = jax.random.normal(jax.random.PRNGKey(0), (2, 24, 8))
        graphdef, params = nnx.split(model)

        def loss(p):
            return nnx.merge(graphdef, p).compute_loss(obs)

        precision.set_checkpointing(True)
        g_on = jax.grad(lambda p: loss(p))(params)
        precision.set_checkpointing(False)
        g_off = jax.grad(lambda p: loss(p))(params)
        for a, b in zip(jax.tree.leaves(g_on), jax.tree.leaves(g_off)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)

    def test_remat_appears_in_jaxpr(self):
        x = jnp.ones((3, 4))

        def f(x):
            return jnp.sum(precision.maybe_remat(jnp.sin)(x) ** 2)

        precision.set_checkpointing(True)
        assert "remat" in str(jax.make_jaxpr(jax.grad(f))(x)).lower()
        precision.set_checkpointing(False)
        assert "remat" not in str(jax.make_jaxpr(jax.grad(f))(x)).lower()


class TestNeuralMixedPrecision:
    def test_neural_nets_bind_precision_at_construction(self):
        from flax import nnx

        precision.set_mixed_precision(True)
        m = ph.NeuralObservationModel(3, 8, hidden_dim=16, rngs=nnx.Rngs(0))
        assert m.fe1.precision is None  # backend default (TF32 on the GPU)
        obs = jax.random.normal(jax.random.PRNGKey(0), (2, 12, 8))
        out = m.log_probs(obs)
        # scoring boundary: DP input stays f32, values finite
        assert out.dtype == jnp.float32
        assert np.isfinite(np.asarray(out)).all()

        precision.set_mixed_precision(False)
        m32 = ph.NeuralObservationModel(3, 8, hidden_dim=16,
                                        rngs=nnx.Rngs(0))
        assert m32.fe1.precision == jax.lax.Precision.HIGHEST
        out32 = m32.log_probs(obs)
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(out32), atol=0.5
        )
