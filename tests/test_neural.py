"""Neural HMM family tests (reference coverage: test_integration.py:82-150)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import nnx

from pytorch_hmm_tpu import core
from pytorch_hmm_tpu.models import (
    ContextualNeuralHMM,
    NeuralHMM,
    NeuralObservationModel,
    NeuralTransitionModel,
)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    B, T, D, C = 2, 18, 6, 5
    obs = jnp.asarray(rng.normal(size=(B, T, D)), jnp.float32)
    ctx = jnp.asarray(rng.normal(size=(B, T, C)), jnp.float32)
    return obs, ctx


@pytest.mark.parametrize("mt", ["mlp", "rnn", "transformer"])
def test_neural_transitions_are_stochastic(data, mt):
    obs, ctx = data
    m = NeuralTransitionModel(4, ctx.shape[-1], hidden_dim=32,
                              model_type=mt, rngs=nnx.Rngs(0)).eval()
    P = m(ctx)
    assert P.shape == (*ctx.shape[:2], 4, 4)
    assert np.allclose(np.asarray(P).sum(-1), 1.0, atol=1e-5)
    P1 = m(ctx[:, 0])  # single-timestep input path
    assert P1.shape == (ctx.shape[0], 4, 4)


def test_neural_transition_unknown_type():
    with pytest.raises(ValueError, match="banana"):
        NeuralTransitionModel(4, 5, model_type="banana", rngs=nnx.Rngs(0))


@pytest.mark.parametrize("ot", ["gaussian", "mixture", "autoregressive"])
def test_neural_observation_scores(data, ot):
    obs, _ = data
    m = NeuralObservationModel(4, obs.shape[-1], hidden_dim=32,
                               model_type=ot, rngs=nnx.Rngs(0)).eval()
    lp = m(obs)
    assert lp.shape == (*obs.shape[:2], 4)
    assert np.isfinite(np.asarray(lp)).all()
    lp1 = m(obs, jnp.ones(obs.shape[:2], jnp.int32))
    assert lp1.shape == obs.shape[:2]
    if ot != "autoregressive":
        # per-state scoring must agree with the all-state table
        np.testing.assert_allclose(
            np.asarray(lp1), np.asarray(lp[..., 1]), atol=1e-5
        )


def test_neural_observation_sampling(data):
    obs, _ = data
    m = NeuralObservationModel(4, obs.shape[-1], hidden_dim=32,
                               rngs=nnx.Rngs(0)).eval()
    s = m.sample(jnp.zeros((2, 10), jnp.int32), key=jax.random.PRNGKey(0))
    assert s.shape == (2, 10, obs.shape[-1])


def test_neural_hmm_static_matches_core(data):
    """With no context the NeuralHMM is an ordinary HMM; its posteriors
    must agree with running core.forward_backward manually."""
    obs, _ = data
    m = NeuralHMM(4, obs.shape[-1], context_dim=0, hidden_dim=32,
                  rngs=nnx.Rngs(0)).eval()
    post, fwd, bwd = m(obs)
    assert np.allclose(np.asarray(post).sum(-1), 1.0, atol=1e-4)
    log_obs = m.observation_model.log_probs(obs)
    log_a = jax.nn.log_softmax(m.transition_matrix[...], axis=-1)
    log_gamma, *_ = core.forward_backward(log_obs, log_a, m._log_pi())
    np.testing.assert_allclose(np.asarray(post), np.exp(log_gamma), atol=1e-4)


def test_neural_hmm_dynamic_transitions(data):
    obs, ctx = data
    m = NeuralHMM(4, obs.shape[-1], context_dim=ctx.shape[-1],
                  hidden_dim=32, rngs=nnx.Rngs(0)).eval()
    post, fwd, bwd = m(obs, ctx)
    assert np.allclose(np.asarray(post).sum(-1), 1.0, atol=1e-4)
    states, score = m.viterbi_decode(obs, ctx)
    assert states.shape == obs.shape[:2]
    ll = m.compute_likelihood(obs, ctx)
    assert (np.asarray(ll) >= np.asarray(score) - 1e-3).all()
    grads = nnx.grad(lambda mm: mm.compute_loss(obs, ctx))(m)
    assert any(float(jnp.abs(l).max()) > 0 for l in jax.tree.leaves(grads))


def test_contextual_neural_hmm(data):
    obs, _ = data
    m = ContextualNeuralHMM(
        4, obs.shape[-1], phoneme_vocab_size=11, linguistic_context_dim=8,
        prosody_dim=3, hidden_dim=32, rngs=nnx.Rngs(0),
    ).eval()
    rng = np.random.default_rng(0)
    ph = jnp.asarray(rng.integers(0, 11, size=obs.shape[:2]))
    pros = jnp.asarray(rng.normal(size=(*obs.shape[:2], 3)), jnp.float32)
    ctx = m.encode_context(ph, pros)
    assert ctx.shape == (*obs.shape[:2], 11)
    post, fwd, bwd = m.forward_with_context(obs, ph, pros)
    assert np.allclose(np.asarray(post).sum(-1), 1.0, atol=1e-4)


def test_gaussian_emission_all_states_matches_per_state_heads(data):
    """The all-states scoring (linear heads distributed over
    ``obs_feats + state_emb``) must equal scoring each state through the
    embedding-added head path."""
    from pytorch_hmm_tpu.models import NeuralObservationModel

    obs, _ = data
    m = NeuralObservationModel(
        5, obs.shape[-1], hidden_dim=64, model_type="gaussian",
        rngs=nnx.Rngs(3),
    ).eval()
    all_states = np.asarray(m.log_probs(obs))
    for s in range(5):
        idx = jnp.full(obs.shape[:2], s, jnp.int32)
        np.testing.assert_allclose(
            all_states[..., s], np.asarray(m.log_probs(obs, idx)),
            rtol=1e-4, atol=1e-4,
        )
