"""Regression tests for code-review findings (round 1 review)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import nnx

import pytorch_hmm_tpu as ph
from pytorch_hmm_tpu import core


def test_fb_associative_with_lengths_matches_scan():
    """Padded batches must be correct regardless of method (the
    associative path used to silently ignore `lengths`)."""
    rng = np.random.default_rng(0)
    B, T, K = 2, 16, 4
    lo = jnp.asarray(rng.normal(size=(B, T, K)), jnp.float32)
    la = jnp.asarray(np.log(rng.dirichlet(np.ones(K), size=K)), jnp.float32)
    lp = jnp.asarray(np.log(rng.dirichlet(np.ones(K))), jnp.float32)
    lengths = jnp.asarray([16, 9])
    out_scan = core.forward_backward(lo, la, lp, lengths=lengths)
    out_assoc = core.forward_backward(
        lo, la, lp, lengths=lengths, method="associative"
    )
    for a, b in zip(out_scan, out_assoc):
        np.testing.assert_allclose(a, b, atol=1e-4)
    # Valid frames of the short sequence must match an unpadded run.
    short = core.forward_backward(lo[1:, :9], la, lp)
    np.testing.assert_allclose(
        out_assoc[0][1, :9], short[0][0], atol=1e-4
    )


def test_contextual_neural_hmm_without_context():
    """A contextual model called without context must fall back to its
    static transitions, not crash (the reference AttributeErrors)."""
    m = ph.NeuralHMM(4, 6, context_dim=5, hidden_dim=16,
                     rngs=nnx.Rngs(0)).eval()
    obs = jax.random.normal(jax.random.PRNGKey(0), (2, 12, 6))
    post, fwd, bwd = m(obs)  # no context
    np.testing.assert_allclose(np.asarray(post).sum(-1), 1.0, atol=1e-4)
    ll = m.compute_likelihood(obs)
    assert np.isfinite(np.asarray(ll)).all()


def test_boundary_accuracy_multi_match():
    """One prediction near several references must not produce negative
    false positives or precision > 1."""
    out = ph.boundary_accuracy(
        jnp.asarray([5]), jnp.asarray([4, 6]), tolerance=2
    )
    assert 0.0 <= float(out["precision"]) <= 1.0
    assert int(out["false_positives"]) >= 0
    assert float(out["precision"]) == pytest.approx(1.0)
    assert float(out["recall"]) == pytest.approx(1.0)


def test_semi_markov_supervised_consistent_with_unsupervised():
    """Supervised scoring uses the same diagonal-masked transitions as
    the segment DP: self-transitions score -inf, and a valid
    segmentation never beats the marginal."""
    sm = ph.SemiMarkovHMM(3, 4, max_duration=6, rngs=nnx.Rngs(0))
    obs = jax.random.normal(jax.random.PRNGKey(1), (1, 12, 4))
    bad = sm(obs, jnp.asarray([[0, 0, 1]]), jnp.asarray([[4, 4, 4]]))
    assert float(bad["log_transition"][0]) < -1e20  # self-transition
    good = sm(obs, jnp.asarray([[0, 1, 2]]), jnp.asarray([[4, 4, 4]]))
    marginal = sm(obs)
    assert float(good["log_probability"][0]) <= float(
        marginal["log_probability"][0]
    ) + 1e-3


def test_hmm_loss_parts_rejects_segment_models():
    from pytorch_hmm_tpu.parallel import hmm_loss_parts

    hsmm = ph.HSMMLayer(3, 4, max_duration=5, rngs=nnx.Rngs(0))
    with pytest.raises(TypeError, match="segment"):
        hmm_loss_parts(hsmm, jnp.zeros((1, 8, 4)))


def test_ctc_empty_target_no_double_count():
    from pytorch_hmm_tpu.alignment import ctc_forward_algorithm

    T, B, C = 6, 1, 3
    lp = jax.nn.log_softmax(jnp.zeros((T, B, C)), axis=-1)
    targets = jnp.zeros((B, 2), jnp.int32)
    _, ll = ctc_forward_algorithm(
        lp, targets, jnp.asarray([T]), jnp.asarray([0])
    )
    # All-blank probability: (1/3)^T exactly — no +log 2.
    assert float(ll[0]) == pytest.approx(T * np.log(1 / 3), abs=1e-4)


def test_resize_beam_after_chunk_size_change():
    p = ph.StreamingHMMProcessor(
        5, 6, chunk_size=32, lookahead_frames=0, max_delay_frames=50,
        use_beam_search=True, beam_width=4, rngs=nnx.Rngs(0),
    )
    p.chunk_size = 16  # controller shrank the chunk
    p.beam_width = 5
    p._resize_beam()   # must not raise / mix history lengths
    assert p._beam_paths.shape[0] == 5
    r = p.process_chunk(np.zeros((16, 6), np.float32))
    assert r.status in ("decoded", "buffering")


def test_beam_hypotheses_are_distinct_states():
    """The beam must hold distinct states (per-state reduction), not W
    tied duplicates of the best state."""
    p = ph.StreamingHMMProcessor(
        6, 4, chunk_size=8, lookahead_frames=0, max_delay_frames=60,
        use_beam_search=True, beam_width=4, rngs=nnx.Rngs(0),
    )
    rng = np.random.default_rng(0)
    p.process_chunk(rng.normal(size=(8, 4)).astype(np.float32))
    states = np.asarray(p._beam_states)
    assert len(np.unique(states)) == len(states), states


def test_beam_finds_delayed_reward_path():
    """A path that is locally second-best but globally best must survive
    in the beam (it cannot with a collapsed width-1 beam)."""
    import jax.numpy as jnp
    from pytorch_hmm_tpu.streaming import _beam_step, _greedy_step

    S, T, W, H = 3, 4, 3, 16
    # Transitions: state1 -> state2 is mandatory for the big final reward.
    log_a = jnp.log(jnp.asarray([
        [0.98, 0.01, 0.01],
        [0.01, 0.01, 0.98],
        [0.01, 0.01, 0.98],
    ]))
    # Frame scores: state0 slightly better early; state2 hugely better at
    # the end, reachable only via state1 at t=1.
    lo = jnp.log(jnp.asarray([
        [0.5, 0.4, 0.1],
        [0.5, 0.4, 0.1],
        [0.1, 0.1, 0.8],
        [0.01, 0.01, 0.98],
    ]))
    scores0 = jnp.where(jnp.arange(W) < S, -jnp.log(float(S)), -jnp.inf)
    carry = (scores0, jnp.arange(W, dtype=jnp.int32) % S,
             jnp.zeros((W, H), jnp.int32), jnp.int32(0))
    (sc, ls, pt, pl), states_b, _ = _beam_step(
        log_a, lo, jnp.int32(T), carry
    )
    gcarry = (jnp.int32(0), jnp.bool_(False))
    _, states_g, _ = _greedy_step(log_a, lo, jnp.int32(T), gcarry)

    # Exact Viterbi for truth.
    from pytorch_hmm_tpu import core
    true_path, _ = core.viterbi(lo[None], log_a, jnp.full((S,), -jnp.log(float(S))))
    assert list(np.asarray(states_b)) == list(np.asarray(true_path[0])), (
        "beam (W=S) must recover the Viterbi path"
    )


def test_hsmm_em_respects_fixed_durations():
    m = ph.HSMMLayer(3, 4, max_duration=6,
                     learnable_duration_params=False, rngs=nnx.Rngs(0))
    before = np.asarray(m.duration_shape[...]).copy()
    obs = jax.random.normal(jax.random.PRNGKey(0), (1, 20, 4))
    m.em_step(obs)
    np.testing.assert_array_equal(np.asarray(m.duration_shape[...]), before)


def test_duration_model_out_of_grid_is_impossible():
    dm = ph.DurationModel(3, max_duration=5, rngs=nnx.Rngs(0))
    lp = dm(jnp.asarray([0, 1]), jnp.asarray([3, 9]))
    assert np.isfinite(float(lp[0]))
    assert np.isneginf(float(lp[1])), "duration 9 > max 5 must be -inf"


def test_semi_markov_sample_no_self_transitions():
    sm = ph.SemiMarkovHMM(3, 4, max_duration=6, rngs=nnx.Rngs(0))
    for seed in range(4):
        states, durs, obs = sm.sample(6, max_length=40,
                                      key=jax.random.PRNGKey(seed))
        s = np.asarray(states)
        assert (np.diff(s) != 0).all(), s
        # The model's own supervised forward must score its sample finite.
        res = sm(obs[None] if obs.ndim == 2 else obs,
                 states[None], durs[None]) if obs.shape[0] else None


def test_neural_sample_guard():
    m = ph.NeuralObservationModel(3, 4, model_type="mixture",
                                  rngs=nnx.Rngs(0))
    with pytest.raises(NotImplementedError, match="gaussian"):
        m.sample(jnp.zeros((1, 5), jnp.int32))
