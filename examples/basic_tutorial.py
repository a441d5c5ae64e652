"""Basic tutorial (reference: ``examples/basic_tutorial.py`` — 6 parts).

The same six-part arc as the reference tutorial, rebuilt for JAX: jit-compiled scans instead of per-frame Python loops,
first-class ragged ``lengths=`` instead of manual masking, and JAX
sharding instead of ``.to(device)``.

Run: python examples/basic_tutorial.py [--quick]
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
from flax import nnx

import pytorch_hmm_tpu as ph
from pytorch_hmm_tpu.profiling import device_time


def tutorial_1_basic_hmm():
    """Build an HMM, inspect its transition structure, run every core
    inference routine once (``basic_tutorial.py:40-100``)."""
    print("\n=== Tutorial 1: Basic HMM ===")
    num_states = 5
    P = ph.create_left_to_right_matrix(num_states, self_loop_prob=0.7)
    print("transition matrix (L2R, self-loop 0.7):")
    for row in np.asarray(P):
        print("   " + " ".join(f"{v:.3f}" for v in row))

    hmm = ph.HMM(P)
    obs = jax.nn.softmax(
        jax.random.normal(jax.random.PRNGKey(0), (2, 20, num_states)), -1
    )

    posteriors, alpha, beta = hmm.forward_backward(obs)
    print(f"posterior row sums (should be 1): "
          f"{np.asarray(posteriors.sum(-1))[0, :5].round(4)}")

    states, scores = hmm.viterbi_decode(obs)
    print(f"viterbi path head: {np.asarray(states)[0, :10]}")

    ll = hmm.compute_likelihood(obs)
    print(f"sequence log-likelihoods: {np.asarray(ll).round(2)}")

    sampled_obs, sampled_states = hmm.sample(
        seq_length=15, batch_size=1, key=jax.random.PRNGKey(1)
    )
    print(f"sampled path: {np.asarray(sampled_states)[0]}")
    return hmm, obs


def tutorial_2_fb_vs_viterbi():
    """Soft posteriors vs the single best path — and when they disagree
    (``basic_tutorial.py:103-170``)."""
    print("\n=== Tutorial 2: Forward-backward vs Viterbi ===")
    hmm = ph.HMM(ph.create_left_to_right_matrix(4, self_loop_prob=0.6))
    obs = jax.nn.softmax(
        2.0 * jax.random.normal(jax.random.PRNGKey(1), (30, 4)), -1
    )
    post, _, _ = hmm.forward_backward(obs)
    soft = jnp.argmax(post, axis=-1)
    hard, _ = hmm.viterbi_decode(obs)
    agree = float(jnp.mean((soft == hard).astype(jnp.float32)))
    print(f"posterior-argmax vs Viterbi agreement: {agree:.1%}")

    # Per-frame posterior entropy shows WHERE the model is uncertain —
    # exactly the frames where the two decodings can differ.
    entropy = -jnp.sum(post * jnp.log(post + 1e-10), axis=-1)
    uncertain = np.asarray(jnp.argsort(entropy)[-3:])
    print(f"most uncertain frames: {sorted(uncertain.tolist())} "
          f"(entropy up to {float(entropy.max()):.2f} nats)")
    print("use forward-backward for training (differentiable soft "
          "alignment), Viterbi for inference (consistent hard path)")


def tutorial_3_hmm_layer_training(quick: bool):
    """An HMMLayer as the alignment module inside a TTS-like network,
    trained end-to-end with optax (``basic_tutorial.py:172-300``)."""
    print("\n=== Tutorial 3: Training an HMMLayer inside a model ===")
    num_phones, feat_dim, hidden = 6, 24, 32

    class TTSAligner(nnx.Module):
        """Acoustic encoder -> per-phone probabilities -> HMM alignment."""

        def __init__(self, rngs):
            self.encoder = nnx.Sequential(
                nnx.Linear(feat_dim, hidden, rngs=rngs),
                nnx.relu,
                nnx.Linear(hidden, num_phones, rngs=rngs),
            )
            self.hmm = ph.HMMLayer(num_states=num_phones, rngs=rngs)

        def loss(self, mel):
            phone_probs = jax.nn.softmax(self.encoder(mel), -1)
            return self.hmm.compute_loss(phone_probs)

    model = TTSAligner(nnx.Rngs(0))
    data = jax.random.normal(jax.random.PRNGKey(2), (4, 40, feat_dim))

    graphdef, params, rest = nnx.split(model, nnx.Param, ...)
    tx = optax.adam(1e-2)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            return nnx.merge(graphdef, p, rest).loss(data)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    n_steps = 5 if quick else 30
    first = last = None
    for i in range(n_steps):
        params, opt_state, loss = step(params, opt_state)
        if first is None:
            first = float(loss)
        last = float(loss)
        if i % 5 == 0:
            print(f"  step {i}: NLL {float(loss):.4f}")
    print(f"NLL {first:.3f} -> {last:.3f} "
          f"(gradients flow through the full FB recursion)")


def tutorial_4_batch_processing(quick: bool):
    """Batched decode scales on-device; ragged batches use ``lengths=``
    instead of manual masking (``basic_tutorial.py:302-405``)."""
    print("\n=== Tutorial 4: Batch processing ===")
    num_states, T = 10, 50
    hmm = ph.HMM(ph.create_left_to_right_matrix(num_states))

    print(f"{'batch':>6} {'time (ms)':>10} {'frames/s':>12}")
    for B in (1, 8, 32) if quick else (1, 4, 8, 16, 32):
        obs = jax.nn.softmax(
            jax.random.normal(jax.random.PRNGKey(B), (B, T, num_states)), -1
        )
        t = device_time(lambda o: hmm.forward_backward(o)[0], obs,
                        reps=2 if quick else 5)
        rate = f"{B * T / t:12,.0f}" if t > 1e-6 else f"{'—':>12}"
        print(f"{B:>6} {t * 1e3:>10.3f} {rate}")

    # Ragged batches: pad to a common length and pass lengths — every
    # kernel (FB, Viterbi, HSMM, sharded) masks internally, so padded
    # results are EXACTLY the per-sequence unpadded results.
    lengths = jnp.asarray([20, 35, 28])
    obs = jax.nn.softmax(
        jax.random.normal(jax.random.PRNGKey(9), (3, 35, num_states)), -1
    )
    post_padded, _, _ = hmm.forward_backward(obs, lengths=lengths)
    post_single, _, _ = hmm.forward_backward(obs[0, :20])
    err = float(jnp.max(jnp.abs(post_padded[0, :20] - post_single)))
    print(f"ragged lengths {np.asarray(lengths)}: padded == unpadded "
          f"(max |diff| = {err:.2e})")


def tutorial_5_devices_and_sharding():
    """Device placement is JAX sharding over a mesh, not ``.to(device)``
    (replaces the reference's GPU tutorial, ``basic_tutorial.py:408-531``)."""
    print("\n=== Tutorial 5: Devices & sharding ===")
    print(f"backend: {jax.default_backend()}, devices: {jax.device_count()}")
    if jax.device_count() >= 2:
        from pytorch_hmm_tpu.parallel import make_mesh
        from pytorch_hmm_tpu.parallel.sharded import (
            sharded_forward_backward, sharded_viterbi,
        )
        K = 6
        rng = np.random.default_rng(0)
        la = jnp.log(jnp.asarray(rng.dirichlet(np.ones(K), size=K),
                                 jnp.float32))
        lp = jnp.log(jnp.full((K,), 1 / K))
        lo = jnp.asarray(rng.normal(size=(4, 64, K)), jnp.float32)

        # Data parallel: shard the batch axis.
        mesh_dp = make_mesh(data=2, time=1)
        states, score = sharded_viterbi(lo, la, lp, mesh_dp)
        print(f"batch-sharded Viterbi over 2 devices: {states.shape}")

        # Sequence parallel: shard TIME; boundary alpha/delta vectors move
        # between neighboring devices via collective-permute.
        mesh_sp = make_mesh(data=1, time=2)
        post, *_ = sharded_forward_backward(lo, la, lp, mesh_sp)
        print(f"time-sharded forward-backward over 2 devices: {post.shape}")
        print("both are bit-exact vs single-device (see tests/test_parallel.py)")
    else:
        print("single device — rerun under "
              "XLA_FLAGS=--xla_force_host_platform_device_count=8 "
              "to try the mesh demos")


def tutorial_6_real_world(quick: bool):
    """Forced alignment for a TTS front-end, end to end: synthesize an
    utterance with known segmentation, recover it, evaluate
    (``basic_tutorial.py:534-714``)."""
    print("\n=== Tutorial 6: Forced alignment pipeline ===")
    num_phones, feat_dim = 5, 20
    key = jax.random.PRNGKey(7)

    # Ground truth: phones 0..4 with known durations.
    true_durations = np.array([12, 20, 8, 25, 15])
    true_path = np.repeat(np.arange(num_phones), true_durations)
    T = int(true_durations.sum())

    # Synthetic acoustics: each phone has a distinct mean vector.
    k1, k2 = jax.random.split(key)
    phone_means = 3.0 * jax.random.normal(k1, (num_phones, feat_dim))
    mel = phone_means[true_path] + 0.5 * jax.random.normal(k2, (T, feat_dim))

    # A Gaussian phoneme model whose means match -> alignment recovers
    # the segmentation. (In practice the means come from training.)
    model = ph.GaussianHMMLayer(num_phones, feat_dim, rngs=nnx.Rngs(0))
    model.means[...] = phone_means
    model.eval()

    log_obs = model._compute_gaussian_log_probs(mel[None])
    hmm = ph.HMM(ph.create_left_to_right_matrix(num_phones,
                                                self_loop_prob=0.9))
    path, score = hmm.viterbi_decode(jnp.exp(
        jax.nn.log_softmax(log_obs[0], -1)
    ))

    pred_durations = np.asarray(ph.compute_state_durations(path))
    print(f"true durations: {true_durations.tolist()}")
    print(f"recovered     : {pred_durations.tolist()}")

    acc = ph.alignment_accuracy(path, jnp.asarray(true_path), tolerance=2)
    path_np = np.asarray(path)
    bnd = ph.boundary_accuracy(
        jnp.asarray(np.flatnonzero(np.diff(path_np)) + 1),
        jnp.asarray(np.cumsum(true_durations)[:-1]),
        tolerance=3,
    )
    dur = ph.duration_accuracy(
        jnp.asarray(pred_durations, jnp.float32),
        jnp.asarray(true_durations, jnp.float32),
    )
    print(f"frame accuracy (±2): {float(acc):.1%}; "
          f"boundary F1 (±3): {float(bnd['f1']):.2f}; "
          f"duration MAE: {float(dur['mae']):.2f} frames")


def main(quick: bool = False):
    tutorial_1_basic_hmm()
    tutorial_2_fb_vs_viterbi()
    tutorial_3_hmm_layer_training(quick)
    tutorial_4_batch_processing(quick)
    tutorial_5_devices_and_sharding()
    tutorial_6_real_world(quick)
    print("\nAll tutorials finished.")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true")
    main(parser.parse_args().quick)
