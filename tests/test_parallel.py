"""Sharded (data, time) mesh kernels must match single-device exactly.

Multi-device tests the reference cannot have (it has no distributed code;
SURVEY.md §2.3) — run on the virtual 8-device CPU platform from conftest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_hmm_tpu import core
from pytorch_hmm_tpu.parallel import (
    make_mesh,
    make_sharded_train_step,
    shard_batch,
    sharded_forward_backward,
    sharded_log_likelihood,
    sharded_viterbi,
)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    B, T, K = 8, 64, 5
    log_obs = jnp.asarray(rng.normal(size=(B, T, K)), jnp.float32)
    log_a = jnp.log(jnp.asarray(rng.dirichlet(np.ones(K), size=K), jnp.float32))
    log_pi = jnp.log(jnp.asarray(rng.dirichlet(np.ones(K)), jnp.float32))
    return log_obs, log_a, log_pi


MESHES = [(1, 8), (2, 4), (4, 2), (8, 1)]


@pytest.mark.parametrize("data,time", MESHES)
def test_sharded_forward_backward_matches(problem, data, time):
    log_obs, log_a, log_pi = problem
    mesh = make_mesh(data=data, time=time)
    lg, la, lb, lz = sharded_forward_backward(log_obs, log_a, log_pi, mesh)
    lg0, la0, lb0, lz0 = core.forward_backward(log_obs, log_a, log_pi)
    np.testing.assert_allclose(la, la0, atol=1e-4)
    np.testing.assert_allclose(lb, lb0, atol=1e-4)
    np.testing.assert_allclose(lg, lg0, atol=1e-4)
    np.testing.assert_allclose(lz, lz0, atol=1e-4)


@pytest.mark.parametrize("data,time", MESHES)
def test_sharded_viterbi_matches(problem, data, time):
    log_obs, log_a, log_pi = problem
    mesh = make_mesh(data=data, time=time)
    s, sc = sharded_viterbi(log_obs, log_a, log_pi, mesh)
    s0, sc0 = core.viterbi(log_obs, log_a, log_pi)
    assert bool(jnp.all(s == s0)), "sharded Viterbi path differs"
    np.testing.assert_allclose(sc, sc0, atol=1e-4)


def test_sharded_likelihood_gradient_matches(problem):
    log_obs, log_a, log_pi = problem
    mesh = make_mesh(data=2, time=4)
    g = jax.grad(
        lambda lo: jnp.sum(sharded_log_likelihood(lo, log_a, log_pi, mesh))
    )(log_obs)
    g0 = jax.grad(
        lambda lo: jnp.sum(core.log_likelihood(lo, log_a, log_pi))
    )(log_obs)
    np.testing.assert_allclose(g, g0, atol=1e-4)


def test_sharded_train_step_decreases_loss():
    import optax
    from flax import nnx
    from pytorch_hmm_tpu.models import MixtureGaussianHMMLayer

    mesh = make_mesh(data=2, time=4)
    model = MixtureGaussianHMMLayer(
        num_states=4, feature_dim=8, num_components=2, rngs=nnx.Rngs(0)
    )
    opt_state, step_fn, params, rest = make_sharded_train_step(
        model, optax.adam(5e-2), mesh
    )
    obs = shard_batch(
        mesh, jax.random.normal(jax.random.PRNGKey(1), (4, 32, 8))
    )
    losses = []
    for _ in range(5):
        params, opt_state, loss = step_fn(params, rest, opt_state, obs)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"


def test_graft_entry_dryrun():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    g.dryrun_multichip(8)


def test_sharded_em_matches_single_device():
    from flax import nnx
    from pytorch_hmm_tpu.models import MixtureGaussianHMMLayer

    rng = np.random.default_rng(17)
    obs = jnp.asarray(rng.normal(size=(4, 64, 6)), jnp.float32)
    m1 = MixtureGaussianHMMLayer(3, 6, 2, rngs=nnx.Rngs(0))
    m2 = MixtureGaussianHMMLayer(3, 6, 2, rngs=nnx.Rngs(0))
    mesh = make_mesh(data=2, time=4)
    lls1 = [float(m1.em_step(obs)) for _ in range(3)]
    lls2 = [
        float(m2.em_step(shard_batch(mesh, obs), mesh=mesh))
        for _ in range(3)
    ]
    np.testing.assert_allclose(lls1, lls2, atol=1e-2)
    np.testing.assert_allclose(
        np.asarray(m1.means[...]), np.asarray(m2.means[...]), atol=1e-3
    )
    assert lls1[-1] > lls1[0], "EM must improve the likelihood"


# ---------------------------------------------------------------------------
# Sharded HSMM (augmented-chain time-block decomposition)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hsmm_sharded_problem():
    from pytorch_hmm_tpu.core.hsmm import hsmm_forward  # noqa: F401

    rng = np.random.default_rng(17)
    B, T, S, D = 8, 64, 3, 5
    log_obs = jnp.asarray(rng.normal(size=(B, T, S)), jnp.float32)
    la = np.full((S, S), -1e30, np.float32)
    for i in range(S):
        cols = [j for j in range(S) if j != i]
        la[i, cols] = np.log(rng.dirichlet(np.ones(S - 1)))
    log_pi = jnp.log(
        jnp.asarray(rng.dirichlet(np.ones(S)), jnp.float32)
    )
    log_dur = jnp.log(
        jnp.asarray(rng.dirichlet(np.ones(D), size=S), jnp.float32)
    )
    return log_obs, jnp.asarray(la), log_pi, log_dur


@pytest.mark.parametrize("data,time", MESHES)
def test_sharded_hsmm_forward_matches(hsmm_sharded_problem, data, time):
    from pytorch_hmm_tpu.core.hsmm import hsmm_forward
    from pytorch_hmm_tpu.parallel import sharded_hsmm_forward

    lo, la, lp, ld = hsmm_sharded_problem
    mesh = make_mesh(data=data, time=time)
    stars, lz = sharded_hsmm_forward(lo, la, lp, ld, mesh)
    stars0, lz0 = hsmm_forward(lo, la, lp, ld)
    np.testing.assert_allclose(lz, lz0, atol=1e-4)
    np.testing.assert_allclose(stars, stars0, atol=1e-3)


@pytest.mark.parametrize("data,time", MESHES)
def test_sharded_hsmm_viterbi_matches(hsmm_sharded_problem, data, time):
    from pytorch_hmm_tpu.core.hsmm import hsmm_viterbi
    from pytorch_hmm_tpu.parallel import sharded_hsmm_viterbi

    lo, la, lp, ld = hsmm_sharded_problem
    mesh = make_mesh(data=data, time=time)
    s, sc = sharded_hsmm_viterbi(lo, la, lp, ld, mesh)
    s0, sc0 = hsmm_viterbi(lo, la, lp, ld)
    assert bool(jnp.all(s == s0)), "sharded HSMM segmentation differs"
    np.testing.assert_allclose(sc, sc0, atol=1e-4)


def test_sharded_hsmm_likelihood_gradient_matches(hsmm_sharded_problem):
    from pytorch_hmm_tpu.core.hsmm import hsmm_forward
    from pytorch_hmm_tpu.parallel import sharded_hsmm_log_likelihood

    lo, la, lp, ld = hsmm_sharded_problem
    mesh = make_mesh(data=2, time=4)
    g = jax.grad(
        lambda x: jnp.sum(sharded_hsmm_log_likelihood(x, la, lp, ld, mesh))
    )(lo)
    g0 = jax.grad(
        lambda x: jnp.sum(hsmm_forward(x, la, lp, ld)[1])
    )(lo)
    np.testing.assert_allclose(g, g0, atol=1e-3)


# ---------------------------------------------------------------------------
# Two-process multihost smoke test (real jax.distributed local cluster)
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.multiprocess
@pytest.mark.xdist_group("procs")
def test_multihost_two_process_smoke(tmp_path):
    """Drive initialize_multihost + global_mesh + a sharded forward pass
    across a real two-process jax.distributed CPU cluster. Exercises the
    multihost module end-to-end instead of just importing it."""
    import os
    import socket
    import subprocess
    import sys

    from pytorch_hmm_tpu import core

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coordinator = f"127.0.0.1:{port}"

    worker = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(worker)))
    env["PYTHONPATH"] = (
        repo_root + os.pathsep + env.get("PYTHONPATH", "")
    )
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coordinator, str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n" + "\n".join(outs))

    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
        assert "MULTIHOST_OK" in out, out

    # Both processes must report identical likelihoods, equal to the
    # single-process oracle on the same deterministic problem.
    def parse(out):
        line = [l for l in out.splitlines() if l.startswith("MULTIHOST_OK")][0]
        return np.asarray([float(x) for x in line.split()[1:]])

    v0, v1 = parse(outs[0]), parse(outs[1])
    np.testing.assert_allclose(v0, v1, atol=1e-5)

    rng = np.random.default_rng(0)
    B, T, K = 4, 32, 3
    log_obs = jnp.asarray(rng.normal(size=(B, T, K)), jnp.float32)
    log_a = jnp.log(jnp.asarray(rng.dirichlet(np.ones(K), size=K), jnp.float32))
    log_pi = jnp.log(jnp.asarray(rng.dirichlet(np.ones(K)), jnp.float32))
    oracle = core.log_likelihood(log_obs, log_a, log_pi)
    np.testing.assert_allclose(v0, np.asarray(oracle), atol=1e-4)


# ---------------------------------------------------------------------------
# Ragged (lengths) support on the sharded kernels
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ragged_sharded_problem(problem):
    log_obs, log_a, log_pi = problem
    rng = np.random.default_rng(29)
    lengths = jnp.asarray([64, 40, 17, 64, 8, 33, 64, 52], jnp.int32)
    lo = np.asarray(log_obs).copy()
    for b, n in enumerate(np.asarray(lengths)):
        lo[b, n:] = rng.normal(scale=40.0, size=lo[b, n:].shape)
    return jnp.asarray(lo), log_a, log_pi, lengths


@pytest.mark.parametrize("data,time", MESHES)
def test_sharded_forward_backward_ragged(ragged_sharded_problem, data, time):
    lo, la, lp, lengths = ragged_sharded_problem
    mesh = make_mesh(data=data, time=time)
    lg, lal, lb, lz = sharded_forward_backward(lo, la, lp, mesh, lengths)
    for b, n in enumerate(np.asarray(lengths)):
        lg0, lal0, lb0, lz0 = core.forward_backward(
            lo[b:b + 1, :n], la, lp
        )
        np.testing.assert_allclose(lz[b], lz0[0], atol=1e-4)
        np.testing.assert_allclose(
            np.asarray(lal)[b, :n], np.asarray(lal0)[0], atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(lb)[b, :n], np.asarray(lb0)[0], atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(lg)[b, :n], np.asarray(lg0)[0], atol=1e-4
        )


@pytest.mark.parametrize("data,time", MESHES)
def test_sharded_viterbi_ragged(ragged_sharded_problem, data, time):
    lo, la, lp, lengths = ragged_sharded_problem
    mesh = make_mesh(data=data, time=time)
    s, sc = sharded_viterbi(lo, la, lp, mesh, lengths)
    s = np.asarray(s)
    for b, n in enumerate(np.asarray(lengths)):
        s0, sc0 = core.viterbi(lo[b:b + 1, :n], la, lp)
        np.testing.assert_array_equal(s[b, :n], np.asarray(s0)[0])
        np.testing.assert_allclose(sc[b], np.asarray(sc0)[0], atol=1e-4)
        assert (s[b, n:] == s[b, n - 1]).all()


def test_sharded_likelihood_ragged_gradient(ragged_sharded_problem):
    lo, la, lp, lengths = ragged_sharded_problem
    mesh = make_mesh(data=2, time=4)
    g = jax.grad(
        lambda x: jnp.sum(sharded_log_likelihood(x, la, lp, mesh, lengths))
    )(lo)
    g = np.asarray(g)
    for b, n in enumerate(np.asarray(lengths)):
        g0 = jax.grad(
            lambda x: jnp.sum(core.log_likelihood(x, la, lp))
        )(lo[b:b + 1, :n])
        np.testing.assert_allclose(g[b, :n], np.asarray(g0)[0], atol=1e-4)
        # Padded frames never influence the likelihood.
        if n < lo.shape[1]:
            assert np.abs(g[b, n:]).max() == 0.0


# ---------------------------------------------------------------------------
# Time-varying transitions on the time-block-sharded layer (VERDICT r3
# item 5) — the NeuralHMM regime (reference neural.py:403-511): per-frame
# (B, T, K, K) log transitions, sharded like the observations.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tv_problem():
    rng = np.random.default_rng(11)
    B, T, K = 4, 64, 6
    log_obs = jnp.asarray(rng.normal(size=(B, T, K)), jnp.float32)
    la = jnp.asarray(
        rng.dirichlet(np.ones(K), size=(B, T, K)), jnp.float32
    )
    log_a = jnp.log(la)  # (B, T, K, K), rows normalized per frame
    log_pi = jnp.log(jnp.asarray(rng.dirichlet(np.ones(K)), jnp.float32))
    return log_obs, log_a, log_pi


@pytest.mark.parametrize("data,time", [(1, 8), (2, 4), (4, 2)])
def test_sharded_fb_time_varying(tv_problem, data, time):
    log_obs, log_a, log_pi = tv_problem
    mesh = make_mesh(data=data, time=time)
    lg, la_, lb, lz = sharded_forward_backward(log_obs, log_a, log_pi, mesh)
    lg0, la0, lb0, lz0 = core.forward_backward(log_obs, log_a, log_pi)
    np.testing.assert_allclose(la_, la0, atol=1e-4)
    np.testing.assert_allclose(lb, lb0, atol=1e-4)
    np.testing.assert_allclose(lg, lg0, atol=1e-4)
    np.testing.assert_allclose(lz, lz0, atol=1e-4)


@pytest.mark.parametrize("data,time", [(1, 8), (2, 4), (4, 2)])
def test_sharded_viterbi_time_varying(tv_problem, data, time):
    log_obs, log_a, log_pi = tv_problem
    mesh = make_mesh(data=data, time=time)
    s, sc = sharded_viterbi(log_obs, log_a, log_pi, mesh)
    s0, sc0 = core.viterbi(log_obs, log_a, log_pi)
    assert bool(jnp.all(s == s0)), "sharded time-varying Viterbi differs"
    np.testing.assert_allclose(sc, sc0, atol=1e-4)


def test_sharded_likelihood_time_varying_gradient(tv_problem):
    log_obs, log_a, log_pi = tv_problem
    mesh = make_mesh(data=2, time=4)
    g, ga = jax.grad(
        lambda lo, la: jnp.sum(sharded_log_likelihood(lo, la, log_pi, mesh)),
        argnums=(0, 1),
    )(log_obs, log_a)
    g0, ga0 = jax.grad(
        lambda lo, la: jnp.sum(core.log_likelihood(lo, la, log_pi)),
        argnums=(0, 1),
    )(log_obs, log_a)
    np.testing.assert_allclose(g, g0, atol=1e-4)
    np.testing.assert_allclose(ga, ga0, atol=1e-4)


def test_sharded_fb_time_varying_ragged(tv_problem):
    log_obs, log_a, log_pi = tv_problem
    lengths = jnp.asarray([64, 23, 41, 8], jnp.int32)
    mesh = make_mesh(data=2, time=4)
    lg, la_, lb, lz = sharded_forward_backward(
        log_obs, log_a, log_pi, mesh, lengths
    )
    for b, n in enumerate(np.asarray(lengths)):
        _, la0, lb0, lz0 = core.forward_backward(
            log_obs[b:b + 1, :n], log_a[b:b + 1, :n], log_pi
        )
        np.testing.assert_allclose(lz[b], lz0[0], atol=1e-4)
        np.testing.assert_allclose(
            np.asarray(la_)[b, :n], np.asarray(la0)[0], atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(lb)[b, :n], np.asarray(lb0)[0], atol=1e-4
        )


def test_sharded_scoring_log_likelihood_bigk():
    """Batch-DP big-K scoring: each device scores its batch shard with
    the whole time axis; the result matches the single-device scan."""
    from pytorch_hmm_tpu import core
    from pytorch_hmm_tpu.parallel import (
        make_mesh,
        shard_batch,
        sharded_scoring_log_likelihood,
    )

    mesh = make_mesh(data=8, time=1)
    B, T, K = 16, 256, 192
    rng = np.random.default_rng(5)
    lo = jnp.asarray(rng.normal(size=(B, T, K)), jnp.float32)
    la = jax.nn.log_softmax(
        jnp.asarray(rng.normal(size=(K, K)), jnp.float32), axis=-1
    )
    lpi = jnp.full((K,), -jnp.log(float(K)))
    got = sharded_scoring_log_likelihood(
        shard_batch(mesh, lo), la, lpi, mesh
    )
    ref = core.log_likelihood(lo, la, lpi)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-6)
