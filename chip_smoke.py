"""Smoke test of the GMM-HMM decode and training path on one NVIDIA GPU.

Run from the root of a checkout::

    python chip_smoke.py            # one card: phases 1-6
    python chip_smoke.py --chips 4  # four cards: the sharded phase only

It drives the flagship configuration (12 states, 4 diagonal-covariance
components, 80 features, batch 32, 1000 frames) through the public
functional entry points with seeded random weights, checks every result
against the plain ``core`` reference, times the Pallas-Triton trellis
kernels against the XLA scans, and prints one JSON object as its last line.
It fails (non-zero exit, no JSON line) when JAX finds no GPU or any check
fails. One process drives the card(s) throughout.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import jax

# Flagship: MixtureGaussianHMMLayer(num_states=12, feature_dim=80,
# num_components=4, covariance_type="diag") at batch 32 x 1000 frames.
S, C, D = 12, 4, 80
B, T = 32, 1000
SEED = 0
PLATFORM = "gpu"
N_TIMED = 20
# (B, T, K) of the kernel parity phase; the last is the long shape at the
# largest K the kernels take (ops.TRELLIS_MAX_K).
PARITY_SHAPES = ((32, 1000, 12), (32, 1000, 32), (8, 16384, 128))
# lax.scan unrolls of the XLA baseline in the timing phase.
UNROLLS = (1, 8, 16, 32, 64)
# Emission scale of the soft-posterior gradient check: the flagship's
# emissions separate states by hundreds of nats, so its posteriors are
# one-hot; scaled by 0.02 a frame's best state keeps ~0.6 of the mass.
SOFT = 0.02


def card() -> str:
    """Name and power limit of the card(s), read by nvidia-smi (off JAX)."""
    if shutil.which("nvidia-smi") is None:
        raise SystemExit("chip_smoke: nvidia-smi not found")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def check(ok: bool, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def timed(fn, *args):
    """Median and interquartile range (ms) of warmed, synchronized calls."""
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(N_TIMED):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = np.percentile(ts, [25, 50, 75])
    return float(med), float(q3 - q1)


def flagship(seed: int):
    """Seeded GMM-HMM parameters and a batch sampled from that model."""
    import numpy as np
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    means = rng.normal(size=(S, C, D)).astype(np.float32) * 1.5
    log_vars = (0.2 * rng.normal(size=(S, C, D))).astype(np.float32)
    mix_logits = (0.5 * rng.normal(size=(S, C))).astype(np.float32)
    trans_logits = (rng.normal(size=(S, S)) + 3.0 * np.eye(S)).astype(
        np.float32)
    a = np.exp(trans_logits - trans_logits.max(-1, keepdims=True))
    a /= a.sum(-1, keepdims=True)
    w = np.exp(mix_logits) / np.exp(mix_logits).sum(-1, keepdims=True)
    states = np.zeros((B, T), np.int64)
    states[:, 0] = rng.integers(0, S, size=B)
    u = rng.random((B, T))
    cum = np.cumsum(a, axis=-1)
    for t in range(1, T):
        states[:, t] = np.minimum(
            (u[:, t, None] > cum[states[:, t - 1]]).sum(-1), S - 1)
    comp = (rng.random((B, T, 1)) > np.cumsum(w[states], -1)).sum(-1)
    comp = np.minimum(comp, C - 1)
    mu = means[states, comp]
    sd = np.exp(0.5 * log_vars[states, comp])
    obs = (mu + sd * rng.normal(size=(B, T, D))).astype(np.float32)
    params = {
        "means": jnp.asarray(means),
        "log_vars": jnp.asarray(log_vars),
        "mix_logits": jnp.asarray(mix_logits),
        "trans_logits": jnp.asarray(trans_logits),
    }
    return params, jnp.asarray(obs)


def parts(params, obs):
    """``(log_obs, log_a, log_pi)`` of the functional GMM-HMM."""
    import jax.numpy as jnp

    from pytorch_hmm_tpu.emissions import gmm_log_probs

    log_obs = gmm_log_probs(
        obs, params["means"], params["log_vars"], params["mix_logits"],
        "diag",
    )
    log_a = jax.nn.log_softmax(params["trans_logits"], axis=-1)
    log_pi = jnp.full((S,), -jnp.log(float(S)))
    return log_obs, log_a, log_pi


def plain_log_obs(params, obs):
    """Reference emission scores ``(B, T, S)``, written out in float32
    ``jnp`` independently of ``emissions``: ``logsumexp_c(log w_sc -
    0.5 * sum_d((x - mu)^2 / var + log var + log 2 pi))``."""
    import jax.numpy as jnp

    x = obs[:, :, None, None, :]
    lv = params["log_vars"]
    quad = jnp.sum((x - params["means"]) ** 2 * jnp.exp(-lv) + lv
                   + jnp.log(2.0 * jnp.pi), axis=-1)
    log_w = jax.nn.log_softmax(params["mix_logits"], axis=-1)
    return jax.scipy.special.logsumexp(log_w - 0.5 * quad, axis=-1)


def phase_decode(params, obs):
    import jax.numpy as jnp

    from pytorch_hmm_tpu import core, ops

    print("phase 3: decode at flagship width "
          f"(S={S}, C={C}, D={D}, B={B}, T={T})", flush=True)
    log_w = jax.nn.log_softmax(params["mix_logits"], axis=-1)
    _, log_a, log_pi = parts(params, obs)
    decode = jax.jit(lambda o: ops.auto_gmm_viterbi(
        o, params["means"], params["log_vars"], log_w, log_a, log_pi))
    states, score = decode(obs)

    with jax.default_matmul_precision("highest"):
        ref_lo = jax.jit(plain_log_obs)(params, obs)
        prog_lo = jax.jit(lambda o: parts(params, o)[0])(obs)
    ref_states, ref_score = core.viterbi(ref_lo, log_a, log_pi)
    lo_err = float(jnp.max(jnp.abs(prog_lo - ref_lo) / (1.0 + jnp.abs(ref_lo))))
    print(f"  emissions.gmm_log_probs at HIGHEST vs plain float32 scoring: "
          f"max |err|/(1+|ref|) = {lo_err:.3e}")
    # Both in float32; the program expands the quadratic into matmuls,
    # whose terms (~1e3 per frame and state) cancel to ~-1e2.
    check(lo_err <= 1e-5,
          "emission scores vs plain reference within 1e-5 (float32 "
          "cancellation in the expanded quadratic)")
    agree = float(jnp.mean(states == ref_states))
    rel = float(jnp.max(jnp.abs(score - ref_score) / jnp.abs(ref_score)))
    print(f"  path frame agreement vs plain float32 reference: {agree:.6f}")
    print(f"  largest relative score error: {rel:.3e}")
    # The kernel path scores emissions at default matmul precision: TF32
    # on this card, which rounds both operands to 2^-11 relative. The
    # expanded quadratic's terms sum to ~1e3 in magnitude per frame and
    # state, so a frame's log-prob (~-110) can move by up to ~1; the
    # reference scores in plain float32. Only near-tied frames can flip.
    check(agree >= 0.99 and rel <= 1e-2,
          "decode vs reference: frame agreement >= 0.99, relative score "
          "error <= 1e-2 (TF32 emission scoring on the kernel side)")
    log_obs = jax.jit(lambda o: parts(params, o)[0])(obs)
    k_states, k_score = jax.jit(ops.auto_viterbi)(log_obs, log_a, log_pi)
    c_states, c_score = core.viterbi(log_obs, log_a, log_pi)
    check(bool(jnp.all(k_states == c_states))
          and bool(jnp.all(k_score == c_score)),
          "trellis kernel vs core.viterbi on identical log_obs: identical "
          "paths (tie-breaks included) and scores")


def phase_train(params, obs):
    import numpy as np
    import jax.numpy as jnp
    import optax

    from pytorch_hmm_tpu import core, ops
    from pytorch_hmm_tpu.em import gmm_em_update

    print("phase 4: training at flagship width", flush=True)

    def loss_fn(p, o):
        return -jnp.mean(ops.auto_log_likelihood(*parts(p, o))) / T

    tx = optax.adam(1e-2)

    @jax.jit
    def step(p, opt_state, o):
        loss, grads = jax.value_and_grad(loss_fn)(p, o)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    p, opt_state, losses = params, tx.init(params), []
    for _ in range(5):
        p, opt_state, loss = step(p, opt_state, obs)
        losses.append(float(loss))
    print(f"  adam losses (NLL per frame): {losses}")
    check(all(map(jnp.isfinite, losses)) and losses[-1] < losses[0],
          "5 adam steps on auto_log_likelihood: finite, falling loss")

    log_a = jax.nn.log_softmax(params["trans_logits"], axis=-1)
    log_pi = parts(params, obs)[2]
    means, cov, logits = (params["means"], params["log_vars"],
                          params["mix_logits"])
    lls = []
    # EM is monotone in exact arithmetic. Near convergence its per-step
    # gain is smaller than TF32 scoring noise (~1e-5 of the likelihood),
    # so these steps run every matmul at HIGHEST and allow float32 noise
    # of 1e-6 relative on sums of ~1e5.
    with jax.default_matmul_precision("highest"):
        for _ in range(3):
            ll, new = gmm_em_update(obs, means, cov, logits, log_a, log_pi,
                                    "diag", 1e-3, True)
            lls.append(float(ll))
            means, cov, logits = (new["means"], new["cov_params"],
                                  new["mixture_logits"])
            log_a = jax.nn.log_softmax(new["transition_logits"], axis=-1)
        lo = parts({"means": means, "log_vars": cov, "mix_logits": logits,
                    "trans_logits": log_a}, obs)[0]
        lls.append(float(jnp.mean(ops.auto_log_likelihood(
            lo, log_a, log_pi))))
    print(f"  EM mean log-likelihood: {lls}")
    check(all(b >= a - 1e-6 * abs(a) for a, b in zip(lls, lls[1:])),
          "3 EM steps: log-likelihood does not decrease")

    def rel(x, ref):
        """Max abs error over max |ref|, per leaf."""
        return [float(np.max(np.abs(np.asarray(a, np.float64) - r))
                      / np.max(np.abs(r)))
                for a, r in zip(jax.tree.leaves(x), jax.tree.leaves(ref))]

    # The whole loss, differentiated w.r.t. the parameters: the program's
    # path (emissions + kernel VJP) against plain float32 scoring and
    # autodiff through core.log_likelihood, both at HIGHEST.
    def loss_plain(p, o):
        la = jax.nn.log_softmax(p["trans_logits"], axis=-1)
        return -jnp.mean(core.log_likelihood(
            plain_log_obs(p, o), la, parts(p, o)[2])) / T

    with jax.default_matmul_precision("highest"):
        gp_k = jax.jit(jax.grad(loss_fn))(params, obs)
        gp_r = jax.jit(jax.grad(loss_plain))(params, obs)
    gp_r = jax.tree.map(lambda r: np.asarray(r, np.float64), gp_r)
    p_err = dict(zip(sorted(params), rel(gp_k, gp_r)))
    print(f"  parameter gradient, program vs plain reference, max abs over "
          f"max |ref|: {p_err}")
    # float32 sums over B*T frames in other orders, through two scoring
    # formulas (expanded quadratic vs (x - mu)^2).
    check(max(p_err.values()) <= 1e-3,
          "parameter gradient agrees with plain float32 scoring + "
          "jax.grad(core.log_likelihood) within 1e-3 relative")

    log_obs, log_a, log_pi = jax.jit(parts)(params, obs)
    for scale in (1.0, SOFT):
        lo = log_obs * scale
        grad_k = jax.jit(jax.grad(
            lambda *x: jnp.sum(ops.auto_log_likelihood(*x)),
            argnums=(0, 1, 2)))(lo, log_a, log_pi)
        with jax.default_matmul_precision("highest"):
            grad_r = jax.jit(jax.grad(
                lambda *x: jnp.sum(core.log_likelihood(*x)),
                argnums=(0, 1, 2)))(lo, log_a, log_pi)
        grad_64 = float64_grads(lo, log_a, log_pi)
        k_vs_r = rel(grad_k, [np.asarray(r, np.float64) for r in grad_r])
        k_vs_64, r_vs_64 = rel(grad_k, grad_64), rel(grad_r, grad_64)
        sharp = float(np.mean(np.max(grad_64[0], axis=-1)))
        print(f"  VJP at emission scale {scale} (mean largest posterior "
              f"{sharp:.4f}); errors, max abs over max |ref|, for "
              f"(log_obs, log_a, log_pi):")
        print(f"    kernel vs jax.grad(core.log_likelihood): {k_vs_r}")
        print(f"    kernel vs float64 forward-backward: {k_vs_64}")
        print(f"    jax.grad(core.log_likelihood) vs float64: {r_vs_64}")
        # Closed-form posteriors vs autodiff through the scan: float32
        # sums of B*T terms in different orders, and per-frame
        # normalizations.
        check(max(k_vs_r) <= 1e-3,
              f"gradient agrees with jax.grad(core.log_likelihood) within "
              f"1e-3 relative (scale {scale})")
        check(max(k_vs_64) <= 1e-3,
              f"gradient agrees with float64 forward-backward within 1e-3 "
              f"relative (scale {scale})")


def float64_grads(log_obs, log_a, log_pi):
    """Gradients of ``sum(log Z)`` by float64 forward-backward in NumPy:
    ``(gamma, sum of xi over batch and time, gamma_0 summed over batch)``."""
    import numpy as np
    from scipy.special import logsumexp

    lo, la, lp = (np.asarray(x, np.float64) for x in (log_obs, log_a, log_pi))
    b, t_len, _ = lo.shape
    alpha, beta = np.empty_like(lo), np.zeros_like(lo)
    alpha[:, 0] = lp + lo[:, 0]
    for t in range(1, t_len):
        alpha[:, t] = lo[:, t] + logsumexp(
            alpha[:, t - 1, :, None] + la, axis=1)
    for t in range(t_len - 2, -1, -1):
        beta[:, t] = logsumexp(
            la + (lo[:, t + 1] + beta[:, t + 1])[:, None, :], axis=2)
    lz = logsumexp(alpha[:, -1], axis=1)
    gamma = np.exp(alpha + beta - lz[:, None, None])
    xi = np.exp(alpha[:, :-1, :, None] + la + (lo + beta)[:, 1:, None, :]
                - lz[:, None, None, None]).sum(axis=(0, 1))
    return gamma, xi, gamma[:, 0].sum(axis=0)


def path_score64(states, log_obs, log_a, log_pi):
    """Log-score ``(B,)`` of each row's state path, summed in float64."""
    import numpy as np

    st = np.asarray(states)
    lo, la, lp = (np.asarray(x, np.float64) for x in (log_obs, log_a, log_pi))
    rows = np.arange(st.shape[0])[:, None]
    frames = np.arange(st.shape[1])[None, :]
    return (lp[st[:, 0]] + lo[rows, frames, st].sum(1)
            + la[st[:, :-1], st[:, 1:]].sum(1))


def phase_parity():
    import numpy as np
    import jax.numpy as jnp

    from pytorch_hmm_tpu import core, ops

    print("phase 5: kernel parity at real widths", flush=True)
    check(max(k for _, _, k in PARITY_SHAPES) == ops.TRELLIS_MAX_K,
          f"parity covers the largest K the kernels take "
          f"({ops.TRELLIS_MAX_K})")
    for b, t, k in PARITY_SHAPES:
        rng = np.random.default_rng(k)
        lo = jnp.asarray(rng.normal(size=(b, t, k)) * 3.0 - 60.0,
                         jnp.float32)
        la = jnp.asarray(np.log(rng.dirichlet(np.ones(k), size=k)),
                         jnp.float32)
        lp = jnp.asarray(np.log(rng.dirichlet(np.ones(k))), jnp.float32)
        lengths = jnp.asarray(rng.integers(1, t + 1, size=b), jnp.int32)
        lengths = lengths.at[0].set(t)
        if k == ops.TRELLIS_MAX_K:
            for fn in (ops.trellis_viterbi, ops.trellis_forward_backward):
                ma = fn.lower(lo, la, lp, lengths).compile().memory_analysis()
                print(f"  memory_analysis {fn.__name__} (B={b}, T={t}, "
                      f"K={k}): arguments {ma.argument_size_in_bytes}, "
                      f"outputs {ma.output_size_in_bytes}, temporaries "
                      f"{ma.temp_size_in_bytes}, code "
                      f"{ma.generated_code_size_in_bytes} bytes")
        for lens in (None, lengths):
            tag = f"(B={b}, T={t}, K={k}{', ragged' if lens is not None else ''})"
            s, sc = ops.trellis_viterbi(lo, la, lp, lens)
            s0, sc0 = core.viterbi(lo, la, lp, lens)
            check(bool(jnp.all(s == s0)) and bool(jnp.all(sc == sc0)),
                  f"trellis_viterbi == core.viterbi {tag}")
            a, bb, lz = ops.trellis_forward_backward(lo, la, lp, lens)
            a0, lz0 = core.forward_log(lo, la, lp, lens)
            b0 = core.backward_log(lo, la, lens)
            err = max(
                float(jnp.max(jnp.abs(x - y) / (1.0 + jnp.abs(y))))
                for x, y in ((a, a0), (bb, b0), (lz, lz0))
            )
            # float32 log-sum-exp in another reduction order.
            check(err <= 1e-5,
                  f"trellis_forward_backward vs core.forward_log/"
                  f"backward_log {tag}: max |err|/(1+|ref|) = {err:.2e} "
                  f"<= 1e-5")


def phase_timing(params, obs, card_line):
    import jax.numpy as jnp

    from pytorch_hmm_tpu import core, ops

    print(f"phase 6: kernel vs XLA, median / IQR of {N_TIMED} warmed "
          f"calls, ms ({card_line})", flush=True)
    log_w = jax.nn.log_softmax(params["mix_logits"], axis=-1)
    _, log_a, log_pi = parts(params, obs)

    def decode(viterbi):
        return jax.jit(lambda o: viterbi(
            parts(params, o)[0], log_a, log_pi))

    def loss_grad(ll):
        return jax.jit(jax.value_and_grad(
            lambda p, o: -jnp.mean(ll(*parts(p, o)))))

    rows = {
        ("decode", "kernel (auto_gmm_viterbi)"): timed(jax.jit(
            lambda o: ops.auto_gmm_viterbi(
                o, params["means"], params["log_vars"], log_w, log_a,
                log_pi)), obs),
        ("likelihood+grad", "kernel (auto_log_likelihood)"): timed(
            loss_grad(ops.auto_log_likelihood), params, obs),
    }
    for u in UNROLLS:
        rows[("decode", f"XLA (core.viterbi, unroll={u})")] = timed(decode(
            lambda *x, u=u: core.viterbi(*x, unroll=u)), obs)
        rows[("likelihood+grad", f"XLA (core.log_likelihood, unroll={u})")] = (
            timed(loss_grad(lambda *x, u=u: core.log_likelihood(
                *x, unroll=u)), params, obs))
    for (step, name), (med, iqr) in rows.items():
        print(f"  {step} {name}: {med:.4f} ms (IQR {iqr:.4f}) on "
              f"{card_line}")
    for step in ("decode", "likelihood+grad"):
        kernel = next(m for (s, n), (m, _) in rows.items()
                      if s == step and n.startswith("kernel"))
        xla = {n: m for (s, n), (m, _) in rows.items()
               if s == step and n.startswith("XLA")}
        best = min(xla, key=xla.get)
        print(f"  {step}: XLA's best is {best}, {xla[best]:.4f} ms; "
              f"kernel / XLA's best = {kernel / xla[best]:.4f}")
    return rows


def peak_bytes():
    """``peak_bytes_in_use`` of every device."""
    return [d.memory_stats()["peak_bytes_in_use"] for d in jax.devices()]


def phase_sharded(card_line):
    """Sharded training step, Viterbi and likelihood on a data=2 x time=2
    and a data=4 mesh, each compared with the same call on one card."""
    import numpy as np
    import optax
    import jax.numpy as jnp

    from pytorch_hmm_tpu import core, parallel

    print(f"sharded phase on {len(jax.devices())} cards ({card_line})",
          flush=True)
    params, obs = flagship(SEED)
    log_obs, log_a, log_pi = jax.jit(parts)(params, obs)
    ref_states, ref_score = core.viterbi(log_obs, log_a, log_pi)
    ref_ll = core.log_likelihood(log_obs, log_a, log_pi)
    # Plain SGD, so that the parameter update is the gradient itself
    # (adam's first step is lr * sign(g), which flips on near-zero
    # entries under any change of summation order).
    lr = 1e-3
    tx = optax.sgd(lr)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p, o: -jnp.mean(core.log_likelihood(*parts(p, o)))
    ))(params, obs)
    gmax = max(float(jnp.max(jnp.abs(g))) for g in jax.tree.leaves(ref_grads))
    # The time-sharded passes fold each block's T/P frames into one
    # operator, so the float32 sums of T terms (~1e5 in magnitude here)
    # are taken in another order: they may differ by T * 2^-24 relative.
    sum_tol = T * 2.0 ** -24
    ref_path64 = path_score64(ref_states, log_obs, log_a, log_pi)

    for data, time_ in ((2, 2), (4, 1)):
        mesh = parallel.make_mesh(data=data, time=time_)
        tag = f"mesh data={data} x time={time_}"
        shard = parallel.shard_batch
        states, score = parallel.sharded_viterbi(
            shard(mesh, log_obs), log_a, log_pi, mesh)
        agree = float(jnp.mean(states == ref_states))
        srel = float(jnp.max(jnp.abs(score - ref_score)
                             / jnp.abs(ref_score)))
        prel = float(np.max(np.abs(
            path_score64(states, log_obs, log_a, log_pi) - ref_path64)
            / np.abs(ref_path64)))
        print(f"  sharded_viterbi ({tag}): frame agreement {agree:.6f}, "
              f"score rel err {srel:.2e}, float64 path-score rel diff "
              f"{prel:.2e}")
        # A near-tie may resolve the other way under the other order;
        # the path must still be optimal, scored exactly.
        check(srel <= sum_tol and prel <= sum_tol,
              f"sharded_viterbi vs one-card core.viterbi ({tag}): score "
              f"and float64 path score within T*2^-24 = {sum_tol:.2e} "
              f"relative")
        ll = parallel.sharded_log_likelihood(
            shard(mesh, log_obs), log_a, log_pi, mesh)
        rel = float(jnp.max(jnp.abs(ll - ref_ll) / jnp.abs(ref_ll)))
        check(rel <= sum_tol,
              f"sharded_log_likelihood vs one card ({tag}): {rel:.2e} <= "
              f"T*2^-24 = {sum_tol:.2e} relative")
        opt_state, step_fn, p, rest = parallel.make_sharded_train_step(
            params, tx, mesh, parts_fn=parts)
        p, opt_state, loss = step_fn(p, rest, opt_state, shard(mesh, obs))
        lrel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        gerr = max(
            float(jnp.max(jnp.abs((p0 - p1) / lr - g)))
            for p0, p1, g in zip(jax.tree.leaves(params), jax.tree.leaves(p),
                                 jax.tree.leaves(ref_grads))
        ) / gmax
        # The sharded and one-card passes differ in summation order only.
        check(lrel <= sum_tol and gerr <= 1e-3,
              f"make_sharded_train_step, one SGD step ({tag}): loss rel "
              f"err {lrel:.2e} <= {sum_tol:.2e}, gradient err over max "
              f"|grad| {gerr:.2e} <= 1e-3")
        peaks = peak_bytes()
        print(f"  peak_bytes_in_use per card after {tag}: {peaks}")
        check(all(p_ > 0 for p_ in peaks), f"every card did work ({tag})")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--chips", type=int, default=1, choices=(1, 4),
        help="4: run only the sharded phase, on four cards",
    )
    args = parser.parse_args()

    print("phase 1: platform", flush=True)
    devices = jax.devices()
    if devices[0].platform != PLATFORM:
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found {devices[0].platform}")
    if len(devices) < args.chips:
        raise SystemExit(
            f"chip_smoke: --chips {args.chips} but {len(devices)} devices")
    card_line = card()
    print(card_line)
    print(f"  jax {jax.__version__}; devices {devices}")

    print("phase 2: compile cache", flush=True)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update(
            "jax_compilation_cache_dir",
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".jax_cache"),
        )
    print(f"  {jax.config.jax_compilation_cache_dir}")

    if args.chips == 4:
        phase_sharded(card_line)
    else:
        params, obs = flagship(SEED)
        phase_decode(params, obs)
        phase_train(params, obs)
        phase_parity()
        phase_timing(params, obs, card_line)

    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))


if __name__ == "__main__":
    sys.exit(main())
