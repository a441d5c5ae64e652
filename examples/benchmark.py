"""Comprehensive benchmark harness (reference: ``examples/benchmark.py``).

Sweeps the reference's full grid — batch [1,4,8,16,32] × seq len
[50..500] × states [5..50] (``benchmark.py:36-57``) — across every model
family, records device memory alongside timing, and writes a JSON report
comparable to the reference's ``PERFORMANCE.md`` tables.

Unlike the reference harness (wall clock + ``torch.cuda.synchronize``,
``benchmark.py:81-143``), timings here are warmed windows of calls that
end in ``block_until_ready`` (see ``pytorch_hmm_tpu.profiling``).
Memory accounting uses ``device.memory_stats()`` where the backend
provides it (the GPU) and live-buffer byte totals everywhere else.

Usage:
    python examples/benchmark.py [--quick | --full] [--output report.json]

Default sweeps a representative subset; ``--full`` runs the reference's
complete grid; ``--quick`` is the CI smoke configuration.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from flax import nnx

import pytorch_hmm_tpu as ph
from pytorch_hmm_tpu.profiling import device_time


@dataclasses.dataclass
class BenchmarkConfig:
    """Sweep configuration (reference ``benchmark.py:36-57``)."""

    batch_sizes: tuple = (1, 8, 32)
    seq_lengths: tuple = (100, 500)
    num_states: tuple = (5, 20, 50)
    feature_dim: int = 80
    reps: int = 10

    @classmethod
    def full(cls):
        return cls(batch_sizes=(1, 4, 8, 16, 32),
                   seq_lengths=(50, 100, 200, 500),
                   num_states=(5, 10, 20, 50))

    @classmethod
    def quick(cls):
        return cls(batch_sizes=(4,), seq_lengths=(50,), num_states=(5,),
                   feature_dim=20, reps=2)


# ---------------------------------------------------------------------------
# Memory accounting


def _device_mem() -> Optional[Dict[str, int]]:
    dev = jax.devices()[0]
    stats = getattr(dev, "memory_stats", lambda: None)()
    if not stats:
        return None
    return {k: stats[k] for k in ("bytes_in_use", "peak_bytes_in_use")
            if k in stats}


def _live_bytes() -> int:
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for x in jax.live_arrays())


def measure(fn, *args, reps: int) -> Dict:
    """Device time + memory delta for one workload.

    ``retained_mb`` is the live-buffer growth from holding the output;
    ``device_*_mb`` are backend allocator stats when available (GPU).
    """
    before_live = _live_bytes()
    before_dev = _device_mem()
    out = fn(*args)
    jax.block_until_ready(out)
    t = device_time(fn, *args, reps=reps)
    after_dev = _device_mem()
    rec = {
        "time_ms": round(t * 1e3, 4),
        "retained_mb": round((_live_bytes() - before_live) / 2**20, 3),
    }
    if before_dev and after_dev:
        rec["device_bytes_in_use_mb"] = round(
            after_dev["bytes_in_use"] / 2**20, 2
        )
        if "peak_bytes_in_use" in after_dev:
            rec["device_peak_mb"] = round(
                after_dev["peak_bytes_in_use"] / 2**20, 2
            )
    del out
    return rec


# ---------------------------------------------------------------------------
# Suites


def bench_basic_hmm(cfg: BenchmarkConfig) -> List[Dict]:
    """Forward-backward + Viterbi over the full B×T×K grid
    (``benchmark.py:144-220``)."""
    rng = np.random.default_rng(0)
    results = []
    for K in cfg.num_states:
        hmm = ph.HMM(ph.create_left_to_right_matrix(K))
        for B in cfg.batch_sizes:
            for T in cfg.seq_lengths:
                obs = jnp.asarray(rng.random((B, T, K)), jnp.float32)
                m_fb = measure(lambda o: hmm.forward_backward(o)[0], obs,
                               reps=cfg.reps)
                m_vit = measure(lambda o: hmm.viterbi_decode(o)[0], obs,
                                reps=cfg.reps)
                best = min(m_fb["time_ms"], m_vit["time_ms"]) / 1e3
                results.append({
                    "suite": "basic_hmm", "B": B, "T": T, "K": K,
                    "forward_backward": m_fb, "viterbi": m_vit,
                    "frames_per_sec": round(B * T / max(best, 1e-9)),
                })
    return results


def bench_mixture_gaussian(cfg: BenchmarkConfig) -> List[Dict]:
    """GMM-HMM decode (the headline config, ``benchmark.py:222-300``)."""
    results = []
    shapes = ([(5, 2, (4, 50))] if cfg.reps <= 2 else
              [(12, 4, (32, 1000)), (12, 4, (8, 500)), (20, 8, (32, 1000))])
    for K, C, (B, T) in shapes:
        model = ph.MixtureGaussianHMMLayer(
            K, cfg.feature_dim, C, rngs=nnx.Rngs(0)
        )
        obs = jax.random.normal(
            jax.random.PRNGKey(0), (B, T, cfg.feature_dim)
        )
        m = measure(lambda o: model(o, return_log_probs=True)[1], obs,
                    reps=cfg.reps)
        t = m["time_ms"] / 1e3
        results.append({
            "suite": "mixture_gaussian", "B": B, "T": T, "K": K,
            "components": C, "decode": m,
            "frames_per_sec": round(B * T / max(t, 1e-9)),
            "x_realtime": round(B * T * 0.01 / max(t, 1e-9), 1),
        })
    return results


def bench_hsmm(cfg: BenchmarkConfig) -> List[Dict]:
    """Explicit-duration decode (``benchmark.py:360-420``)."""
    results = []
    model = ph.HSMMLayer(10, cfg.feature_dim, max_duration=20,
                         rngs=nnx.Rngs(0))
    shapes = [(2, 50)] if cfg.reps <= 2 else [(32, 1000), (8, 500), (4, 2000)]
    for B, T in shapes:
        obs = jax.random.normal(jax.random.PRNGKey(1),
                                (B, T, cfg.feature_dim))
        m = measure(lambda o: model(o)[1], obs,
                    reps=max(cfg.reps // 2, 2))
        t = m["time_ms"] / 1e3
        results.append({
            "suite": "hsmm", "B": B, "T": T, "states": 10,
            "max_duration": 20, "decode": m,
            "frames_per_sec": round(B * T / max(t, 1e-9)),
        })
    return results


def bench_neural_hmm(cfg: BenchmarkConfig) -> List[Dict]:
    """NeuralHMM forward posteriors (reference ``benchmark.py:222-260``;
    BASELINE config: B=16 T=1000, ref 5.1 ms)."""
    results = []
    shapes = [(2, 40, 8)] if cfg.reps <= 2 else [(16, 1000, 12), (8, 500, 12)]
    for B, T, S in shapes:
        D = min(cfg.feature_dim, 40)
        model = ph.NeuralHMM(
            num_states=S, observation_dim=D, hidden_dim=256,
            rngs=nnx.Rngs(0),
        ).eval()
        obs = jax.random.normal(jax.random.PRNGKey(2), (B, T, D))
        m = measure(lambda o: model(o)[0], obs, reps=max(cfg.reps // 2, 2))
        t = m["time_ms"] / 1e3
        results.append({
            "suite": "neural_hmm", "B": B, "T": T, "states": S,
            "forward": m,
            "frames_per_sec": round(B * T / max(t, 1e-9)),
        })
    return results


def bench_semi_markov(cfg: BenchmarkConfig) -> List[Dict]:
    """SemiMarkovHMM segment Viterbi (BASELINE: B=24 T=800, ref 4.2 ms)."""
    results = []
    D = min(cfg.feature_dim, 40)
    model = ph.SemiMarkovHMM(8, D, max_duration=20, rngs=nnx.Rngs(0))
    shapes = [(40,)] if cfg.reps <= 2 else [(800,), (300,)]
    for (T,) in shapes:
        # Batched call: pure on-device frame path (the unbatched API
        # additionally run-length-encodes on the host).
        obs = jax.random.normal(jax.random.PRNGKey(3), (1, T, D))
        m = measure(lambda o: model.viterbi_decode(o)[2], obs,
                    reps=max(cfg.reps // 2, 2))
        t = m["time_ms"] / 1e3
        results.append({
            "suite": "semi_markov", "T": T, "states": 8,
            "viterbi": m, "frames_per_sec": round(T / max(t, 1e-9)),
        })
    return results


def bench_streaming(cfg: BenchmarkConfig) -> List[Dict]:
    """Steady-state chunk latency percentiles (BASELINE: ref 1.1 ms p50)."""
    proc = ph.StreamingHMMProcessor(
        num_states=12, feature_dim=cfg.feature_dim, chunk_size=160,
        use_beam_search=False, rngs=nnx.Rngs(0),
    )
    rng = np.random.default_rng(4)
    n = 6 if cfg.reps <= 2 else 60
    times = []
    for i in range(n):
        chunk = rng.normal(size=(160, cfg.feature_dim)).astype(np.float32)
        t0 = time.perf_counter()
        proc.process_chunk(chunk)
        times.append((time.perf_counter() - t0) * 1e3)
    steady = times[len(times) // 3:]  # drop compile/warmup
    return [{
        "suite": "streaming", "chunk": 160, "states": 12,
        "p50_ms": round(float(np.percentile(steady, 50)), 3),
        "p95_ms": round(float(np.percentile(steady, 95)), 3),
        "chunks": n,
    }]


def bench_alignment(cfg: BenchmarkConfig) -> List[Dict]:
    """DTW + CTC (``benchmark.py:302-358``)."""
    rng = np.random.default_rng(2)
    results = []
    N, M = (40, 100) if cfg.reps <= 2 else (100, 400)
    x = jnp.asarray(rng.normal(size=(N, 40)), jnp.float32)
    y = jnp.asarray(rng.normal(size=(M, 40)), jnp.float32)
    m = measure(lambda a, b: ph.alignment.dtw.dtw_distance(a, b), x, y,
                reps=cfg.reps)
    results.append({"suite": "dtw", "N": N, "M": M, "distance": m})

    T, B, Cc, U = (60, 2, 12, 8) if cfg.reps <= 2 else (500, 8, 40, 30)
    lp = jax.nn.log_softmax(
        jnp.asarray(rng.normal(size=(T, B, Cc)), jnp.float32), axis=-1
    )
    targets = jnp.asarray(rng.integers(1, Cc, size=(B, U)))
    il = jnp.full((B,), T)
    tl = jnp.full((B,), U)
    m = measure(lambda l: ph.alignment.ctc_loss(l, targets, il, tl), lp,
                reps=cfg.reps)
    results.append({"suite": "ctc", "T": T, "B": B, "C": Cc, "U": U,
                    "loss": m})
    return results


def bench_memory_scaling(cfg: BenchmarkConfig) -> List[Dict]:
    """Memory growth with sequence length (reference ``benchmark.py``
    memory suite): decode footprint should scale O(B·T·K)."""
    results = []
    K = 12
    hmm = ph.HMM(ph.create_left_to_right_matrix(K))
    lens = (50, 100) if cfg.reps <= 2 else (500, 2000, 8000)
    rng = np.random.default_rng(5)
    for T in lens:
        obs = jnp.asarray(rng.random((8, T, K)), jnp.float32)
        m = measure(lambda o: hmm.forward_backward(o)[0], obs, reps=2)
        m["input_mb"] = round(obs.nbytes / 2**20, 3)
        results.append({"suite": "memory", "B": 8, "T": T, "K": K,
                        "forward_backward": m})
        del obs
    return results


SUITES = (bench_basic_hmm, bench_mixture_gaussian, bench_hsmm,
          bench_neural_hmm, bench_semi_markov, bench_streaming,
          bench_alignment, bench_memory_scaling)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true",
                        help="CI smoke configuration")
    parser.add_argument("--full", action="store_true",
                        help="the reference's complete B×T×K grid")
    parser.add_argument("--output", default="benchmark_report.json")
    parser.add_argument("--suites", default="",
                        help="comma-separated suite names to run")
    args = parser.parse_args(argv)

    cfg = (BenchmarkConfig.quick() if args.quick
           else BenchmarkConfig.full() if args.full
           else BenchmarkConfig())

    wanted = {s for s in args.suites.split(",") if s}
    report = {
        "device": jax.devices()[0].platform,
        "jax_version": jax.__version__,
        "timestamp": time.time(),
        "config": dataclasses.asdict(cfg),
        "results": [],
    }
    for suite in SUITES:
        name = suite.__name__.removeprefix("bench_")
        if wanted and name not in wanted:
            continue
        print(f"Running {name}...")
        t0 = time.perf_counter()
        report["results"].extend(suite(cfg))
        print(f"  ({time.perf_counter() - t0:.1f}s)")

    with open(args.output, "w") as f:
        json.dump(report, f, indent=2)
    print(f"Wrote {len(report['results'])} results to {args.output}")
    for r in report["results"]:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
