"""Tracing and timing utilities.

The reference's only "profiling" is manual wall-clock timing with CUDA
sync in its benchmark script (``examples/benchmark.py:81-143``) and a
latency deque inside the streaming processor (SURVEY.md §5). Here:

* :func:`trace` — context manager around ``jax.profiler`` producing
  Perfetto/XProf traces of the device's kernels;
* :func:`window_times` / :func:`device_time` — time per call from warmed
  windows of calls that end in ``block_until_ready`` (JAX returns before
  the device finishes, so a window without it would time the enqueue);
* :func:`benchmark_op` — convenience wrapper returning a stats dict.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import jax
import numpy as np

__all__ = ["trace", "window_times", "device_time", "benchmark_op"]


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a ``jax.profiler`` trace (view with XProf / Perfetto) into
    ``log_dir`` (default: ``jax-trace`` under the temp directory)."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "jax-trace")
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def window_times(
    fn: Callable[..., Any],
    *args,
    reps: int = 20,
    target_window_sec: float = 0.05,
    max_calls: int = 4096,
) -> List[float]:
    """Seconds per call of ``fn(*args)`` in each of ``reps`` windows.

    The first call compiles and is not timed. Each window dispatches ``n``
    calls back to back and waits for the last with ``block_until_ready``
    (one device stream runs them in order); ``n`` is chosen so a window
    lasts about ``target_window_sec``, at most ``max_calls`` calls.
    """
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    one = max(time.perf_counter() - t0, 1e-9)
    n = int(min(max(1, np.ceil(target_window_sec / one)), max_calls))
    per_call = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n - 1):
            fn(*args)
        jax.block_until_ready(fn(*args))
        per_call.append((time.perf_counter() - t0) / n)
    return per_call


def device_time(
    fn: Callable[..., Any],
    *args,
    reps: int = 20,
    target_chain_sec: float = 0.05,
    max_reps: int = 4096,
) -> float:
    """Median seconds per call of ``fn(*args)`` over ``reps`` warmed
    windows of about ``target_chain_sec`` (at most ``max_reps`` calls
    each); see :func:`window_times`."""
    return float(np.median(window_times(
        fn, *args, reps=reps, target_window_sec=target_chain_sec,
        max_calls=max_reps,
    )))


def benchmark_op(
    fn: Callable[..., Any],
    *args,
    reps: int = 20,
    label: str = "op",
) -> Dict[str, float]:
    """Device-time stats for one op configuration."""
    seconds = device_time(fn, *args, reps=reps)
    return {
        "label": label,
        "device_time_ms": seconds * 1e3,
        "reps": reps,
    }
