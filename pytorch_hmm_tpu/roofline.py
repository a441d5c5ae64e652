"""Roofline accounting against the published peaks of the card a run is on.

For a measured call, ``roofline`` computes the least time the device could
take — the larger of the bytes over peak memory bandwidth and the matrix
operations over peak matmul rate — and reports which of the two binds and
the measured fraction of that bound. Peaks are keyed by JAX's
``device_kind``; a device not in the table is an error, never a default.

The serial HMM recursions are bound by neither: a chain of T dependent
small steps is latency-bound, so their roofline fraction is near 0 by
construction. Name that bound for what it is; do not read a small fraction
there as headroom a matmul kernel could take.
"""

from __future__ import annotations

from typing import Dict

__all__ = ["PEAKS", "peaks", "roofline"]

# Published dense peaks, NVIDIA H200 SXM data sheet (no sparsity), at its
# full 700 W power limit: HBM3e 4.8 TB/s; tensor cores 989 TFLOP/s in
# bf16/fp16 and 495 TFLOP/s in TF32; 67 TFLOP/s float32 outside the
# tensor cores.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H200": {
        "hbm_bytes_per_s": 4.8e12,
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,
    },
}


def peaks(device_kind: str) -> Dict[str, float]:
    """The published peaks of ``device_kind`` (``jax.devices()[0]
    .device_kind``). Raises ``KeyError`` for a device not in the table."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device {device_kind!r}; add them to "
            "pytorch_hmm_tpu.roofline.PEAKS with their source"
        ) from None


def roofline(
    measured_s: float,
    device_kind: str,
    hbm_bytes: float = 0.0,
    matmul_flops: float = 0.0,
    matmul_rate: str = "tf32_flops",
) -> Dict[str, float]:
    """Bound and achieved share for one measured call.

    ``hbm_bytes`` is the unavoidable device-memory traffic (inputs read
    once, outputs written once); ``matmul_flops`` the matrix operations,
    charged at ``matmul_rate`` (a key of the peaks table: float32 matmuls
    at default precision run in TF32 on the tensor cores). Returns the
    binding resource, the bound in ms, the measured fraction of it, and
    ``mfu_pct`` (achieved matmul rate over its peak) when there is matmul
    work.
    """
    p = peaks(device_kind)
    times = {
        "hbm": hbm_bytes / p["hbm_bytes_per_s"],
        "matmul": matmul_flops / p[matmul_rate],
    }
    binding = max(times, key=times.get)
    measured_s = max(measured_s, 1e-12)
    out = {
        "binding": binding,
        "bound_ms": times[binding] * 1e3,
        "frac_of_bound": times[binding] / measured_s,
    }
    if matmul_flops:
        out["mfu_pct"] = 100.0 * matmul_flops / measured_s / p[matmul_rate]
    return out
