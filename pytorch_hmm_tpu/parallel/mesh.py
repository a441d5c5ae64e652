"""Device-mesh configuration for SPMD HMM inference/training.

The reference has **zero** distributed code (SURVEY.md §2.3) — its only
notion of placement is `.to(device)` single-GPU tensor placement
(reference ``hmm.py:247-254``). Here the distributed layer is first-class:

* axis ``"data"`` — batch (utterance) data parallelism;
* axis ``"time"`` — time-block sequence parallelism for the DP recursions
  (block-parallel scans exchanging K-vector boundary states, see
  ``parallel/sharded.py``).

Meshes are plain ``jax.sharding.Mesh`` objects; nothing here is
device-specific, so the same code runs on a virtual CPU mesh
(``XLA_FLAGS=--xla_force_host_platform_device_count=N``) for tests and on
GPUs in production (one process per host, ``jax.distributed.initialize``
across hosts). The GPUs of a host are joined all to all, so the mesh
shape follows the algorithm, not a physical topology.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = [
    "MeshConfig",
    "make_mesh",
    "data_sharding",
    "replicated",
    "DATA_AXIS",
    "TIME_AXIS",
]

DATA_AXIS = "data"
TIME_AXIS = "time"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh shape.

    ``data * time`` must equal the number of participating devices. Either
    may be 1 (pure DP or pure sequence parallelism).
    """

    data: int = 1
    time: int = 1

    def build(self, devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
        devices = list(devices) if devices is not None else jax.devices()
        n = self.data * self.time
        if len(devices) < n:
            raise ValueError(
                f"MeshConfig(data={self.data}, time={self.time}) needs {n} "
                f"devices, have {len(devices)}"
            )
        arr = np.asarray(devices[:n]).reshape(self.data, self.time)
        return Mesh(arr, (DATA_AXIS, TIME_AXIS))


def make_mesh(
    data: int = 1,
    time: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ``(data, time)`` mesh over the given (default: all) devices.

    For multi-host pods, call ``jax.distributed.initialize()`` first; the
    global device list then spans hosts and XLA routes the ``time``-axis
    ``ppermute``/``all_gather`` collectives over ICI.
    """
    return MeshConfig(data=data, time=time).build(devices)


def data_sharding(mesh: Mesh, batch_axes: int = 1) -> NamedSharding:
    """Sharding for a batch tensor: batch over ``data``, time over ``time``.

    ``batch_axes=1`` shards axis 0 over data and axis 1 over time (the
    ``(B, T, ...)`` layout every model here uses).
    """
    spec = [DATA_AXIS] + [None] * (batch_axes - 1)
    if TIME_AXIS in mesh.axis_names:
        spec = [DATA_AXIS, TIME_AXIS]
    return NamedSharding(mesh, PartitionSpec(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    """Fully replicated sharding (for model parameters)."""
    return NamedSharding(mesh, PartitionSpec())
