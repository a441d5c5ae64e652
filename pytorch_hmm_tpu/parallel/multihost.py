"""Multi-host initialization helpers.

On a multi-host cluster every host runs the same program;
``jax.distributed.initialize`` wires the hosts together and the global
device list then spans all devices, with the ``time``-axis collectives
running over the interconnect. The reference framework has no multi-host
notion at all (SURVEY.md §2.3).

Fail-fast policy (SURVEY.md §5 "failure detection"): initialization
errors surface immediately rather than degrading to single-host; resume
training from the latest checkpoint (``pytorch_hmm_tpu.checkpoint``)
after replacing the failed host.
"""

from __future__ import annotations

from typing import Optional

import jax

from .mesh import make_mesh

__all__ = ["initialize_multihost", "global_mesh"]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> dict:
    """Join the distributed runtime (idempotent). Where no cluster
    environment describes the job, pass all three arguments (for one host:
    ``coordinator_address="localhost:<free port>"``).

    Returns a summary dict with global/local device counts.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already initialized" not in str(e).lower():
            raise
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "global_devices": jax.device_count(),
        "local_devices": jax.local_device_count(),
    }


def global_mesh(data: Optional[int] = None, time: Optional[int] = None):
    """Build a ``(data, time)`` mesh over ALL global devices.

    With no arguments, uses ``(num_hosts, devices_per_host)`` — batch
    parallelism across hosts (DCN) and time parallelism inside each host
    (ICI), the layout that keeps the chatty boundary exchange on the
    fast interconnect.
    """
    n = jax.device_count()
    if data is None and time is None:
        data = max(jax.process_count(), 1)
        time = n // data
    elif data is None:
        data = n // time
    elif time is None:
        time = n // data
    if data * time != n:
        raise ValueError(
            f"mesh {data}x{time} != {n} global devices"
        )
    return make_mesh(data=data, time=time)
