"""SPMD parallelism over device meshes.

A first-class subsystem the reference entirely lacks (it has no
``torch.distributed``, no multi-device code of any kind — SURVEY.md §2.3):

* ``mesh`` — declarative ``(data, time)`` mesh construction;
* ``sharded`` — exact block-parallel forward/backward/Viterbi with
  K-vector boundary-state exchange over the ``time`` axis;
* ``train`` — sharded NLL training steps (DP batch + SP time);
* ``elastic`` — fail-fast supervision (watchdog, heartbeat) and
  restart-from-checkpoint elastic training (needs flax; loaded on first
  use).
"""

from .mesh import (
    DATA_AXIS,
    TIME_AXIS,
    MeshConfig,
    data_sharding,
    make_mesh,
    replicated,
)
from .sharded import (
    sharded_scoring_log_likelihood,
    sharded_forward_backward,
    sharded_log_likelihood,
    sharded_viterbi,
)
from .sharded_hsmm import (
    sharded_hsmm_forward,
    sharded_hsmm_log_likelihood,
    sharded_hsmm_viterbi,
)
from .multihost import global_mesh, initialize_multihost
from .train import hmm_loss_parts, make_sharded_train_step, shard_batch
from .._lazy import lazy_getattr

__getattr__ = lazy_getattr(__name__, {
    name: ".elastic"
    for name in (
        "ElasticTrainer", "NonFiniteLossError", "Watchdog", "heartbeat",
        "latest_step",
    )
})

__all__ = [
    "DATA_AXIS",
    "TIME_AXIS",
    "MeshConfig",
    "data_sharding",
    "make_mesh",
    "replicated",
    "sharded_forward_backward",
    "sharded_log_likelihood",
    "sharded_scoring_log_likelihood",
    "sharded_viterbi",
    "sharded_hsmm_forward",
    "sharded_hsmm_log_likelihood",
    "sharded_hsmm_viterbi",
    "hmm_loss_parts",
    "make_sharded_train_step",
    "shard_batch",
    "initialize_multihost",
    "global_mesh",
    "ElasticTrainer",
    "NonFiniteLossError",
    "Watchdog",
    "heartbeat",
    "latest_step",
]
