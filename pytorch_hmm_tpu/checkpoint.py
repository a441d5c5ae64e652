"""Checkpoint / resume for models and streaming sessions.

The reference has nothing custom here — its models are ``nn.Module``s so
``state_dict()`` exists implicitly but is never exercised anywhere in
code, tests or examples (SURVEY.md §5 "Checkpoint / resume"); streaming
session state lives only in memory. Here checkpointing is first-class:

* :func:`save_checkpoint` / :func:`load_checkpoint` — orbax-backed
  persistence of any nnx model's full state (parameters *and* buffers),
  with an optional extras pytree (optimizer state, step counters);
* :func:`streaming_session_state` / :func:`restore_streaming_session` —
  serialize a ``StreamingHMMProcessor``'s carried decoder state (feature
  buffer, greedy/beam carries, frame counters) so a live session can be
  resumed after preemption — the exact "restart-from-checkpoint"
  behavior multi-host runs need (SURVEY.md §5).

orbax and flax are imported when a model checkpoint is saved or loaded,
not with this module.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "streaming_session_state",
    "restore_streaming_session",
]


def _checkpointer():
    import orbax.checkpoint as ocp

    return ocp.StandardCheckpointer()


def save_checkpoint(
    path: str,
    model: nnx.Module,
    extras: Optional[Dict[str, Any]] = None,
) -> str:
    """Persist a model's full nnx state (+ optional extras pytree).

    ``path`` is created (or replaced) as an orbax checkpoint directory.
    Returns the absolute path.
    """
    from flax import nnx

    path = os.path.abspath(path)
    _, state = nnx.split(model)
    payload = {"model": nnx.to_pure_dict(state), "extras": extras or {}}
    ckptr = _checkpointer()
    ckptr.save(path, payload, force=True)
    ckptr.wait_until_finished()
    return path


def load_checkpoint(
    path: str,
    model: nnx.Module,
    with_extras: bool = False,
):
    """Restore a model's state in place from :func:`save_checkpoint`.

    Returns the model, or ``(model, extras)`` with ``with_extras=True``.
    """
    from flax import nnx

    path = os.path.abspath(path)
    graphdef, state = nnx.split(model)
    ckptr = _checkpointer()
    # Extras have arbitrary topology; restore them without a template
    # (metadata-driven), the model with its exact template.
    restored = ckptr.restore(path)
    extras = restored.get("extras") or None
    nnx.replace_by_pure_dict(state, restored["model"])
    nnx.update(model, state)
    if with_extras:
        return model, extras
    return model


def streaming_session_state(processor) -> Dict[str, Any]:
    """Snapshot a ``StreamingHMMProcessor``'s carried decoder state as a
    plain pytree of host arrays (JSON-free, orbax/np.savez friendly)."""
    return {
        "buffer": np.asarray(processor._buffer),
        "last_output_frame": processor.last_output_frame,
        "chunk_counter": processor.chunk_counter,
        "total_frames_processed": processor.total_frames_processed,
        "prev_state": np.asarray(processor._prev_state),
        "has_prev": np.asarray(processor._has_prev),
        "beam_scores": np.asarray(processor._beam_scores),
        "beam_states": np.asarray(processor._beam_states),
        "beam_paths": np.asarray(processor._beam_paths),
        "beam_len": np.asarray(processor._beam_len),
    }


def restore_streaming_session(processor, session: Dict[str, Any]):
    """Load a :func:`streaming_session_state` snapshot back into a
    processor (shapes must match its configuration)."""
    import jax.numpy as jnp

    processor._buffer = np.asarray(session["buffer"], np.float32)
    processor.last_output_frame = int(session["last_output_frame"])
    processor.chunk_counter = int(session["chunk_counter"])
    processor.total_frames_processed = int(
        session["total_frames_processed"]
    )
    processor._prev_state = jnp.asarray(session["prev_state"])
    processor._has_prev = jnp.asarray(session["has_prev"])
    processor._beam_scores = jnp.asarray(session["beam_scores"])
    processor._beam_states = jnp.asarray(session["beam_states"])
    processor._beam_paths = jnp.asarray(session["beam_paths"])
    processor._beam_len = jnp.asarray(session["beam_len"])
    return processor
