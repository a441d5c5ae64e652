"""Mixed precision and rematerialization policy.

The reference declares ``Config.USE_MIXED_PRECISION`` and
``Config.USE_CHECKPOINTING`` and never reads either (reference
``__init__.py:198-205``; SURVEY.md §5 calls this out). Here both flags
are live:

* **Mixed precision** (``USE_MIXED_PRECISION``, default ON): governs
  the multiply precision of every emission-scoring contraction and neural
  emission/transition net.

  - ON  → contractions run at XLA's default precision. On an NVIDIA
    Hopper card a float32 ``dot_general`` at default precision runs on
    the tensor cores in TF32 (10-bit mantissa multiplies, float32
    accumulation); on the CPU it is plain float32.
  - OFF → contractions request ``jax.lax.Precision.HIGHEST``: true
    float32 multiplies everywhere.

  Explicitly passing ``compute_dtype=jnp.bfloat16`` to an emission
  function additionally casts the *operands* to bf16 (halving their
  memory traffic); the flag alone never does it.

  Error bound: TF32 rounds each product to ~2^-11 relative with float32
  accumulation, so per-frame GMM log-probs move by O(0.01-0.1) absolute
  at D=80 speech shapes, which can flip Viterbi paths only at genuinely
  ambiguous frames. All DP carries (alpha/beta/delta recursions) are
  float32 under EITHER setting — only multiplier precision changes.

* **Checkpointing** (``USE_CHECKPOINTING``, default ON): gradient paths
  wrap emission scoring in ``jax.checkpoint`` so the ``(B, T, S[, C])``
  score tensors are recomputed in the backward pass instead of living
  in HBM across it — the standard remat trade of FLOPs for memory.

Resolution rules:

* functional emission code resolves at **trace time** — a flag flip
  applies to the next compilation (already-compiled jit caches keep
  their old precision; JAX also caches traces by function identity, so
  re-tracing requires a fresh function object or ``jax.clear_caches``);
* neural modules resolve at **construction time** (flax layers bind
  their matmul precision when built).

Both flags are owned here; ``api.Config`` delegates so the reference's
``config.USE_MIXED_PRECISION`` / ``config.set_precision(...)`` surface
keeps working.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

__all__ = [
    "mixed_precision_enabled",
    "set_mixed_precision",
    "checkpointing_enabled",
    "set_checkpointing",
    "compute_dtype",
    "matmul_precision",
    "mxu_einsum",
    "maybe_remat",
]

_MIXED_PRECISION = True
_CHECKPOINTING = True


def mixed_precision_enabled() -> bool:
    return _MIXED_PRECISION


def set_mixed_precision(enabled: bool) -> None:
    global _MIXED_PRECISION
    _MIXED_PRECISION = bool(enabled)


def checkpointing_enabled() -> bool:
    return _CHECKPOINTING


def set_checkpointing(enabled: bool) -> None:
    global _CHECKPOINTING
    _CHECKPOINTING = bool(enabled)


def compute_dtype(override: Optional[jnp.dtype] = None) -> jnp.dtype:
    """The dtype emission contractions should treat as their operand
    precision: ``override`` when given, else float32 (the mixed-precision
    flag picks the multiply precision, not the operand dtype)."""
    if override is not None:
        return jnp.dtype(override)
    return jnp.dtype(jnp.float32)


def matmul_precision() -> Optional[jax.lax.Precision]:
    """Precision request for flax layers / raw dots, resolved from the
    flag: ``None`` (backend default — TF32 on the GPU) when mixed
    precision is on, ``Precision.HIGHEST`` (true f32) when off."""
    if _MIXED_PRECISION:
        return None
    return jax.lax.Precision.HIGHEST


def mxu_einsum(
    spec: str,
    *operands: jax.Array,
    dtype: Optional[jnp.dtype] = None,
) -> jax.Array:
    """``jnp.einsum`` under the precision policy; output always f32.

    * flag ON, no override → default precision (TF32 multiplies with f32
      accumulation on the GPU; plain f32 on the CPU). No casts.
    * flag OFF (or explicit ``dtype=float32``) → true-f32 multiplies
      (``Precision.HIGHEST``).
    * explicit ``dtype=bfloat16`` → operands cast to bf16 (halved HBM
      footprint) with f32 accumulation.
    """
    dt = compute_dtype(dtype)
    if dt == jnp.bfloat16:  # explicit bf16 storage request
        ops = [x.astype(dt) for x in operands]
        return jnp.einsum(spec, *ops, preferred_element_type=jnp.float32)
    if dtype is None and _MIXED_PRECISION:
        return jnp.einsum(
            spec, *operands, preferred_element_type=jnp.float32
        )
    return jnp.einsum(
        spec, *operands, precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )


def maybe_remat(fn: Callable) -> Callable:
    """Wrap ``fn`` in ``jax.checkpoint`` when checkpointing is enabled
    (resolved at trace time, like ``compute_dtype``)."""
    if _CHECKPOINTING:
        return jax.checkpoint(fn)
    return fn
