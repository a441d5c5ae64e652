"""Elastic training: fail-fast supervision + restart-from-checkpoint.

The reference has no failure-detection or recovery story at all — its
closest artifacts are an OOM catch-and-halve recipe in the docs and an
iteration-cap valve in HSMM generation (SURVEY.md §5 "Failure detection
/ elastic recovery"). Multi-host training needs more: a hung
collective (dead peer, wedged device) blocks forever with no exception,
and a preempted worker must restart from persisted state, not step 0.

This module supplies the standard recipe:

* :class:`ElasticTrainer` — a supervised training loop that writes
  step-numbered checkpoints (model + optimizer + step counter) every
  ``save_every`` steps, resumes from the newest one on construction,
  fails fast on non-finite loss (or restores the last good checkpoint,
  ``on_nonfinite="restore"``), and optionally arms a :class:`Watchdog`
  around every step so a hang kills the process instead of stalling the
  job. The external launcher restarts the process; the trainer picks up
  where the last checkpoint left off — that pairing IS the elastic
  recovery loop.
* :class:`Watchdog` — a monitor thread that hard-exits the process
  (``os._exit``) if the guarded region does not finish in time.
  Python cannot interrupt a blocked XLA call, so fail-fast means
  process death by design; exit promptly and let the launcher respawn.
* :func:`heartbeat` — a cross-process liveness probe: one tiny
  ``psum(1)`` over all participating processes under a watchdog. Run it
  between steps (or from a side channel) to detect a dead peer in
  bounded time instead of hanging in the next collective.

Checkpoint layout: ``<root>/step_00000042/`` orbax directories; the
newest complete step wins. Optimizer state is stored as flattened
leaves and re-hung on a freshly initialized treedef at restore, so any
optax chain round-trips without pytree-structure metadata.
"""

from __future__ import annotations

import os
import re
import shutil
import sys
import threading
from typing import Any, Callable, Iterable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
from flax import nnx

from ..checkpoint import load_checkpoint, save_checkpoint
from ..logging_utils import get_logger

__all__ = [
    "ElasticTrainer",
    "Watchdog",
    "heartbeat",
    "NonFiniteLossError",
    "latest_step",
]

_STEP_RE = re.compile(r"^step_(\d{8})$")
_log = get_logger("elastic")


class NonFiniteLossError(RuntimeError):
    """Raised (fail-fast) when a training step produces NaN/Inf loss."""


def latest_step(root: str) -> Optional[int]:
    """Newest checkpointed step under ``root``, or None if there is none."""
    if not os.path.isdir(root):
        return None
    steps = [
        int(m.group(1))
        for name in os.listdir(root)
        if (m := _STEP_RE.match(name))
    ]
    return max(steps) if steps else None


class Watchdog:
    """Hard-exit the process if a guarded region overruns ``timeout_s``.

    A blocked XLA collective cannot be interrupted from Python, so the
    only reliable fail-fast is process death: the monitor thread fires
    ``on_timeout`` (default: log + ``os._exit(exit_code)``) and the
    launcher restarts the worker, which resumes from its checkpoint.

    Usage::

        with Watchdog(30.0):
            loss = step_fn(...)        # hangs > 30 s -> process exits 13
    """

    def __init__(
        self,
        timeout_s: float,
        on_timeout: Optional[Callable[[], None]] = None,
        exit_code: int = 13,
        label: str = "step",
    ):
        self.timeout_s = float(timeout_s)
        self.exit_code = exit_code
        self.label = label
        self._on_timeout = on_timeout
        self._timer: Optional[threading.Timer] = None

    def _fire(self):
        if self._on_timeout is not None:
            self._on_timeout()
            return
        _log.error(
            "watchdog: %r exceeded %.1fs — failing fast (exit %d)",
            self.label, self.timeout_s, self.exit_code,
        )
        sys.stderr.flush()
        os._exit(self.exit_code)

    def __enter__(self):
        self._timer = threading.Timer(self.timeout_s, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        if self._timer is not None:
            self._timer.cancel()
        return False


def heartbeat(timeout_s: float = 60.0, exit_code: int = 14) -> float:
    """Cross-process liveness probe in bounded time.

    Sums 1.0 across every participating process (``psum`` over all
    devices; a single-process run degenerates to a device probe) under a
    :class:`Watchdog`. Returns the observed world size. If any peer is
    dead or a chip is wedged, the collective never completes and the
    watchdog hard-exits with ``exit_code`` so the launcher can restart
    the world.
    """
    n = jax.device_count()
    with Watchdog(timeout_s, exit_code=exit_code, label="heartbeat"):
        mesh = jax.make_mesh((n,), ("d",))
        sharding = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("d")
        )
        ones = jax.device_put(np.ones((n,), np.float32), sharding)
        total = float(np.asarray(jnp.sum(ones)))
    return total


class ElasticTrainer:
    """Checkpointed, supervised training loop (restart-from-checkpoint).

    Parameters
    ----------
    model:
        Any nnx model. ``loss_fn(model, batch)`` must return a scalar.
    tx:
        An optax transform.
    ckpt_dir:
        Root for step-numbered checkpoints. If it already holds
        checkpoints, construction RESUMES from the newest one (model and
        optimizer state are restored in place).
    save_every:
        Checkpoint cadence in steps.
    max_to_keep:
        Retained checkpoints (older ones are deleted after a successful
        save, so a torn write can never leave zero usable checkpoints).
    step_timeout_s:
        If set, each optimizer step runs under a :class:`Watchdog`.
    on_nonfinite:
        ``"raise"`` (default) fails fast with :class:`NonFiniteLossError`;
        ``"restore"`` reloads the newest checkpoint and skips the batch.
    """

    def __init__(
        self,
        model: nnx.Module,
        tx: optax.GradientTransformation,
        loss_fn: Callable[[nnx.Module, Any], jax.Array],
        ckpt_dir: str,
        *,
        save_every: int = 100,
        max_to_keep: int = 3,
        step_timeout_s: Optional[float] = None,
        on_nonfinite: str = "raise",
    ):
        if on_nonfinite not in ("raise", "restore"):
            raise ValueError(f"on_nonfinite: {on_nonfinite!r}")
        self.model = model
        self.tx = tx
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.save_every = int(save_every)
        self.max_to_keep = int(max_to_keep)
        self.step_timeout_s = step_timeout_s
        self.on_nonfinite = on_nonfinite
        self.step = 0

        graphdef, params, rest = nnx.split(model, nnx.Param, ...)
        self._graphdef, self._rest = graphdef, rest
        self._params = params
        self._opt_state = tx.init(params)

        def train_step(params, rest, opt_state, batch):
            def loss_of(p):
                return loss_fn(nnx.merge(graphdef, p, rest), batch)

            loss, grads = jax.value_and_grad(loss_of)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        self._step_fn = jax.jit(train_step)

        resumed = self.restore_latest()
        if resumed is not None:
            _log.info("resumed from step %d (%s)", resumed, self.ckpt_dir)

    # -- checkpoint plumbing ------------------------------------------------

    def _step_path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"step_{step:08d}")

    def _sync_model(self):
        """Write current params back into the live model object."""
        nnx.update(self.model, self._params, self._rest)

    def save(self) -> str:
        """Checkpoint model + optimizer + step; prune old checkpoints."""
        self._sync_model()
        opt_leaves = jax.tree.leaves(self._opt_state)
        path = save_checkpoint(
            self._step_path(self.step),
            self.model,
            extras={
                "step": np.int64(self.step),
                "opt_leaves": {
                    str(i): np.asarray(leaf)
                    for i, leaf in enumerate(opt_leaves)
                },
            },
        )
        self._prune()
        return path

    def _prune(self):
        steps = sorted(
            int(m.group(1))
            for name in os.listdir(self.ckpt_dir)
            if (m := _STEP_RE.match(name))
        )
        for s in steps[: -self.max_to_keep]:
            shutil.rmtree(self._step_path(s), ignore_errors=True)

    def restore_latest(self) -> Optional[int]:
        """Restore the newest checkpoint; returns its step or None."""
        step = latest_step(self.ckpt_dir)
        if step is None:
            return None
        _, extras = load_checkpoint(
            self._step_path(step), self.model, with_extras=True
        )
        _, self._params, self._rest = nnx.split(self.model, nnx.Param, ...)
        # Re-hang saved optimizer leaves on a freshly built treedef so
        # any optax chain structure survives the round trip.
        fresh = self.tx.init(self._params)
        treedef = jax.tree.structure(fresh)
        saved = extras["opt_leaves"]
        leaves = [jnp.asarray(saved[str(i)]) for i in range(len(saved))]
        self._opt_state = jax.tree.unflatten(treedef, leaves)
        self.step = int(extras["step"])
        return self.step

    # -- the supervised loop ------------------------------------------------

    def train_step(self, batch) -> float:
        """One optimizer step (under the watchdog if configured)."""
        if self.step_timeout_s is not None:
            with Watchdog(self.step_timeout_s, label=f"step {self.step}"):
                params, opt_state, loss = self._step_fn(
                    self._params, self._rest, self._opt_state, batch
                )
                loss = float(np.asarray(loss))
        else:
            params, opt_state, loss = self._step_fn(
                self._params, self._rest, self._opt_state, batch
            )
            loss = float(np.asarray(loss))

        if not np.isfinite(loss):
            if self.on_nonfinite == "restore":
                restored = self.restore_latest()
                _log.warning(
                    "non-finite loss at step %d; restored step %s, "
                    "skipping batch", self.step, restored,
                )
                return loss
            raise NonFiniteLossError(f"step {self.step}: loss={loss}")

        self._params, self._opt_state = params, opt_state
        self.step += 1
        if self.step % self.save_every == 0:
            self.save()
        return loss

    def fit(self, batches: Iterable[Any]) -> float:
        """Drive :meth:`train_step` over ``batches``; returns final loss.

        Resumption is by position: already-completed steps (per the
        restored step counter) are skipped, so feeding the same
        deterministic batch stream after a crash replays nothing.
        """
        loss = float("nan")
        for i, batch in enumerate(batches):
            if i < self.step:
                continue
            loss = self.train_step(batch)
        self._sync_model()
        return loss
