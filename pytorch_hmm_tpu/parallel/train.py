"""Sharded training-step builders (data + time parallel NLL training).

The reference trains its layers with per-call autograd through Python
loops on one device (``hmm_layer.py:144-173``); there is no distributed
training anywhere in it (SURVEY.md §2.3). Here training is SPMD over a
``(data, time)`` mesh:

* the batch axis is sharded over ``data`` (plain data parallelism — XLA
  inserts the gradient ``psum`` automatically because the loss is a mean
  over the global batch);
* the time axis is sharded over ``time``: emission scoring is pointwise
  over frames so XLA keeps it sharded for free, and the forward
  recursion inside the loss runs on the block-parallel
  ``sharded_log_likelihood`` (boundary exchange between devices).

Works with any nnx model that exposes per-state emission scores and log
transition parameters (adapters below cover the built-in layer types), or
with a plain pytree of parameters and a ``parts_fn`` of its own; flax is
imported only for nnx models.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import DATA_AXIS, TIME_AXIS
from .sharded import sharded_log_likelihood

__all__ = ["hmm_loss_parts", "make_sharded_train_step", "shard_batch"]


def hmm_loss_parts(model, obs: jax.Array):
    """Adapter: ``(model, obs (B,T,D|K)) → (log_obs, log_a, log_pi)``.

    Dispatches on the built-in *plain-HMM* layer types; segment models
    (HSMM/semi-Markov) are rejected — their likelihood is a segment DP,
    not the plain forward recursion this trainer shards. Custom models
    can pass their own ``parts_fn`` to ``make_sharded_train_step``.
    """
    from ..models import (
        GaussianHMMLayer,
        HMMLayer,
        MixtureGaussianHMMLayer,
    )

    if isinstance(model, MixtureGaussianHMMLayer):
        return (
            model.get_observation_log_probs(obs),
            model._log_a(),
            model._log_pi(),
        )
    if isinstance(model, GaussianHMMLayer):
        log_obs = model._compute_gaussian_log_probs(obs)
        log_a, log_pi = model.hmm_layer._log_params()
        return log_obs, log_a, log_pi
    if isinstance(model, HMMLayer):
        log_obs, _ = model._prep(obs)
        log_a, log_pi = model._log_params()
        return log_obs, log_a, log_pi
    raise TypeError(
        f"Don't know how to extract plain-HMM parts from {type(model)}; "
        "pass parts_fn= for custom or segment models"
    )


def _is_nnx_module(model) -> bool:
    try:
        from flax import nnx
    except ModuleNotFoundError:
        return False
    return isinstance(model, nnx.Module)


def shard_batch(mesh: Mesh, obs: jax.Array) -> jax.Array:
    """Place a ``(B, T, ...)`` batch with B over ``data``, T over ``time``."""
    spec = [None] * obs.ndim
    spec[0] = DATA_AXIS
    if obs.ndim >= 2:
        spec[1] = TIME_AXIS
    return jax.device_put(obs, NamedSharding(mesh, P(*spec)))


def make_sharded_train_step(
    model,
    tx: optax.GradientTransformation,
    mesh: Mesh,
    parts_fn: Callable = hmm_loss_parts,
):
    """Build ``(opt_state, step_fn, params, rest)`` for sharded NLL training.

    ``step_fn(params, rest, opt_state, obs) → (params, opt_state, loss)``
    is a pure jitted function: replicated parameters, ``(data, time)``-
    sharded batch, mean-NLL loss through the block-parallel forward pass.

    ``model`` is an nnx module, or a pytree of parameter arrays; for a
    pytree, ``rest`` is None and ``parts_fn(params, obs)`` must return
    ``(log_obs, log_a, log_pi)``.

    Usage::

        graphdef_step = make_sharded_train_step(model, optax.adam(1e-2), mesh)
        opt_state, step_fn, params, rest = graphdef_step
        for batch in data:
            params, opt_state, loss = step_fn(
                params, rest, opt_state, shard_batch(mesh, batch))
        nnx.update(model, params)
    """
    if _is_nnx_module(model):
        from flax import nnx

        graphdef, params, rest = nnx.split(model, nnx.Param, ...)

        def parts(params, rest, obs):
            return parts_fn(nnx.merge(graphdef, params, rest), obs)
    else:
        params, rest = model, None

        def parts(params, rest, obs):
            return parts_fn(params, obs)

    opt_state = tx.init(params)
    repl = NamedSharding(mesh, P())

    params = jax.device_put(params, repl)
    opt_state = jax.device_put(opt_state, repl)

    def loss_fn(params, rest, obs):
        log_obs, log_a, log_pi = parts(params, rest, obs)
        ll = sharded_log_likelihood(log_obs, log_a, log_pi, mesh)
        return -jnp.mean(ll)

    @jax.jit
    def step_fn(params, rest, opt_state, obs):
        loss, grads = jax.value_and_grad(loss_fn)(params, rest, obs)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return opt_state, step_fn, params, rest
