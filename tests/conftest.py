"""Test configuration: an 8-device virtual CPU platform by default.

Multi-device sharding tests run on a virtual CPU mesh (no cluster
needed), per the framework's test strategy (SURVEY.md §4): sharded
results must match single-device results exactly. The trellis kernels run
here in the Pallas interpreter; tests marked ``gpu`` skip unless
``JAX_PLATFORMS`` selects a GPU (see tests/test_gpu.py).

Must run before the first `import jax` anywhere in the test session.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# The CPU suite verifies semantics, not codegen: skipping XLA's
# expensive optimization passes cuts suite wall-clock ~30% without
# changing any result (the optimized path runs on the GPU in
# chip_smoke.py and bench.py). PYTORCH_HMM_TPU_FULL_OPT=1 restores full
# optimization.
if os.environ.get("PYTORCH_HMM_TPU_FULL_OPT") != "1":
    os.environ.setdefault("JAX_DISABLE_MOST_OPTIMIZATIONS", "1")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    import numpy as np

    return np.random.default_rng(42)


@pytest.fixture
def kernel_dispatch(monkeypatch):
    """Route ``ops.auto_*`` to the trellis kernels, run in the Pallas
    interpreter, as the dispatch routes them on the GPU."""
    import functools

    from pytorch_hmm_tpu import ops
    from pytorch_hmm_tpu.ops import trellis

    monkeypatch.setattr(
        ops, "trellis_applies",
        lambda k, la: la.ndim == 2 and k <= ops.TRELLIS_MAX_K,
    )
    monkeypatch.setattr(ops, "trellis_viterbi", functools.partial(
        trellis.trellis_viterbi, interpret=True))
    monkeypatch.setattr(ops, "trellis_forward_backward", functools.partial(
        trellis.trellis_forward_backward, interpret=True))


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """Drop compiled executables between test modules.

    The full suite compiles hundreds of distinct programs; keeping them
    all live has pushed the process past 5 GB and (rarely) segfaulted
    the XLA CPU compiler under memory pressure. Modules don't share
    shapes, so this costs nothing.
    """
    yield
    jax.clear_caches()
