"""Importing the package must not initialize the XLA backend.

``jax.distributed.initialize`` (multi-host setup) demands a pristine
process — any earlier ``jax.devices()`` / ``jax.process_index()`` call
poisons it. The reference runs ``auto_configure()`` at import
(``__init__.py:476-477``); we promise the opposite, and this guards the
promise (a module-level ``get_logger`` call once broke it silently).
"""

import os
import subprocess
import sys


def test_package_import_is_backend_free():
    probe = (
        "import jax\n"
        "import pytorch_hmm_tpu\n"
        "import pytorch_hmm_tpu.parallel\n"
        "assert not jax._src.xla_bridge._backends, "
        "'package import initialized the XLA backend'\n"
        "print('BACKEND_FREE')\n"
    )
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-c", probe],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "BACKEND_FREE" in r.stdout


def test_functional_core_imports_without_flax():
    """flax and orbax are optional: with both unimportable the package,
    its functional entry points and the sharded trainer still import, and
    the nnx model classes raise an ImportError that names flax."""
    probe = (
        "import sys\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['orbax'] = None\n"
        "import pytorch_hmm_tpu as ph\n"
        "from pytorch_hmm_tpu import core, ops, emissions, em, parallel\n"
        "from pytorch_hmm_tpu.hmm import HMM\n"
        "from pytorch_hmm_tpu.alignment import (\n"
        "    ctc_loss, ctc_viterbi_alignment, dtw_alignment)\n"
        "from pytorch_hmm_tpu.parallel import make_sharded_train_step\n"
        "for name in ('MixtureGaussianHMMLayer', 'StreamingHMMProcessor'):\n"
        "    try:\n"
        "        getattr(ph, name)\n"
        "    except ImportError as e:\n"
        "        assert 'flax' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError(name + ' loaded without flax')\n"
        "print('FLAX_FREE')\n"
    )
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-c", probe],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "FLAX_FREE" in r.stdout


def test_no_private_jax_api_in_library():
    """The library must not touch ``jax._src`` (VERDICT r2 item 10):
    private internals move between JAX releases. (This test file's own
    subprocess probe is the one sanctioned use — it inspects JAX state
    from the *outside* and is trivially fixable if it ever breaks.)"""
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(repo_root, "pytorch_hmm_tpu")
    offenders = []
    for dirpath, _dirnames, filenames in os.walk(pkg):
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as f:
                for lineno, line in enumerate(f, 1):
                    if "jax._src" in line:
                        offenders.append(f"{path}:{lineno}: {line.strip()}")
    assert not offenders, "\n".join(offenders)
