"""Names loaded on first use, for the parts of the package that need flax.

The functional core (``core``, ``ops``, ``emissions``, ``hmm``, the
functional ``alignment`` entry points, ``parallel``) imports with JAX,
NumPy and optax alone. The flax ``nnx`` model classes, the streaming
processors and the transition toolbox load when first asked for, and say
so when flax is missing.
"""

from __future__ import annotations

import importlib
from typing import Callable, Mapping

_OPTIONAL = ("flax", "orbax")


def lazy_getattr(package: str, names: Mapping[str, str]) -> Callable:
    """A module ``__getattr__`` that imports ``names[name]`` (a module path
    relative to ``package``) on first access and returns its ``name``.
    A missing flax or orbax becomes an ImportError that names it."""

    def __getattr__(name: str):
        module = names.get(name)
        if module is None:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}"
            )
        try:
            mod = importlib.import_module(module, package)
        except ModuleNotFoundError as e:
            missing = (e.name or "").split(".")[0]
            if missing not in _OPTIONAL:
                raise
            raise ImportError(
                f"{package}.{name} needs {missing}, which is not installed"
            ) from e
        return mod if module.lstrip(".") == name else getattr(mod, name)

    return __getattr__
