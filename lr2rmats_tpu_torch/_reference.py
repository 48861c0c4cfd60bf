"""Access to the reference's host-only parallel modules without jax.

`lr2rmats_tpu/parallel/__init__.py` imports the package's JAX mesh module,
so `import lr2rmats_tpu.parallel.shard_index` (hash-range-sharded index,
host code) or `.distributed` (process-group bookkeeping, host code in a
single process) fails where jax is not installed.  `parallel_module` imports
the submodule normally where it can, and otherwise registers the package
without running its `__init__` and imports the submodule from it.
"""

from __future__ import annotations

import importlib
import os
import sys
import types

_PKG = "lr2rmats_tpu.parallel"


def parallel_module(name: str) -> types.ModuleType:
    """`lr2rmats_tpu.parallel.<name>`, importable without jax."""
    try:
        return importlib.import_module(f"{_PKG}.{name}")
    except ImportError:
        if importlib.util.find_spec("jax") is not None:
            raise
    import lr2rmats_tpu
    pkg = types.ModuleType(_PKG)
    pkg.__path__ = [os.path.join(os.path.dirname(lr2rmats_tpu.__file__),
                                 "parallel")]
    pkg.__package__ = _PKG
    sys.modules[_PKG] = pkg
    return importlib.import_module(f"{_PKG}.{name}")
