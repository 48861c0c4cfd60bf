"""Repository-wide pytest set-up: build the JAX package's native library once.

The JAX package's loader (lr2rmats_tpu/native/lib.py) compiles csrc/lrio.cpp
on first use to one temporary name shared by every process, so test workers
that start together race for it, and a worker that loses runs without the
library: its native tests skip.  pytest loads this file in the process that
starts the workers, before any of them runs, so building the library here
leaves every loader an up-to-date file to open and nothing to compile.

The build is the loader's own command, run under a file lock, to a name of
this process, then moved into place.  It is skipped when the library is
already newer than its source, when LR2RMATS_NO_NATIVE is set (the loader
then uses its numpy fallbacks) and when there is no g++.  A failed build
changes nothing: the loader tries again as before.  This file imports
neither jax nor either package, since the card tests run without it
(`--noconftest`).
"""

import fcntl
import os
import shutil
import subprocess

_REPO = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_REPO, "csrc", "lrio.cpp")
_SO = os.path.join(_REPO, "build", "liblrio.so")


def _fresh() -> bool:
    return (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC))


def build_reference_native() -> None:
    """build/liblrio.so from csrc/lrio.cpp, unless it is fresh or cannot
    be built here."""
    if (os.environ.get("LR2RMATS_NO_NATIVE") or not os.path.exists(_SRC)
            or shutil.which("g++") is None or _fresh()):
        return
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    with open(_SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh():
            return
        tmp = f"{_SO}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                            _SRC, "-o", tmp],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, _SO)
        except (OSError, subprocess.SubprocessError):
            pass
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def pytest_configure(config):
    build_reference_native()
