"""Build, load and count the hand-written CUDA kernels.

All kernels of the package live in `lr2rmats_tpu_torch/csrc/*.cu` behind a
plain C interface.  At first use they are compiled with `nvcc` for Hopper
(`sm_90a`) into one shared library under `build/lr2rmats_tpu_torch/`, named
by a hash of the sources and flags, and loaded with `ctypes`.  A missing
`nvcc` or a failed build raises: there is no fallback.

Launch counts: every kernel wrapper calls `launched(name, rc, start)` right
after its C launch function returns.  That checks the returned
`cudaGetLastError()` code (a refused launch never runs, and a later
synchronize would not report it), adds one to `LAUNCHES[name]`, and closes
the CUDA event pair opened by `start_event()` while a `timing()` block is
active.  Nothing else touches the counts.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
SOURCES = [os.path.join(_PKG, "csrc", name)
           for name in ("chain.cu", "shift_dp.cu")]
BUILD_DIR = os.path.join(_REPO, "build", "lr2rmats_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

KERNELS = ("chain_dp_backtrack", "shift_dp")
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# filled by the first successful load(): wall seconds of the nvcc build (0.0
# when the library was already built) and nvcc's -Xptxas -v report
build_info: Dict[str, object] = {}
_events: Optional[List[Tuple[str, object, object]]] = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels of "
                           "lr2rmats_tpu_torch cannot be built")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libkernels_{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed (rc %d):\n%s\n%s" % (
            res.returncode, " ".join(cmd), res.stderr[-8000:]))
    os.replace(tmp, so)
    build_info["build_s"] = time.perf_counter() - t0
    build_info["ptxas"] = res.stderr


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lr2_chain_dp_backtrack.restype = i
    lib.lr2_chain_dp_backtrack.argtypes = [
        p, p, p, i, i,                      # qpos, rpos, n_anchor, B, A
        i, i, i, i, i,                      # window, k, max_qgap,
        #                                     max_intron, min_intron_gap
        f, f, f, f,                         # gap_open, gap_scale,
        #                                     intron_scale, min_score
        p, p, p, p, p,                      # mask, ps, ss, f_out, parent_out
        p]                                  # stream
    lib.lr2_shift_dp.restype = i
    lib.lr2_shift_dp.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.lr2_cuda_error_string.restype = ctypes.c_char_p
    lib.lr2_cuda_error_string.argtypes = [i]


def load() -> ctypes.CDLL:
    """The kernel library, built from the sources at first use."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if os.path.exists(so):
                build_info.setdefault("build_s", 0.0)
            else:
                _build(so)
            lib = ctypes.CDLL(so)
            _bind(lib)
            _lib = lib
        return _lib


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def start_event():
    """A recorded CUDA start event while a timing() block is active."""
    if _events is None:
        return None
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def launched(name: str, rc: int, start=None) -> None:
    """Account for one launch of kernel `name`; raises if it was refused."""
    if rc != 0:
        msg = _lib.lr2_cuda_error_string(rc).decode() if _lib else "?"
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"error {rc} ({msg})")
    LAUNCHES[name] += 1
    if start is not None and _events is not None:
        import torch
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        _events.append((name, start, end))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def timing():
    """Record a CUDA event pair around every kernel launch made inside the
    block; yields a dict that, once the block exits, maps kernel name to
    its summed device milliseconds."""
    global _events
    import torch
    _events = []
    out: Dict[str, float] = {}
    try:
        yield out
    finally:
        events, _events = _events, None
        torch.cuda.synchronize()
        for name, s, e in events:
            out[name] = out.get(name, 0.0) + s.elapsed_time(e)
