"""Build, load and count the hand-written CUDA kernels.

All kernels of the package live in `lr2rmats_tpu_torch/csrc/*.cu` behind a
plain C interface.  At first use they are compiled with `nvcc` for Hopper
(`sm_90a`), one `nvcc -c` per source, all started together, then linked
into one shared library under `build/lr2rmats_tpu_torch/`, named by a hash
of the sources and flags, and loaded with `ctypes`.  A missing `nvcc` or a
failed build raises: there is no fallback.

Launch counts: every kernel wrapper calls `launched(name, rc, start,
device)` right after its C launch function returns.  That checks the
returned `cudaGetLastError()` code (a refused launch never runs, and a
later synchronize would not report it), adds one to `LAUNCHES[name]` and
to `CARD_LAUNCHES[card index]`, and closes the CUDA event pair opened by
`start_event(device)` on the launching card while a `timing()` block is
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
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
SOURCES = [os.path.join(_PKG, "csrc", name)
           for name in ("chain.cu", "chain_dp.cu", "shift_dp.cu",
                        "combine.cu", "hamming.cu", "log_probe.cu")]
BUILD_DIR = os.path.join(_REPO, "build", "lr2rmats_tpu_torch")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]

KERNELS = ("chain_dp_backtrack", "chain_dp", "shift_dp", "combine",
           "hamming", "log_probe")
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
# launches of every kernel per card index
CARD_LAUNCHES: Dict[int, int] = {}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# filled by the first successful load(): wall seconds of the nvcc build (0.0
# when the library was already built) and nvcc's -Xptxas -v report
build_info: Dict[str, object] = {}
_events: Optional[List[Tuple[str, object, object, object]]] = None


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
    """Compile every source to an object with its own nvcc, all at once,
    then link the objects into `so`."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = f"{so}.{tag}"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            for src in SOURCES]
    nvcc = _nvcc()

    def run(cmd):
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed (rc %d):\n%s\n%s" % (
                res.returncode, " ".join(cmd), res.stderr[-8000:]))
        return res.stderr

    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            reports = list(pool.map(run, [
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                for src, obj in zip(SOURCES, objs)]))
        run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs])
        os.replace(tmp, so)
    finally:
        for f in (*objs, tmp):
            if os.path.exists(f):
                os.remove(f)
    build_info["build_s"] = time.perf_counter() - t0
    build_info["ptxas"] = "".join(reports)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
# argument types of each C entry point; each returns a cudaError_t as int
SIGNATURES: Dict[str, List[object]] = {
    "lr2_chain_dp_backtrack": [
        _P, _P, _P, _I, _I,                 # qpos, rpos, n_anchor, B, A
        _I, _I, _I, _I, _I,                 # window, k, max_qgap,
        #                                     max_intron, min_intron_gap
        _F, _F, _F, _F,                     # gap_open, gap_scale,
        #                                     intron_scale, min_score
        _P, _P, _P, _P, _P,                 # mask, ps, ss, f_out, parent_out
        _P],                                # stream
    "lr2_chain_dp": [
        _P, _P, _P, _I, _I,                 # qpos, rpos, n_anchor, B, A
        _I, _I, _I, _I, _I,                 # window, k, max_qgap,
        #                                     max_intron, min_intron_gap
        _F, _F, _F,                         # gap_open, gap_scale,
        #                                     intron_scale
        _P, _P, _P],                        # f_out, parent_out, stream
    "lr2_shift_dp": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "lr2_combine": [
        _P, _P, _P, _P, _P, _P, _P, _P,     # SL, SR, m, span, dok, aok, el, er
        _I, _I, _I, _LL,                    # M, G, B, min_intron
        _P, _P, _P, _P, _P, _P,             # score, j, cl, cr, vote, found
        _P],                                # stream
    "lr2_hamming": [
        _P, _LL, _P, _P, _P, _P, _LL, _P,   # buf, n, comb, comb_off, rid,
        #                                     pos, C, mm
        _P],                                # stream
    "lr2_log_probe": [_P, _P, _LL, _P],     # x, y, n, stream
}


def bind(lib: ctypes.CDLL, names=None) -> None:
    """Set the ctypes signatures of the entry points `names` (every one of
    SIGNATURES and lr2_cuda_error_string by default) on `lib`."""
    for name in SIGNATURES if names is None else names:
        fn = getattr(lib, name)
        fn.restype = _I
        fn.argtypes = SIGNATURES[name]
    if names is None or hasattr(lib, "lr2_cuda_error_string"):
        lib.lr2_cuda_error_string.restype = ctypes.c_char_p
        lib.lr2_cuda_error_string.argtypes = [_I]


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
            bind(lib)
            _lib = lib
        return _lib


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def start_event(device):
    """A CUDA start event recorded on `device`'s current stream while a
    timing() block is active, else None."""
    if _events is None:
        return None
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def launched(name: str, rc: int, start, device) -> None:
    """Account for one launch of kernel `name` on `device`; raises if it
    was refused."""
    if rc != 0:
        msg = _lib.lr2_cuda_error_string(rc).decode() if _lib else "?"
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"error {rc} ({msg})")
    LAUNCHES[name] += 1
    card = device.index if device.index is not None else 0
    CARD_LAUNCHES[card] = CARD_LAUNCHES.get(card, 0) + 1
    if start is not None and _events is not None:
        import torch
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(device))
        _events.append((name, device, start, end))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    CARD_LAUNCHES.clear()


@contextlib.contextmanager
def timing():
    """Record a CUDA event pair around every kernel launch made inside the
    block; yields a dict that, once the block exits, maps kernel name to
    its summed device milliseconds.  Every card that launched inside the
    block is synchronized before the events are read."""
    global _events
    import torch
    _events = []
    out: Dict[str, float] = {}
    try:
        yield out
    finally:
        events, _events = _events, None
        for dev in {d for _, d, _, _ in events}:
            torch.cuda.synchronize(dev)
        for name, _, s, e in events:
            out[name] = out.get(name, 0.0) + s.elapsed_time(e)
