"""ctypes loader for the native hot-path library (csrc/lrio.cpp).

Builds `build/lr2rmats_tpu_torch/liblrio.so` from the repository's
csrc/lrio.cpp with g++ on first use, and again whenever the source is newer
than the library.  The build is safe under many processes starting at once
(pytest workers, the processes of one pipeline group): each process holds
an exclusive `fcntl.flock` on `liblrio.so.lock` around the check, the build
and the rename, compiles to a temporary name unique to the process, and
renames it into place; a process that waited on the lock finds the finished
library and loads it.  So every process of a run answers `get_lib()` the
same way.

Host callers keep a numpy fallback for a missing library (no g++, or
LR2RMATS_NO_NATIVE=1); the device junction path of align/batch.py does not
and raises instead.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "csrc", "lrio.cpp")
_BUILD_DIR = os.path.join(_REPO, "build", "lr2rmats_tpu_torch")
_SO = os.path.join(_BUILD_DIR, "liblrio.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _stale(so: str, src: str) -> bool:
    return not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(
        src)


def _ensure_built(src: str, so: str) -> bool:
    """Build `so` from `src` unless it is up to date; True when `so` is
    ready to load.  Race-free across processes (see the module docstring)."""
    if not _stale(so, src):
        return True
    try:
        os.makedirs(os.path.dirname(so), exist_ok=True)
        lock = open(so + ".lock", "a")
    except OSError:                      # read-only checkout
        return False
    with lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale(so, src):          # built while this process waited
            return True
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", src, "-o",
               tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
            os.replace(tmp, so)
        except Exception:
            return False
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, or None where it cannot be built or loaded (or
    LR2RMATS_NO_NATIVE is set).  Built and loaded once per process."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("LR2RMATS_NO_NATIVE"):
            return None
        if not os.path.exists(_SRC) or not _ensure_built(_SRC, _SO):
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        _bind(lib)
        _lib = lib
        return _lib


def have_native() -> bool:
    return get_lib() is not None


def _bind(lib: ctypes.CDLL) -> None:
    """ctypes signatures of every entry point the package calls."""
    c_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    c_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    c_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    c_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    c_i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")

    lib.refine_splice_indel_c.restype = ctypes.c_int
    lib.refine_splice_indel_c.argtypes = [
        c_u8p, ctypes.c_int, c_u8p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        c_i32p, ctypes.POINTER(ctypes.c_int32),
        c_i32p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double)]

    lib.extract_minimizers_c.restype = ctypes.c_int64
    lib.extract_minimizers_c.argtypes = [
        c_u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        c_u64p, c_i64p, c_i8p]

    lib.extract_minimizers_batch_c.restype = ctypes.c_int
    lib.extract_minimizers_batch_c.argtypes = [
        c_u8p, c_i64p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, c_u64p, c_i64p, c_i8p, c_i64p]

    lib.refine_splice_c.restype = ctypes.c_int
    lib.refine_splice_c.argtypes = [
        c_u8p, ctypes.c_int, c_u8p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32)]

    lib.backtrack_c.restype = ctypes.c_int
    lib.backtrack_c.argtypes = [
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        c_i64p, ctypes.c_int64, ctypes.c_double, ctypes.c_int,
        c_i64p, ctypes.POINTER(ctypes.c_int64),
        c_i64p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]

    lib.extend_chain_c.restype = ctypes.c_int
    lib.extend_chain_c.argtypes = [
        c_u8p, ctypes.c_int64, c_u8p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        c_i64p, c_i64p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), c_i32p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32)]

    lib.collect_gaps_batch_c.restype = ctypes.c_int
    lib.collect_gaps_batch_c.argtypes = [
        c_u8p, c_i64p, c_u8p, ctypes.c_int64,
        c_i32p, c_i8p, c_i64p, c_i64p, c_i64p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        c_i64p, c_i32p, c_i8p, c_u8p, c_i32p, c_i64p, c_i64p,
        c_i32p, c_i32p, c_i32p, c_i32p, c_i32p, ctypes.c_int]

    lib.assemble_ops_batch_c.restype = ctypes.c_int
    lib.assemble_ops_batch_c.argtypes = [
        c_u8p, c_i64p, c_u8p, ctypes.c_int64, c_i64p, ctypes.c_int,
        c_i32p, c_i8p,
        c_i64p, c_i32p,
        c_i8p, c_u8p, c_i32p, c_i64p, c_i64p, c_i32p, c_i32p,
        c_i32p, c_i32p, c_i32p,
        c_i64p, c_u8p, c_i64p, c_i32p,
        c_i32p, c_i32p, c_i32p, c_i32p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        c_i64p, c_i32p, c_i32p, c_i64p, c_i64p, c_i32p, c_i32p]

    lib.junction_cell_ops_batch_c.restype = ctypes.c_int
    lib.junction_cell_ops_batch_c.argtypes = [
        c_u8p, c_i64p, c_u8p, ctypes.c_int64, c_i64p, c_i64p,
        c_i32p, c_i32p, c_i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        c_i32p, c_i32p, c_i32p, c_i32p]

    lib.extend_chain_batch_c.restype = ctypes.c_int
    lib.extend_chain_batch_c.argtypes = [
        c_u8p, c_i64p, c_u8p, ctypes.c_int64,
        c_i64p, ctypes.c_int,
        c_i32p, c_i8p, c_i64p, c_i64p, c_i64p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        c_i64p, c_i32p, c_i32p, c_i64p, c_i64p, c_i32p, c_i32p]

    lib.build_kmer_table_c.restype = ctypes.c_int64
    lib.build_kmer_table_c.argtypes = [
        c_u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
        c_u64p, c_i64p]

    lib.fasta_parse_c.restype = ctypes.c_int64
    lib.fasta_parse_c.argtypes = [
        c_u8p, ctypes.c_int64, c_u8p, c_i64p, c_i64p, c_i32p,
        ctypes.POINTER(ctypes.c_int64)]

    lib.sort_minimizer_table_c.restype = ctypes.c_int
    lib.sort_minimizer_table_c.argtypes = [
        c_u64p, c_i64p, c_i8p, ctypes.c_int64, ctypes.c_int, c_i64p]

    lib.cap_occurrences_c.restype = ctypes.c_int64
    lib.cap_occurrences_c.argtypes = [
        c_u64p, c_i64p, c_i8p, ctypes.c_int64, ctypes.c_int64]

    lib.kmer_scan_c.restype = None
    lib.kmer_scan_c.argtypes = [
        c_u8p, ctypes.c_int64, ctypes.c_int, c_u64p, c_i8p]

    lib.kmers_at_c.restype = None
    lib.kmers_at_c.argtypes = [
        c_u8p, ctypes.c_int64, ctypes.c_int, c_i64p, ctypes.c_int64,
        c_u64p, c_i8p]

    lib.lookup_range_c.restype = None
    lib.lookup_range_c.argtypes = [
        c_u64p, ctypes.c_int64, c_i64p, ctypes.c_int64, ctypes.c_int,
        c_u64p, ctypes.c_int64, c_i64p, c_i64p]

    lib.format_sam_batch_c.restype = ctypes.c_int64
    lib.format_sam_batch_c.argtypes = [
        c_u8p, c_i64p, c_i32p, c_i32p, c_i64p, c_i32p,
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"), c_i64p,
        c_u8p, c_i64p, c_i32p, c_i8p,
        c_i64p, c_i64p, c_i32p, c_i8p,
        c_u8p, c_i64p, ctypes.c_int64, c_u8p, ctypes.c_int64]

    lib.lookup_range_mt_c.restype = None
    lib.lookup_range_mt_c.argtypes = [
        c_u64p, ctypes.c_int64, c_i64p, ctypes.c_int64, ctypes.c_int,
        c_u64p, ctypes.c_int64, c_i64p, c_i64p, ctypes.c_int]

    lib.gather_hits_c.restype = None
    lib.gather_hits_c.argtypes = [
        c_i64p, c_i8p, c_i64p, c_i64p, c_i64p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p, c_i8p, ctypes.c_int]

    lib.scatter_hits_c.restype = None
    lib.scatter_hits_c.argtypes = [
        c_i64p, c_i8p, c_i32p, c_i64p, c_i64p, ctypes.c_int64,
        c_i64p, c_i64p, c_i8p, ctypes.c_int]

    lib.hamming_pairs_c.restype = None
    lib.hamming_pairs_c.argtypes = [
        c_u8p, ctypes.c_int64, c_u8p, c_i64p, c_i32p, c_i64p,
        ctypes.c_int64, c_i32p]

    # RAW POINTER binding (hot path: called per bam x anno overlap;
    # ndpointer validation costs more than the C work at 500k+ calls).
    # Callers pass arr.ctypes.data of C-contiguous arrays.
    lib.check_splice_site_c.restype = ctypes.c_int
    lib.check_splice_site_c.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int]

    lib.format_gtf_c.restype = ctypes.c_int64
    lib.format_gtf_c.argtypes = [
        c_u8p, c_i64p, c_u8p, ctypes.c_int64,
        c_i32p, c_u8p, c_i32p, c_i32p, c_i32p,
        c_i32p, c_i32p, ctypes.c_int64, c_i32p,
        c_u8p, c_i64p, ctypes.c_int64, c_u8p, ctypes.c_int64]

    lib.compact_minimizers_c.restype = None
    lib.compact_minimizers_c.argtypes = [
        c_u64p, c_i64p, c_i8p, c_i64p, c_i64p, c_i64p, ctypes.c_int64,
        c_u64p, c_i64p, c_i8p, c_i32p, ctypes.c_int32]

    lib.expand_anchors_c.restype = None
    lib.expand_anchors_c.argtypes = [
        c_i64p, c_i64p, c_i64p, ctypes.c_int64,
        c_i64p, c_i8p, c_i64p, c_i8p, c_i32p, c_i64p, ctypes.c_int32,
        c_i64p, c_i8p, c_i32p, c_i64p, c_u64p, ctypes.c_int32,
        ctypes.c_int32]

    lib.format_bed12_c.restype = ctypes.c_int64
    lib.format_bed12_c.argtypes = [
        c_u8p, c_i64p, c_u8p, c_i64p,
        c_i32p, c_u8p, c_i32p, c_i64p, c_i64p,
        c_i64p, c_i64p, c_i64p,
        ctypes.c_int64, c_u8p, ctypes.c_int64]

    c_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.chain_small_batch_c.restype = None
    lib.chain_small_batch_c.argtypes = [
        c_i32p, c_i32p, c_i32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int64, ctypes.c_double,
        c_u8p, c_f32p, c_f32p]

    lib.format_detail_c.restype = ctypes.c_int64
    lib.format_detail_c.argtypes = [
        c_u8p, c_i64p, c_u8p, c_i64p, c_u8p, c_i64p,   # name/gid/gname
        c_u8p, c_i64p,                                  # chrom
        c_i32p, c_u8p, c_u8p, c_u8p, c_i32p,            # tid/rev/known/site/en
        c_i32p, c_i32p, ctypes.c_int64,                 # es/ee/ew
        c_u8p, ctypes.c_int64, c_u8p, ctypes.c_int64,   # ne/ns flags
        c_u8p, ctypes.c_int64, c_u8p, ctypes.c_int64,   # nj/uj flags
        ctypes.c_int64, c_u8p, ctypes.c_int64]

    # RAW POINTER binding (arrays passed by .ctypes.data)
    lib.merge_into_batch_c.restype = ctypes.c_int64
    lib.merge_into_batch_c.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_void_p]

    # RAW POINTER binding (full-array sweep; arrays passed by .ctypes.data)
    lib.classify_batch_c.restype = ctypes.c_int
    lib.classify_batch_c.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_void_p]

    lib.sj_check_batch_c.restype = ctypes.c_int
    lib.sj_check_batch_c.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]

    lib.split_trans_batch_c.restype = ctypes.c_int
    lib.split_trans_batch_c.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p]

    lib.filter_sam_c.restype = ctypes.c_int64
    lib.filter_sam_c.argtypes = [
        c_u8p, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        c_i64p, c_i64p, c_i64p, ctypes.c_int64,
        c_i64p, c_i64p, c_i64p, c_i64p, ctypes.c_int64,
        ctypes.c_int]

    lib.sam_to_exons_c.restype = ctypes.c_int64
    lib.sam_to_exons_c.argtypes = [
        c_u8p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64,
        c_i32p, np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        c_i64p, c_i64p, c_i32p, c_i32p, c_i32p,
        ctypes.POINTER(ctypes.c_int64)]

    lib.check_iden_c.restype = ctypes.c_int
    lib.check_iden_c.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64]

    lib.hamming_many_c.restype = None
    lib.hamming_many_c.argtypes = [
        c_u8p, ctypes.c_int64, c_u8p, ctypes.c_int, c_i64p,
        ctypes.c_int, c_i32p]
