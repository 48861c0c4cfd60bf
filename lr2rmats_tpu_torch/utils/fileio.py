"""Fast whole-file reading.

A single giant read() syscall runs at ~80 MB/s through this environment's
syscall interception layer while 64 MB-chunked os.read reaches ~1 GB/s
(measured: 889 MB SAM in 0.87 s vs 10-19 s for BufferedReader.read(),
np.fromfile, mmap, and unbuffered read alike).  Every whole-file ingest of
a potentially large artifact goes through read_bytes.
"""

from __future__ import annotations

import os

_CHUNK = 1 << 26


def read_into_array(path: str):
    """Whole file into a numpy uint8 array via chunked readinto — no
    intermediate chunk list, no join copy (each fresh copy of an N-byte
    buffer pays the ~150 MB/s first-touch cost again)."""
    import numpy as np
    size = os.path.getsize(path)
    arr = np.empty(size, np.uint8)
    mv = memoryview(arr)
    with open(path, "rb", buffering=0) as f:
        off = 0
        while off < size:
            got = f.readinto(mv[off: off + _CHUNK])
            if not got:
                break
            off += got
    return arr[:off] if off != size else arr


def read_bytes(path: str):
    """Whole file as a bytes-like object via chunked readinto.

    Returns a bytearray for multi-chunk files: the old chunk-list +
    b''.join shape transiently held ~2x the file and paid an extra
    full-buffer first-touch pass (~150 MB/s here) — exactly the cost
    read_into_array's docstring warns about.  Slicing/compare/zlib/struct
    all accept the bytearray unchanged."""
    size = os.path.getsize(path)
    ba = bytearray(size)
    mv = memoryview(ba)
    off = 0
    with open(path, "rb", buffering=0) as f:
        while off < size:
            got = f.readinto(mv[off: off + _CHUNK])
            if not got:
                break
            off += got
    # a file shrinking mid-read is sliced to what arrived
    return ba if off == size else ba[:off]


def count_byte(buf, byte: int) -> int:
    """Chunked single-byte count.  One `buf == b` over a GB-scale buffer
    both materializes a same-size bool temporary AND hits this image's
    pathological large-reduction path (measured 5.1 s vs 0.19 s chunked on
    an 845 MB SAM; 6.9 s vs 0.36 s counting '>' in an 835 MB FASTA)."""
    import numpy as np
    if not isinstance(buf, np.ndarray):
        # bytes slicing compares `bytes == int` -> always False; a silent
        # zero count here under-allocated native output buffers once
        buf = np.frombuffer(buf, np.uint8)
    n = 0
    CH = 1 << 24
    for off in range(0, len(buf), CH):
        n += int(np.count_nonzero(buf[off: off + CH] == byte))
    return n


def count_newlines(buf) -> int:
    """Chunked newline count (see count_byte)."""
    return count_byte(buf, 10)
