"""CUDA-event time of the short-read Hamming verify (csrc/hamming.cu) over
the window, from the program's `ops/_build.py` `timing()`, in microseconds
a thousand short reads."""


def read(rec):
    ms = rec.get("kernel_ms") or {}
    if "short_reads" not in rec or "hamming" not in ms:
        return None
    return 1e6 * ms["hamming"] / rec["short_reads"]
