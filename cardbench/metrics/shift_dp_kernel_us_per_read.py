"""CUDA-event time of the polish placement DP (csrc/shift_dp.cu) over the
window, from the program's `ops/_build.py` `timing()`, in microseconds a
long read."""


def read(rec):
    ms = rec.get("kernel_ms") or {}
    if "long_reads" not in rec or "shift_dp" not in ms:
        return None
    return 1e3 * ms["shift_dp"] / rec["long_reads"]
