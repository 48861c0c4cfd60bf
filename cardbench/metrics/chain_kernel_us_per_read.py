"""CUDA-event time of the chain kernels (csrc/chain.cu: the fused DP +
backtrack and the DP alone) over the window, from the program's
`ops/_build.py` `timing()`, in microseconds a long read."""

KERNELS = ("chain_dp_backtrack", "chain_dp")


def read(rec):
    ms = rec.get("kernel_ms") or {}
    if "long_reads" not in rec or not any(k in ms for k in KERNELS):
        return None
    return 1e3 * sum(ms.get(k, 0.0) for k in KERNELS) / rec["long_reads"]
