"""lr2rmats_tpu_torch — the long-read aligner on PyTorch and CUDA (Hopper).

A second package beside `lr2rmats_tpu`, which stays the reference.  This
package stands alone: it keeps its own copy of every host module it runs
(FASTA/SAM/GTF I/O, the minimizer index, the native C++ library and its
loader, extension, RecordBatch, the transcript toolkit, the pipeline and
its command line), under the same subpackage and file name as in the
reference, and it imports neither jax nor the reference package.  Its
accelerator layer:

  * `ops.chain`  — the fused chaining DP + backtrack (csrc/chain.cu) and
    the DP alone at any width (csrc/chain_dp.cu), the counterparts of
    lr2rmats_tpu/ops/chain_pallas.py and ops/chain_jax.py;
  * `ops.splice` — the banded shift DP (csrc/shift_dp.cu), the counterpart
    of lr2rmats_tpu/ops/splice_device.py;
  * `align.polish` — the junction-consensus polish with its placement DP on
    the card;
  * `align.batch` — the host `BatchAligner` and `TorchBatchAligner`, the
    batched aligner driving the kernels;
  * `diag.chain_parity` — the chain-parity diagnostic and its log probe
    (csrc/log_probe.cu), the counterpart of scripts/diag_chain_pallas.py.

Every kernel wrapper launches its hand-written CUDA kernel for a CUDA
tensor and runs its plain PyTorch version for a CPU tensor; there is no
fallback between the two.  The host modules import no torch, so the host
subcommands of the command line start without it.
"""

__version__ = "0.1.0"

# the program name: the default source column of the GTFs the pipeline and
# the subcommands write, kept equal to the reference's so that the outputs
# are the same bytes
PROG = "lr2rmats_tpu"


def _tune_allocator() -> None:
    """Keep freed large buffers in the process heap: raise glibc's mmap and
    trim thresholds so that big numpy allocations are served from the
    retained heap instead of fresh (first-touch faulted) pages each batch."""
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 1 << 30)   # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)   # M_TRIM_THRESHOLD
    except Exception:
        pass


_tune_allocator()


def __getattr__(name):
    # `resolve_device` imports torch: only on first use, so that the host
    # modules stay importable without it
    if name == "resolve_device":
        from .device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["PROG", "resolve_device"]
