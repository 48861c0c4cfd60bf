"""lr2rmats_tpu_torch — the long-read aligner on PyTorch and CUDA (Hopper).

A second package beside `lr2rmats_tpu`, which stays the reference.  The
host-side modules of the reference (FASTA/SAM I/O, the minimizer index, the
native C++ library, extension, RecordBatch) carry no accelerator code and
are imported unchanged; this package replaces only the accelerator layer:

  * `ops.chain`  — the fused chaining DP + backtrack (csrc/chain.cu), the
    counterpart of lr2rmats_tpu/ops/chain_pallas.py and ops/chain_jax.py;
  * `ops.splice` — the banded shift DP (csrc/shift_dp.cu), the counterpart
    of lr2rmats_tpu/ops/splice_device.py;
  * `align.polish` — the junction-consensus polish with its placement DP on
    the card;
  * `align.batch` — `TorchBatchAligner`, the batched aligner driving them.

Every kernel wrapper launches its hand-written CUDA kernel for a CUDA
tensor and runs its plain PyTorch version for a CPU tensor; there is no
fallback between the two.  This package never imports jax.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
