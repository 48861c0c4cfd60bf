"""Device resolution.

The device is always an explicit argument.  `"cuda"` (the default of every
entry point) requires a card and raises without one; the CPU is used only
when the caller asks for `"cpu"`, where every kernel wrapper runs its plain
PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device` ("cuda", "cuda:N" or "cpu"); raises when a
    CUDA device is asked for and none is available."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is false; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
