"""Accelerator kernels of the port: each module holds a kernel wrapper, its
plain PyTorch version and the launch count (see `_build`)."""
