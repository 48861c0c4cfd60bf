"""Diagnostics of the port: `python -m lr2rmats_tpu_torch.diag.<name>`."""
