"""The port's measurement scripts, counterparts of the repository's
scripts/ of the same names: `python -m lr2rmats_tpu_torch.scripts.<name>`."""
