"""The benchmark of lr2rmats_tpu_torch on the card: see README.md."""
