"""Seconds of the program's `lr2rmats.align.seed_lookup` spans over the
traced window: the device seed lookup (index/seed_device.py
`TorchSeedLookup.lookup`: padding, copy in, both searches, copy back) on
the seed worker, a lane time; in microseconds a long read."""

from cardbench.program_spans import per_item


def read(rec):
    return per_item(rec, "lr2rmats.align.seed_lookup", "long_reads", 1e6)
