"""Minimizer-table lookup on the card (the seeding stage's device path).

Counterpart of lr2rmats_tpu/index/seed_device.py `DeviceSeedLookup`: the
sorted index table stays resident on the device as int32 (2k-bit hashes fit
whenever k <= 15, the production default), and a read batch's lookups are
one `torch.searchsorted` left and right, with one [2, nq] copy back.  The
reference's lookup is `jnp.searchsorted`, an XLA op and not a Pallas
kernel, so the torch op is its counterpart.  (lo, hi) equal
`MinimizerIndex.lookup` exactly, with the same int64 contract.
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device

_PAD = (1 << 31) - 1      # above every 2k-bit hash: lo == hi == n


def _next_pow2(n: int, floor: int = 4096) -> int:
    return 1 << max(int(n - 1).bit_length(), floor.bit_length() - 1)


class TorchSeedLookup:
    """searchsorted (lo, hi) ranges against a device-resident hash table;
    drop-in for `MinimizerIndex.lookup`.  Counts its calls and wall."""

    @staticmethod
    def supports(index) -> bool:
        """2*k <= 31 (the masked hashes fit int32) and an int32-addressable
        flat table; sharded indexes (parallel/shard_index.py) hold no flat
        `.hashes` table and keep their own lookup."""
        hashes = getattr(index, "hashes", None)
        return (hashes is not None
                and 2 * int(index.k) <= 31
                and len(hashes) < (1 << 31) - 1)

    def __init__(self, index, device="cuda"):
        if not self.supports(index):
            raise ValueError(
                "device seed lookup needs 2*k<=31 (int32 hash lanes) and "
                "an int32-addressable table")
        self.device = resolve_device(device)
        self.n = int(len(index.hashes))
        self.table = torch.from_numpy(
            index.hashes.astype(np.int32)).to(self.device)
        self.calls = 0
        self.wall_s = 0.0

    def lookup(self, qhashes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(lo, hi) int64 per query hash."""
        nq = len(qhashes)
        if nq == 0:
            z = np.zeros(0, np.int64)
            return z, z
        t0 = time.perf_counter()
        # queries padded to a power of two, as the reference pads them, so
        # the allocator sees few distinct sizes across batches
        q = np.full(_next_pow2(nq), _PAD, np.int32)
        q[:nq] = qhashes.astype(np.int32)
        tq = torch.from_numpy(q).to(self.device)
        out = torch.stack([
            torch.searchsorted(self.table, tq, out_int32=True),
            torch.searchsorted(self.table, tq, right=True, out_int32=True),
        ]).cpu().numpy()
        self.calls += 1
        self.wall_s += time.perf_counter() - t0
        return (out[0, :nq].astype(np.int64), out[1, :nq].astype(np.int64))
