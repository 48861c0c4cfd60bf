"""Hash-range-sharded minimizer index with its multi-process arm on the
port's process group.

`ShardedMinimizerIndex` subclasses the reference's
(lr2rmats_tpu/parallel/shard_index.py) and overrides only the two places
that reach the reference's `.distributed` module:

  * `build(..., local_shard=sid)`: this process extracts only its hash
    range, and the occurrence histogram is summed over the process group
    so that the cap equals the unsharded build's;
  * `_lookup_distributed`: the collective lookup.  Every process
    all-gathers the batch's query hashes, answers those in its range, and
    the hits come back in a second all-gather, in the reference's v2 frame
    format and through the native `gather_hits_c` / `scatter_hits_c`.

Both go through parallel/distributed.py `gather_blobs`.  The in-process
arm (all shards resident) and everything else is inherited.  As in the
reference, every process calls the collective lookup in lockstep from one
thread: drive batches with `dispatch_batch` / `finish_batch`, not
`align_seqset_packed` (which refuses a `local_only` index).
"""

from __future__ import annotations

import struct
import time
from typing import List, Optional, Tuple

import numpy as np

from lr2rmats_tpu.index.minimizer import K_DEFAULT, W_DEFAULT, MinimizerIndex
from lr2rmats_tpu.native import get_lib
from lr2rmats_tpu.utils import log

from .._reference import parallel_module
from .distributed import gather_blobs, multihost_info

_ref = parallel_module("shard_index")
shard_of = _ref.shard_of


class ShardedMinimizerIndex(_ref.ShardedMinimizerIndex):
    """The reference's sharded index, collective over the port's group."""

    @classmethod
    def build(cls, genome, n_shards: int, k: int = K_DEFAULT,
              w: int = W_DEFAULT, max_occ_frac: float = 2e-4,
              min_max_occ: int = 50, local_shard: Optional[int] = None
              ) -> "ShardedMinimizerIndex":
        """local_shard=None builds every shard in this process (the
        reference's code); local_shard=sid builds only that shard, with
        the occurrence histogram summed over the process group."""
        if local_shard is None:
            return super().build(genome, n_shards, k, w, max_occ_frac,
                                 min_max_occ)
        h, p, s, hist = MinimizerIndex._extract_sorted(
            genome, k, w, (local_shard, n_shards))
        if multihost_info()[1] > 1:
            ghist = np.sum([np.frombuffer(b, np.int64)
                            for b in gather_blobs(hist.tobytes())], axis=0)
        else:
            ghist = hist
        cap = MinimizerIndex.occ_cap_from_hist(ghist, max_occ_frac,
                                               min_max_occ)
        h, p, s = MinimizerIndex._apply_cap(h, p, s, cap, hist)
        idx = MinimizerIndex(k, w, h, p, s, genome.offsets.copy(),
                             list(genome.names), cap)
        shards: List[Optional[MinimizerIndex]] = [None] * n_shards
        shards[local_shard] = idx
        log("index", "local index shard %d/%d built: %d minimizers "
            "(max_occ=%d)", local_shard, n_shards, len(h), cap)
        out = cls(shards, local_only=True)
        out.local_shard = local_shard
        return out

    def _answer(self, qh: np.ndarray, src: int, n_threads: int) -> bytes:
        """One v2 frame: header "<qqq" (src, m, pos_is_u32), idx int32[m],
        cnt int32[m], pos uint32|int64[total], strand int8[total] for the
        m queries of process `src` that land in this process's range."""
        shard = self.shards[self.local_shard]
        if self._pos_is_u32 is None:
            self._pos_is_u32 = bool(len(shard.pos) == 0 or
                                    int(shard.pos.max()) < (1 << 32))
        p32 = self._pos_is_u32
        mine = np.nonzero(shard_of(qh, self.n_shards, self.k) ==
                          self.local_shard)[0]
        if not len(mine):
            return struct.pack("<qqq", src, 0, int(p32))
        lo, hi = shard.lookup(np.ascontiguousarray(qh[mine]), n_threads)
        cnt = (hi - lo).astype(np.int64)
        total = int(cnt.sum())
        ooff = np.cumsum(cnt) - cnt
        pdt = np.uint32 if p32 else np.int64
        lib = get_lib()
        if lib is not None:
            import ctypes
            out_pos = np.empty(total, pdt)
            out_str = np.empty(total, np.int8)
            lib.gather_hits_c(
                np.ascontiguousarray(shard.pos, np.int64),
                np.ascontiguousarray(shard.strand, np.int8),
                np.ascontiguousarray(lo, np.int64), cnt, ooff, len(mine),
                int(p32), out_pos.ctypes.data_as(ctypes.c_void_p), out_str,
                n_threads)
        else:
            at = (np.repeat(lo - ooff, cnt) + np.arange(total)).astype(
                np.int64)
            out_pos = shard.pos[at].astype(pdt)
            out_str = shard.strand[at].astype(np.int8)
        return (struct.pack("<qqq", src, len(mine), int(p32)) +
                mine.astype(np.int32).tobytes() +
                cnt.astype(np.int32).tobytes() +
                out_pos.tobytes() + out_str.tobytes())

    def _lookup_distributed(self, qhashes: np.ndarray, n_threads: int
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """Collective lookup: all-gather the query hashes, answer the local
        range, all-gather the (pos, strand) hits back.  Hit order within a
        query is the unsharded table's (a hash lives in one shard).  Sets
        self.pos / self.strand to this call's hits; the returned (lo, hi)
        index into them."""
        pid, nproc = multihost_info()
        if nproc != self.n_shards:
            # with fewer processes than shards, queries in an unowned range
            # would come back empty and their seeds would silently vanish
            raise ValueError(
                f"sharded collective lookup needs one process per shard: "
                f"{nproc} processes != {self.n_shards} shards")
        st = self.coll_stats
        q = np.ascontiguousarray(qhashes, np.uint64)
        t0 = time.perf_counter()
        queries = [np.frombuffer(b, np.uint64)
                   for b in gather_blobs(q.tobytes())]
        st["gather_q_s"] += time.perf_counter() - t0
        st["q_mb"] += q.nbytes / 1e6
        t0 = time.perf_counter()
        payload = b"".join(self._answer(qh, src, n_threads)
                           for src, qh in enumerate(queries))
        st["lookup_s"] += time.perf_counter() - t0
        st["a_mb"] += len(payload) / 1e6
        t0 = time.perf_counter()
        answers = gather_blobs(payload)
        st["gather_a_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        # pass 1: the frames addressed to this process, per-query counts
        counts = np.zeros(len(q), np.int64)
        parsed = []
        for blob in answers:
            off = 0
            while off < len(blob):
                src, m, p32 = struct.unpack_from("<qqq", blob, off)
                off += 24
                psize = 4 if p32 else 8
                cnt = np.frombuffer(blob, np.int32, m, off + 4 * m)
                total = int(cnt.sum(dtype=np.int64))
                if src == pid and m:
                    idx = np.frombuffer(blob, np.int32, m, off)
                    ppos = np.frombuffer(blob, np.uint32 if p32 else np.int64,
                                         total, off + 8 * m).astype(np.int64)
                    pstr = np.frombuffer(blob, np.int8, total,
                                         off + 8 * m + psize * total)
                    counts[idx] = cnt
                    parsed.append((idx, cnt.astype(np.int64), ppos, pstr))
                off += 8 * m + (psize + 1) * total
        lo = (np.cumsum(counts) - counts).astype(np.int64)
        hi = lo + counts
        # pass 2: scatter into this call's hit table
        self.pos = np.zeros(int(counts.sum()), np.int64)
        self.strand = np.zeros(len(self.pos), np.int8)
        lib = get_lib()
        for idx, cnt, ppos, pstr in parsed:
            soff = np.cumsum(cnt) - cnt
            if lib is not None:
                lib.scatter_hits_c(
                    np.ascontiguousarray(ppos, np.int64),
                    np.ascontiguousarray(pstr, np.int8),
                    np.ascontiguousarray(idx, np.int32), cnt, soff,
                    len(idx), lo, self.pos, self.strand, n_threads)
            else:
                dest = np.repeat(lo[idx] - soff, cnt) + np.arange(len(ppos))
                self.pos[dest] = ppos
                self.strand[dest] = pstr
        st["scatter_s"] += time.perf_counter() - t0
        return lo, hi
