"""Minimizer-table lookup and hit selection on the card (the seeding
stage's device path).

Counterpart of lr2rmats_tpu/index/seed_device.py `DeviceSeedLookup`: the
sorted index table stays resident on the device as int32 (2k-bit hashes fit
whenever k <= 15, the production default), and a read batch's lookups are
one `torch.searchsorted` left and right, with one [2, nq] copy back.  The
reference's lookup is `jnp.searchsorted`, an XLA op and not a Pallas
kernel, so the torch op is its counterpart.  (lo, hi) equal
`MinimizerIndex.lookup` exactly, with the same int64 contract.

Where the index's global positions fit 32 bits, the table's positions and
strands are resident too, packed as one int64 `pos << 1 | strand`, and
`TorchSeedLookup.select` keeps the lookup's ranges on the card: the
`seed_select` kernel (csrc/seed_select.cu; plain version
`seed_select_reference`) expands, sorts, groups and selects each read's
hits as the host path of align/batch.py `_batch_anchors` does, and only
the kept anchors and each row's description come back.  A read with more
hits than one block's shared memory holds (`SELECT_CAP`) is left to the
host path: its queries' ranges come back instead.

Under tracing (utils/log.py) each lookup is the span
`lr2rmats.align.seed_lookup` (padding, copy in, both searches; `lookup`
adds the copy back of the ranges), and each selection the span
`lr2rmats.align.seed_select` (the selection's inputs in, the kernel, its
outputs back).  Inside an `ops/_build.py` `timing()` block each search is
timed on the card under `seed_lookup`, and the selection's launch under
`seed_select`.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import _build
from ..utils.log import span

_PAD = (1 << 31) - 1      # above every 2k-bit hash: lo == hi == n
# the most hits of one read the card sorts: 2^14 int64 keys, 128 KB of a
# block's shared memory
SELECT_CAP = 1 << 14
# groups kept a strand, on the card and on the host path of align/batch.py
# (csrc/seed_select.cu kPer), and the per-read row slots of `meta`: kept,
# then (m, base, n_big, q_max) a slot
MAX_CLUSTERS_PER_STRAND = 4
META = 1 + 4 * 2 * MAX_CLUSTERS_PER_STRAND
_QMASK = (1 << 19) - 1
_ANCHOR_MASK = (1 << 51) - 1
# table entries packed a chunk at set-up
_PACK_CHUNK = 1 << 26


def _next_pow2(n: int, floor: int = 4096) -> int:
    return 1 << max(int(n - 1).bit_length(), floor.bit_length() - 1)


def seed_select_reference(table, chrom_off, lo, cs, hoff, qoff, qpack,
                          read_len, k: int, max_intron: int, max_qgap: int,
                          a_max: int, cap: int):
    """Plain PyTorch version of the seed_select kernel: (meta [B, META]
    int64, out [max(hoff[-1], 1)] int64).  See `seed_select`."""
    dev = lo.device
    B, nq = read_len.shape[0], lo.shape[0]
    i64 = dict(dtype=torch.int64, device=dev)
    meta = torch.zeros((B, META), **i64)
    total = int(hoff[-1]) if B else 0
    out = torch.zeros(max(total, 1), **i64)
    rh = hoff[1:] - hoff[:-1]
    host = rh > cap
    meta[:, 0] = torch.where(host, -1, 0)
    if not total:
        return meta, out
    cnt = cs - F.pad(cs[:-1], (1, 0))
    rid_q = torch.repeat_interleave(torch.arange(B, device=dev),
                                    (qoff[1:] - qoff[:-1]).long(),
                                    output_size=nq)
    hq = torch.repeat_interleave(torch.arange(nq, device=dev), cnt,
                                 output_size=total)
    # hits are laid out query by query: a hit's table entry is its query's
    # lo plus its place in the query's run
    flat = lo.long()[hq] + torch.arange(total, device=dev) - (cs - cnt)[hq]
    card = ~host[rid_q[hq]]
    hq, flat = hq[card], flat[card]
    if not hq.numel():
        return meta, out
    e = table[flat]
    rid = rid_q[hq]
    qp, qs = (qpack[hq] >> 1).long(), (qpack[hq] & 1).long()
    st = qs ^ (e & 1)
    qf = torch.where(st == 1, read_len.long()[rid] - k - qp, qp)
    key = (st << 51) | ((e >> 1) << 19) | qf
    o1 = torch.sort(key, stable=True).indices
    order = o1[torch.sort(rid[o1], stable=True).indices]
    rid, key = rid[order], key[order]
    st, gp, q = key >> 51, (key >> 19) & 0xFFFFFFFF, key & _QMASK
    atid = torch.searchsorted(chrom_off, gp, right=True)
    new = torch.ones_like(rid, dtype=torch.bool)
    new[1:] = ((rid[1:] != rid[:-1]) | (st[1:] != st[:-1]) |
               (gp[1:] - gp[:-1] > max_intron) | (atid[1:] != atid[:-1]))
    gid = torch.cumsum(new, 0) - 1
    n_g = int(gid[-1]) + 1
    counts = torch.bincount(gid, minlength=n_g)
    gstart = F.pad(torch.cumsum(counts, 0), (1, 0))[:-1]
    g_rid, g_st = rid[gstart], st[gstart]
    # rank a (read, strand): count descending, then group order
    og = torch.sort((g_rid << 33) | (g_st << 32) | (0xFFFFFFFF - counts),
                    stable=True).indices
    gr, gs2 = g_rid[og], g_st[og]
    newkey = torch.ones_like(gr, dtype=torch.bool)
    newkey[1:] = (gr[1:] != gr[:-1]) | (gs2[1:] != gs2[:-1])
    kid = torch.cumsum(newkey, 0) - 1
    rank = torch.arange(n_g, device=dev) - torch.nonzero(newkey)[:, 0][kid]
    keep = (rank < MAX_CLUSTERS_PER_STRAND) & (counts[og] >= 2)
    sel = og[keep]
    if not sel.numel():
        return meta, out
    slot = g_st[sel] * MAX_CLUSTERS_PER_STRAND + rank[keep]
    n_i, starts = counts[sel], gstart[sel]
    qmx = torch.zeros(n_g, **i64).scatter_reduce(0, gid, q, "amax",
                                                 include_self=False)
    qmn = torch.zeros(n_g, **i64).scatter_reduce(0, gid, q, "amin",
                                                 include_self=False)
    need = torch.clamp_min((qmx - qmn)[sel] // max(max_qgap // 2, 1) + 2,
                           a_max)
    m = torch.minimum(n_i, need)
    cum = F.pad(torch.cumsum(m, 0), (1, 0))
    n_kept = int(cum[-1])
    rowrep = torch.repeat_interleave(torch.arange(len(sel), device=dev), m,
                                     output_size=n_kept)
    within = torch.arange(n_kept, device=dev) - cum[rowrep]
    src = starts[rowrep] + within * (n_i[rowrep] - 1) // (m[rowrep] - 1)
    g_all = gp[src]
    n_big = torch.zeros(len(sel), **i64)
    if n_kept > 1:
        big = (((g_all[1:] - g_all[:-1]) >= (1 << 16)) &
               (rowrep[1:] == rowrep[:-1]))
        n_big.index_add_(0, rowrep[1:][big],
                         torch.ones(int(big.sum()), **i64))
    q_max = torch.zeros(len(sel), **i64).scatter_reduce(
        0, rowrep, q[src], "amax", include_self=False)
    r_sel = g_rid[sel]
    col = 1 + 4 * slot
    meta[r_sel, col] = m
    meta[r_sel, col + 1] = gp[starts]
    meta[r_sel, col + 2] = n_big
    meta[r_sel, col + 3] = q_max
    meta[:, 0].index_add_(0, r_sel, m)
    out[:n_kept] = key[src] & _ANCHOR_MASK
    return meta, out


def seed_select(table, chrom_off, lo, cs, hoff, qoff, qpack, read_len,
                k: int, max_intron: int, max_qgap: int, a_max: int,
                cap: int = SELECT_CAP, widest: int = SELECT_CAP):
    """The kept anchors of a batch's lookup ranges, a block a read.

    table [n] int64 (pos << 1 | strand of each index entry); chrom_off
    [C + 1] int64 (the chromosomes' global starts); lo [nq] int32 (each
    query's first entry); cs [nq] int64 (inclusive sum of hi - lo); hoff
    [B + 1] int64 (each read's first hit: cs before its first query);
    qoff [B + 1] int32 (each read's first query: queries are in read
    order); qpack [nq] int32 (qpos << 1 | qstrand); read_len [B] int32.
    Reads with more than `cap` (<= SELECT_CAP) hits are left out: meta
    kept = -1.  `widest`: the most hits of a read of at most `cap` (the
    shared memory each block reserves; the plain version ignores it).

    Returns (meta [B, META] int64: kept, then m, base, n_big, q_max of
    each slot strand * 4 + rank; out [max(hoff[-1], 1)] int64 whose first
    sum(max(kept, 0)) entries are the kept anchors gp << 19 | qf, in read
    order, then slot order).  CUDA tensors launch csrc/seed_select.cu; CPU
    tensors run `seed_select_reference`."""
    ts = {"table": (table, torch.int64), "chrom_off": (chrom_off,
                                                       torch.int64),
          "lo": (lo, torch.int32), "cs": (cs, torch.int64),
          "hoff": (hoff, torch.int64), "qoff": (qoff, torch.int32),
          "qpack": (qpack, torch.int32), "read_len": (read_len, torch.int32)}
    for name, (t, dtype) in ts.items():
        if t.dim() != 1 or t.dtype != dtype:
            raise ValueError(f"seed_select: {name} must be 1-D {dtype}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    B, nq = read_len.shape[0], lo.shape[0]
    if (cs.shape[0] != nq or qpack.shape[0] != nq or hoff.shape[0] != B + 1
            or qoff.shape[0] != B + 1 or chrom_off.shape[0] < 1):
        raise ValueError("seed_select: inconsistent shapes")
    if not 0 <= cap <= SELECT_CAP:
        raise ValueError(f"seed_select: cap must be in [0, {SELECT_CAP}]")
    dev = lo.device
    if any(t.device != dev for t, _ in ts.values()):
        raise ValueError("seed_select: all inputs must be on one device")
    args = (table, chrom_off, lo, cs, hoff, qoff, qpack, read_len, k,
            max_intron, max_qgap, a_max, cap)
    if dev.type == "cpu":
        return seed_select_reference(*args)
    if dev.type != "cuda":
        raise ValueError(f"seed_select: unsupported device {dev}")
    n2max = max(32, 1 << (max(min(widest, cap), 1) - 1).bit_length())
    total = max(int(hoff[-1]), 1) if B else 1
    meta = torch.empty((B, META), dtype=torch.int64, device=dev)
    slab = torch.empty(total, dtype=torch.int64, device=dev)
    out = torch.empty(total, dtype=torch.int64, device=dev)
    if B == 0:
        return meta, out
    lib = _build.load()
    ts = [t.contiguous() for t, _ in ts.values()]
    with torch.cuda.device(dev):
        start = _build.start_event(dev)
        rc = lib.lr2_seed_select(
            *(t.data_ptr() for t in ts[:2]), chrom_off.shape[0],
            *(t.data_ptr() for t in ts[2:]), B, k, max_intron,
            max(max_qgap // 2, 1), a_max, min(cap, n2max), n2max,
            slab.data_ptr(), meta.data_ptr(), out.data_ptr(),
            _build.stream_handle(dev))
        _build.launched("seed_select", rc, start, dev)
    return meta, out


@dataclass
class Selection:
    """What `TorchSeedLookup.select` brings back for a batch: meta [B,
    META] and the kept anchors (int64 gp << 19 | qf), both as
    `seed_select` defines them; each read's hits [B]; and, for the reads
    left to the host path (meta kept = -1), the indices of their queries
    in the batch and those queries' (lo, hi) ranges (int64)."""
    meta: np.ndarray
    anchors: np.ndarray
    read_hits: np.ndarray
    host_queries: np.ndarray
    host_lo: np.ndarray
    host_hi: np.ndarray

    def rows(self):
        """The kept rows' columns, in read, then slot (strand, rank) order:
        read, strand, base, n_big, q_max [R] and offs [R + 1] (int64), and
        the anchors' query and global positions q, g, row j's at
        offs[j]:offs[j + 1]."""
        m = self.meta[:, 1::4]
        read, slot = np.nonzero(m > 0)
        offs = np.zeros(len(read) + 1, np.int64)
        np.cumsum(m[read, slot], out=offs[1:])
        col = 1 + 4 * slot
        return (read, slot // MAX_CLUSTERS_PER_STRAND,
                self.meta[read, col + 1], self.meta[read, col + 2],
                self.meta[read, col + 3], offs, self.anchors & _QMASK,
                self.anchors >> 19)


class TorchSeedLookup:
    """searchsorted (lo, hi) ranges against a device-resident hash table;
    drop-in for `MinimizerIndex.lookup`, and, where the table's positions
    fit 32 bits (`packed`), the hit selection after it (`select`).  Counts
    its calls and wall, in all and for each calling thread
    (`thread_counts`), so that seed workers looking up at once each read
    their own.  On the card each calling thread's `select` runs on a CUDA
    stream of its own, so that it waits on no other thread's work."""

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
        self.packed = self.chrom_off = None
        if int(index.chrom_offsets[-1]) < (1 << 32):
            self._pack(index)
        self.calls = 0
        self.wall_s = 0.0
        self._lock = threading.Lock()
        self._thread = threading.local()

    def _pack(self, index) -> None:
        """The table's positions and strands on the device as one int64
        `pos << 1 | strand`, copied a chunk at a time from views of the
        host arrays (no host copy of the table is made)."""
        dev = self.device
        self.packed = torch.empty(self.n, dtype=torch.int64, device=dev)
        strand = index.strand.view(np.uint8)
        for a in range(0, self.n, _PACK_CHUNK):
            b = min(a + _PACK_CHUNK, self.n)
            pos = torch.from_numpy(index.pos[a:b]).to(dev)
            st = torch.from_numpy(strand[a:b]).to(dev)
            torch.bitwise_or(pos << 1, st & 1, out=self.packed[a:b])
        self.chrom_off = torch.from_numpy(np.ascontiguousarray(
            index.chrom_offsets, np.int64)).to(dev)
        if dev.type == "cuda":
            # the packing ran on this thread's stream; the selections read
            # the table from their own
            torch.cuda.synchronize(dev)

    def selects(self, n_reads: int, max_len: int) -> bool:
        """Whether `select` takes a batch of `n_reads` reads whose longest
        has `max_len` bases: the packed table is resident and the host
        path's 64-bit key fits (at most 4096 reads, reads under 2^19
        bases, positions under 2^32)."""
        return (self.packed is not None and n_reads <= (1 << 12)
                and max_len < (1 << 19))

    def thread_counts(self) -> Tuple[int, float]:
        """(calls, wall seconds) of the lookups the calling thread made so
        far (never reset)."""
        mine = self._thread
        return getattr(mine, "calls", 0), getattr(mine, "wall_s", 0.0)

    def _tally(self, wall: float) -> None:
        mine = self._thread
        mine.calls = getattr(mine, "calls", 0) + 1
        mine.wall_s = getattr(mine, "wall_s", 0.0) + wall
        with self._lock:
            self.calls += 1
            self.wall_s += wall

    def _stream(self):
        """The calling thread's own CUDA stream as the current stream (a
        no-op off the card)."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        s = getattr(self._thread, "stream", None)
        if s is None:
            s = self._thread.stream = torch.cuda.Stream(self.device)
        return torch.cuda.stream(s)

    def _search(self, tq: torch.Tensor, right: bool) -> torch.Tensor:
        """One searchsorted of the queries in the table, timed on the card
        under `seed_lookup` (each search its own event pair, so that work
        other threads queue on the stream between the two is not
        counted)."""
        start = (_build.start_event(self.device)
                 if self.device.type == "cuda" else None)
        out = torch.searchsorted(self.table, tq, right=right,
                                 out_int32=True)
        _build.timed("seed_lookup", start, self.device)
        return out

    def _ranges(self, qhashes: np.ndarray):
        """(lo, hi) int32 device tensors of the nq > 0 query hashes."""
        nq = len(qhashes)
        # queries padded to a power of two, as the reference pads them, so
        # the allocator sees few distinct sizes across batches
        q = np.full(_next_pow2(nq), _PAD, np.int32)
        q[:nq] = qhashes.astype(np.int32)
        tq = torch.from_numpy(q).to(self.device)
        return self._search(tq, False)[:nq], self._search(tq, True)[:nq]

    def lookup(self, qhashes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(lo, hi) int64 per query hash."""
        nq = len(qhashes)
        if nq == 0:
            z = np.zeros(0, np.int64)
            return z, z
        t0 = time.perf_counter()
        with span("lr2rmats.align.seed_lookup"):
            lo, hi = self._ranges(qhashes)
            out = torch.stack([lo, hi]).cpu().numpy()
        self._tally(time.perf_counter() - t0)
        return out[0].astype(np.int64), out[1].astype(np.int64)

    def select(self, qhashes: np.ndarray, qpos: np.ndarray,
               qstrand: np.ndarray, rid: np.ndarray, read_len: np.ndarray,
               k: int, max_intron: int, max_qgap: int,
               a_max: int) -> Selection:
        """Look the nq > 0 query hashes up and select the kept anchors of
        their reads on the device (`seed_select`): the batch's queries
        (qpos, qstrand, rid, in read order) of reads of read_len bases,
        grouped with max_intron and subsampled with max_qgap and a_max as
        align/batch.py `_batch_anchors` does.  Needs `packed`."""
        if self.packed is None:
            raise ValueError("select needs the packed table (positions "
                             "under 2^32)")
        dev = self.device
        B, nq = len(read_len), len(qhashes)
        cap = SELECT_CAP
        t0 = time.perf_counter()
        with self._stream():
            with span("lr2rmats.align.seed_lookup"):
                lo, hi = self._ranges(qhashes)
            with span("lr2rmats.align.seed_select"):
                qoff = np.zeros(B + 1, np.int32)
                np.cumsum(np.bincount(rid, minlength=B), out=qoff[1:])
                # one copy in: qpos << 1 | qstrand, qoff, read_len
                small = np.concatenate([
                    (qpos.astype(np.int32) << 1) |
                    (qstrand.astype(np.int32) & 1),
                    qoff, np.asarray(read_len, np.int32)])
                small = torch.from_numpy(small).to(dev)
                qpack, qoff_t = small[:nq], small[nq: nq + B + 1]
                cs = torch.cumsum(hi - lo, 0)
                hoff = F.pad(cs, (1, 0))[qoff_t.long()]
                hoff_h = hoff.cpu().numpy()
                read_hits = np.diff(hoff_h)
                fits = read_hits <= cap
                meta, out = seed_select(
                    self.packed, self.chrom_off, lo, cs, hoff, qoff_t, qpack,
                    small[nq + B + 1:], k, max_intron, max_qgap, a_max, cap,
                    int(read_hits[fits].max(initial=0)))
                meta = meta.cpu().numpy()
                anchors = out[:int(np.maximum(meta[:, 0], 0).sum())
                              ].cpu().numpy()
                host = np.nonzero(~fits)[0]
                hq = np.concatenate([np.arange(qoff[r], qoff[r + 1])
                                     for r in host]) if len(host) else \
                    np.zeros(0, np.int64)
                if len(hq):
                    ti = torch.from_numpy(hq).to(dev)
                    rng = torch.stack([lo[ti], hi[ti]]).cpu().numpy()
                    hlo, hhi = rng[0].astype(np.int64), rng[1].astype(np.int64)
                else:
                    hlo = hhi = np.zeros(0, np.int64)
        self._tally(time.perf_counter() - t0)
        return Selection(meta, anchors, read_hits, hq, hlo, hhi)
