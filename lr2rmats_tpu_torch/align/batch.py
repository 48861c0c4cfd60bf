"""Batched long-read aligner: vectorized seeding -> chaining -> extension.

Two classes, the counterparts of lr2rmats_tpu/align/batch.py:

`BatchAligner` is the host engine, copied from the reference's with only
its host backend ("host"): seeding for the whole batch is one native
minimizer extraction plus one vectorized index lookup; anchors are
clustered per (read, strand) by reference gap and the top clusters become
rows (positions cluster-relative); every row chains natively
(csrc/lrio.cpp chain_small_batch_c, in width-sorted chunks); extension,
RecordBatch assembly and the junction polish (host DP) follow.  It is the
host yardstick the device paths are held to, byte for byte.

`TorchBatchAligner` keeps that host work and runs the device paths as
hand-written CUDA kernels and torch ops (device="cuda") or as their plain
PyTorch versions (device="cpu"):

  * the chain dispatch runs the fused chain DP + backtrack kernel
    (ops/chain.py `chain_dp_backtrack`), or with backend="pallas" the
    DP-only kernel at any row width (`chain_dp`) and the host backtrack;
  * the junction polish runs its placement DP on the shift-DP kernel
    (align/polish.py);
  * with the device junction backend (`junction_backend="device"`, or
    LR2RMATS_DEVICE_JUNCTIONS=1|scan|pallas) the extension's junction gaps
    are placed by the junction kernel (ops/junction.py junction_place),
    between the native collect and assemble passes;
  * with LR2RMATS_DEVICE_SEED=1 the index lookup runs against a
    device-resident table (index/seed_device.py).

Row routing is the reference's, so the same rows chain on the card, in the
native small-row chain and on the host: rows of at most A_BUCKETS[0]
anchors chain natively; rows over A_BUCKETS[-1] anchors, with more than
EXC_ROWS reference deltas >= 2^16, or with query positions >= 2^16 chain on
the host; the rest go to the card in fixed CHAIN_CHUNK chunks per bucket.
backend="pallas" mirrors the reference's backend of that name: every row,
in chunks of PALLAS_CHUNK rows at the next power of two of the chunk's
widest row, goes to the DP-only kernel, and align/chain.py `backtrack` runs
on each row's f / parent in float64.

With several `devices` (cards of this process) each chain launch is split
into contiguous row blocks, one per card, as the reference shards its
chain dispatch over its local devices (ops/chain.py `split_rows`); the
outputs are the same.  Seeding lookups, junctions and polish run on
`device`.

Left out with respect to the reference, which needed them only to survive
a remote TPU link: its JAX backends, the weather router, the
device-failure fallbacks (a failing device path raises), the u16/delta
packing of the chain input and the auto-batch doubling.  The device
junction backend needs the native library and raises without it.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, fields
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..index.minimizer import MinimizerIndex, extract_minimizers
from ..index.seed_device import TorchSeedLookup
from ..io.fasta import Genome, SeqSet, decode_seq, revcomp
from ..io.sam import FREVERSE, FSECONDARY, OP_N, OP_S, AlnRec
from ..native import get_lib
from ..ops import _build
from ..ops.chain import (DP_MIN_ROWS, FUSED_MIN_ROWS, chain_dp,
                         chain_dp_backtrack, chain_params_for_kernel,
                         gather_rows, launch_rows)
from ..ops.junction import (B_DEF as JUNCTION_BAND, MGAP, cell_ops,
                            junction_batch, junction_place,
                            prepare_junction_batch)
from ..ops.splice import shift_dp
from ..utils import default_threads, log
from .aligner import AlignParams, SpliceAligner
from .chain import ChainParams, backtrack, chain_anchors
from .mapq import MAPQ_UNIQUE, mapq_from_scores, mapq_from_scores_vec
from .polish import _PLACE_G, _PLACE_M, B as POLISH_BAND, polish_batch
from .records import RecordBatch

# Padded-anchor buckets of the chain dispatch.  The per-row anchor count is
# bimodal (spurious secondary clusters carry 2-3 anchors, true placements
# fill the top-bucket cap), so the smallest bucket holds the junk rows; the
# top bucket doubles as the per-cluster anchor subsample cap (A_MAX).
A_BUCKETS = (8, 64, 128)
# Read-batch size; LR2RMATS_BATCH overrides.
DEFAULT_BATCH = int(os.environ.get("LR2RMATS_BATCH", "1536"))
if DEFAULT_BATCH <= 0:
    raise ValueError("LR2RMATS_BATCH must be a positive integer, got "
                     f"{DEFAULT_BATCH}")
# fixed row chunk per bucket, sized so one DEFAULT_BATCH-read batch of the
# ONT profile fills one launch per bucket; chunks scale with
# LR2RMATS_BATCH, rounded up to full 128-row groups (the tuned defaults
# apply exactly at the default batch)
_BF = max(DEFAULT_BATCH / 1536.0, 0.25)


def _scaled_chunk(v: int) -> int:
    return v if _BF == 1.0 else -(-int(v * _BF) // 128) * 128


CHAIN_CHUNK = {8: _scaled_chunk(2048), 64: _scaled_chunk(320),
               128: _scaled_chunk(1664)}
MAX_CLUSTERS_PER_STRAND = 4
# Rows with more oversized (>= 2^16) reference deltas than this chain on the
# host, as in the reference, whose packed chain buffer has EXC_ROWS
# exception slots per row (lr2rmats_tpu/ops/chain_jax.py:122).  The port's
# kernel takes int32 positions and has no such limit; the routing is kept so
# that the same rows chain on the host in both.
EXC_ROWS = 8

# LR2RMATS_DEVICE_JUNCTIONS values of the reference (its scan and Pallas
# backends): all select the port's one device junction path
_JUNCTION_ENV = ("1", "scan", "pallas")
# junction slots per candidate of the native collect pass
_GSTRIDE = 64
# rows per DP-only chain launch of backend="pallas" (reference batch.py:882)
PALLAS_CHUNK = 512
BACKENDS = ("torch", "pallas")


def _survivor_ranks(rid_kept: np.ndarray):
    """Effective rank among each read's SURVIVING records + survivor
    count per record.  Assumes rows grouped by read in candidate-rank
    order (the `flat` layout).  The first survivor is the primary even
    when the top-scoring chain failed the extension gate."""
    n = len(rid_kept)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int32)
    new = np.concatenate([[True], rid_kept[1:] != rid_kept[:-1]])
    starts = np.flatnonzero(new)
    counts = np.diff(np.concatenate([starts, [n]]))
    eff = np.arange(n) - np.repeat(starts, counts)
    nh = np.repeat(counts, counts).astype(np.int32)
    return eff, nh


@dataclass
class _Row:
    read_i: int
    strand: int
    qpos: np.ndarray
    gpos: np.ndarray
    base: int          # gpos offset subtracted for int32 safety
    n_big: int = 0     # consecutive gpos deltas >= 2^16 (> EXC_ROWS routes
    #                    the row to the host chain)
    q_max: int = 0     # max qpos, precomputed vectorized


def _pack_rows(rows: List[_Row], part, A: int, B: int):
    """(qpos, cluster-relative rpos, n) int32 arrays [B, A] / [B] of the
    rows `part`, zero-padded."""
    qp = np.zeros((B, A), np.int32)
    gp = np.zeros((B, A), np.int32)
    nn = np.zeros(B, np.int32)
    ns = np.array([len(rows[i].qpos) for i in part], np.int64)
    nn[:len(part)] = ns
    rowrep = np.repeat(np.arange(len(part)), ns)
    offs = np.zeros(len(part) + 1, np.int64)
    np.cumsum(ns, out=offs[1:])
    col = np.arange(offs[-1]) - np.repeat(offs[:-1], ns)
    if len(part):
        qp[rowrep, col] = np.concatenate([rows[i].qpos for i in part])
        gp[rowrep, col] = (np.concatenate([rows[i].gpos for i in part]) -
                           np.repeat(np.array([rows[i].base for i in part],
                                              np.int64), ns))
    return qp, gp, nn


def _chain_launches() -> int:
    return _build.LAUNCHES["chain_dp_backtrack"] + _build.LAUNCHES["chain_dp"]


def _decode(out, part, nn, A, mask, ps, ss) -> None:
    """Per-row (pri_idx, ps, sec_idx, ss) from a chunk's mask / scores."""
    valid = np.arange(A)[None, :] < np.asarray(nn)[:, None]
    r1, c1 = np.nonzero((mask & 1).astype(bool) & valid)
    r2, c2 = np.nonzero((mask & 2).astype(bool) & valid)
    B = len(nn)
    o1 = np.zeros(B + 1, np.int64)
    np.cumsum(np.bincount(r1, minlength=B), out=o1[1:])
    o2 = np.zeros(B + 1, np.int64)
    np.cumsum(np.bincount(r2, minlength=B), out=o2[1:])
    for bi, i in enumerate(part):
        out[i] = (c1[o1[bi]: o1[bi + 1]], float(ps[bi]),
                  c2[o2[bi]: o2[bi + 1]], float(ss[bi]))


class BatchAligner:
    """Throughput-oriented front end over SpliceAligner's extension, all on
    the host."""

    def __init__(self, genome: Genome, params: Optional[AlignParams] = None,
                 index: Optional[MinimizerIndex] = None,
                 n_threads: Optional[int] = None):
        """Runs everything on the host (backend "host"; the device
        backends are TorchBatchAligner's).  n_threads: worker threads of
        the native kernels (default utils.default_threads)."""
        self.inner = SpliceAligner(genome, params, index)
        self.p = self.inner.p
        self.index = self.inner.index
        self.refs = self.inner.refs
        self.backend = "host"
        self.junction_backend = "host"
        self._seed_lookup = None
        self.stats = self.fresh_stats()
        self.n_threads = max(1, n_threads if n_threads is not None
                             else default_threads())
        self._pool = None
        self._pool_lock = threading.Lock()
        # scripts/calibrate_mapq.py support: record the raw score margin
        # of every primary record (qname -> 1 - s2/s1)
        self.record_margins = False
        self._mapq_margins: Dict[str, float] = {}

    def close(self) -> None:
        """Release the lazy extend-thread pool (it is otherwise leaked
        per-instance; suites constructing many aligners accumulate idle
        threads)."""
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def __del__(self):  # best-effort; explicit close() preferred
        try:
            self.close()
        except Exception:
            pass

    @staticmethod
    def fresh_stats() -> Dict[str, float]:
        return {"device_wall_s": 0.0, "anchors": 0, "device_calls": 0,
                "seed_lookup_calls": 0}

    # -------------------------------------------------------------- seeding
    def _batch_minimizers(self, reads: List[np.ndarray]):
        """(hash, read-local pos, strand, read id, lengths) for the whole
        batch — ONE threaded native call (extract_minimizers_batch_c)
        instead of one ctypes crossing per read (~85 us each)."""
        p = self.p
        if not reads:
            return None, None, None, None, None
        lib = get_lib()
        if lib is not None:
            read_offs = np.zeros(len(reads) + 1, np.int64)
            np.cumsum([len(r) for r in reads], out=read_offs[1:])
            concat = np.ascontiguousarray(np.concatenate(reads), np.uint8)
            oh = np.empty(len(concat), np.uint64)
            op = np.empty(len(concat), np.int64)
            os_ = np.empty(len(concat), np.int8)
            on = np.zeros(len(reads), np.int64)
            lib.extract_minimizers_batch_c(
                concat, read_offs, len(reads), p.k, p.w, self.n_threads,
                oh, op, os_, on)
            total = int(on.sum())
            if not total:
                return None, None, None, None, None
            # compact the ragged per-read regions (one threaded C pass)
            out_off = np.cumsum(on) - on
            h = np.empty(total, np.uint64)
            qpos = np.empty(total, np.int64)
            qstr = np.empty(total, np.int8)
            rid = np.empty(total, np.int32)
            lib.compact_minimizers_c(oh, op, os_, read_offs, on,
                                     np.ascontiguousarray(out_off),
                                     len(reads), h, qpos, qstr, rid,
                                     self.n_threads)
            return h, qpos, qstr, rid, [len(r) for r in reads]
        all_h, all_q, all_s, all_rid = [], [], [], []
        for ri, codes in enumerate(reads):
            h, qp, qs = extract_minimizers(codes, p.k, p.w)
            all_h.append(h)
            all_q.append(qp)
            all_s.append(qs)
            all_rid.append(np.full(len(h), ri, np.int32))
        h = np.concatenate(all_h)
        if not len(h):
            return None, None, None, None, None
        return (h, np.concatenate(all_q), np.concatenate(all_s),
                np.concatenate(all_rid), [len(r) for r in reads])

    def _batch_anchors(self, reads: List[np.ndarray]) -> List[_Row]:
        p = self.p
        idx = self.index
        h, qp, qs, rid, lens = self._batch_minimizers(reads)
        if h is None:
            return []
        # sharded indexes expose the batch-level (possibly collective)
        # lookup separately (parallel/shard_index.py); the device lookup
        # (index/seed_device.py, LR2RMATS_DEVICE_SEED=1) slots in only
        # for plain single-shard indexes
        look = getattr(idx, "lookup_collective", None)
        if look is None and self._seed_lookup is not None:
            tw = self._seed_lookup
            w0, c0 = tw.wall_s, tw.calls
            lo, hi = tw.lookup(h)
            self.stats["device_wall_s"] += tw.wall_s - w0
            self.stats["device_calls"] += tw.calls - c0
            self.stats["seed_lookup_calls"] += tw.calls - c0
        else:
            lo, hi = (look or idx.lookup)(h)
        cnt = (hi - lo).astype(np.int64)
        keep = cnt > 0
        if not keep.any():
            return []
        lo, cnt = lo[keep], cnt[keep]
        qp, qs, rid = qp[keep], qs[keep], rid[keep]
        # expand hit ranges + build the composite sort key.  The key fits
        # one uint64 (radix argsort ~3x faster than the 4-key lexsort)
        # when genome < 4 Gbp, batch <= 2048 reads, reads < 512 kb — all
        # production cases; otherwise lexsort on the columns.
        L = np.asarray(lens, np.int64)
        total = int(cnt.sum())
        starts = np.zeros(len(cnt) + 1, np.int64)
        np.cumsum(cnt, out=starts[1:])
        # key layout (csrc expand_anchors_c:2604): rid<<52 | strand<<51 |
        # gp<<19 | qfinal -> rid has 12 bits, so any batch <= 4096 reads
        # rides the radix key (the old <=2048 guard silently dropped the
        # auto-batch-3072 path to the ~3x slower 4-key lexsort)
        key_ok = (int(idx.chrom_offsets[-1]) < (1 << 32)
                  and len(reads) <= (1 << 12)
                  and int(L.max(initial=0)) < (1 << 19))
        lib = get_lib()
        if lib is not None and total:
            # one threaded native pass (the numpy repeat/gather/where
            # chain cost ~70 ms per 1500-read batch)
            gp = np.empty(total, np.int64)
            strand = np.empty(total, np.int8)
            ridx = np.empty(total, np.int32)
            qfinal = np.empty(total, np.int64)
            key = np.empty(total if key_ok else 1, np.uint64)
            lib.expand_anchors_c(
                np.ascontiguousarray(lo), np.ascontiguousarray(lo + cnt),
                starts, len(cnt),
                idx.pos, idx.strand.view(np.int8),
                np.ascontiguousarray(qp), np.ascontiguousarray(
                    qs).view(np.int8),
                np.ascontiguousarray(rid), L, p.k,
                gp, strand, ridx, qfinal, key, int(key_ok),
                self.n_threads)
        else:
            flat = np.repeat(lo, cnt) + (np.arange(total) -
                                         np.repeat(starts[:-1], cnt))
            gp = idx.pos[flat]
            gs = idx.strand[flat]
            qpx = np.repeat(qp, cnt)
            qsx = np.repeat(qs, cnt)
            ridx = np.repeat(rid, cnt)
            strand = (qsx ^ gs).astype(np.int8)
            qfinal = np.where(strand == 1, L[ridx] - p.k - qpx, qpx)
            key = None
            if key_ok and total:
                key = ((ridx.astype(np.uint64) << np.uint64(52)) |
                       (strand.astype(np.uint64) << np.uint64(51)) |
                       (gp.astype(np.uint64) << np.uint64(19)) |
                       qfinal.astype(np.uint64))

        # cluster per (read, strand) by sorted gpos gaps — fully vectorized
        # (the round-1 python group loop cost ~0.06 s per 512-read batch)
        if key_ok and total:
            order = np.argsort(key, kind="stable")
        else:
            order = np.lexsort((qfinal, gp, strand, ridx))
        ridx, strand, qfinal, gp = (ridx[order], strand[order],
                                    qfinal[order], gp[order])
        # boundaries where (read, strand) changes, gpos jumps > max_intron,
        # or the anchors cross a chromosome boundary (the genome buffer is
        # concatenated; a chain must never span two chromosomes)
        atid = np.searchsorted(idx.chrom_offsets, gp, side="right") - 1
        newgrp = np.ones(len(ridx), bool)
        if len(ridx) > 1:
            newgrp[1:] = ((ridx[1:] != ridx[:-1]) |
                          (strand[1:] != strand[:-1]) |
                          (gp[1:] - gp[:-1] > p.chain.max_intron) |
                          (atid[1:] != atid[:-1]))
        gids = np.cumsum(newgrp, dtype=np.int64) - 1
        n_g = int(gids[-1]) + 1 if len(gids) else 0
        counts = np.bincount(gids, minlength=n_g).astype(np.int64)
        gstart = np.zeros(n_g + 1, np.int64)
        np.cumsum(counts, out=gstart[1:])
        # top MAX_CLUSTERS_PER_STRAND clusters per (read, strand), ≥2 anchors
        g_rid = ridx[gstart[:-1]]
        g_str = strand[gstart[:-1]]
        if len(reads) <= (1 << 12) and (not n_g or
                                        int(counts.max()) < (1 << 32)):
            key2 = ((g_rid.astype(np.uint64) << np.uint64(33)) |
                    (g_str.astype(np.uint64) << np.uint64(32)) |
                    (np.uint64(0xFFFFFFFF) - counts.astype(np.uint64)))
            og = np.argsort(key2, kind="stable")
        else:
            og = np.lexsort((-counts, g_str, g_rid))
        gr, gs2, gc = g_rid[og], g_str[og], counts[og]
        newkey = np.ones(n_g, bool)
        if n_g > 1:
            newkey[1:] = (gr[1:] != gr[:-1]) | (gs2[1:] != gs2[:-1])
        kstart = np.nonzero(newkey)[0]
        kid = np.cumsum(newkey, dtype=np.int64) - 1
        rank = np.arange(n_g) - kstart[kid]
        keep = (rank < MAX_CLUSTERS_PER_STRAND) & (gc >= 2)
        sel = og[keep]                               # kept group ids
        if not len(sel):
            return []
        A_MAX = A_BUCKETS[-1]
        n_i = counts[sel]
        # subsample cap, scaled up for long clusters so the surviving
        # anchor spacing stays well inside max_qgap (a flat cap broke
        # >=64 kb reads: 128 anchors over 80 kb = 625 bp spacing > 500);
        # rows beyond A_MAX route to the host chain in _chain_rows_async
        starts = gstart[sel]
        # clusters are contiguous ranges of the sorted arrays, so one
        # reduceat over the full partition gives every cluster's q-span
        qspan = (np.maximum.reduceat(qfinal, gstart[:-1]) -
                 np.minimum.reduceat(qfinal, gstart[:-1]))[sel]
        need = np.maximum(A_MAX, qspan // max(p.chain.max_qgap // 2, 1) + 2)
        m_i = np.minimum(n_i, need)
        cum = np.zeros(len(sel) + 1, np.int64)
        np.cumsum(m_i, out=cum[1:])
        rowrep = np.repeat(np.arange(len(sel)), m_i)
        within = np.arange(cum[-1]) - cum[rowrep]
        # even subsample (linspace semantics) for over-full clusters
        src = starts[rowrep] + within * (n_i[rowrep] - 1) // (m_i[rowrep] - 1)
        q_all = qfinal[src]
        g_all = gp[src]
        # plain slices: np.split's array_split wrapper costs ~10 us/row in
        # swapaxes/wrapping (0.47 s per 8 batches at 500k scale)
        cl = cum.tolist()
        qs_split = [q_all[cl[j]: cl[j + 1]] for j in range(len(sel))]
        gs_split = [g_all[cl[j]: cl[j + 1]] for j in range(len(sel))]
        bases = gp[starts]
        # oversized-delta counts per row, vectorized (the per-row np.diff
        # in the dispatch router cost ~0.09 ms/row)
        if cum[-1] > 1:
            dbig = (g_all[1:] - g_all[:-1]) >= (1 << 16)
            same = rowrep[1:] == rowrep[:-1]
            n_big = np.bincount(rowrep[1:][dbig & same],
                                minlength=len(sel))
        else:
            n_big = np.zeros(len(sel), np.int64)
        q_max = (np.maximum.reduceat(q_all, np.minimum(cum[:-1], cum[-1] - 1))
                 if cum[-1] else np.zeros(len(sel), np.int64))
        return [_Row(int(g_rid[og[i]]), int(g_str[og[i]]), qs_split[j],
                     gs_split[j], int(bases[j]), int(n_big[j]),
                     int(q_max[j]))
                for j, i in enumerate(np.nonzero(keep)[0])]

    def _chunk(self, A: int) -> int:
        """Device-chunk height for bucket A: the tuned CHAIN_CHUNK."""
        return CHAIN_CHUNK[A]

    # ------------------------------------------------------------- chaining
    def _prepare_dispatch(self, rows: List[_Row]):
        """Host side of the chain dispatch; the host backend has none."""
        return "host"

    def _chain_rows_async(self, rows: List[_Row], prep=None):
        """Launch the chains of `rows`; returns the pending handle that
        `_materialize_chains` resolves ("host": chain at materialize)."""
        return "host"

    def warmup_chain_shapes(self) -> None:
        """Build and launch every device shape up front; the host backend
        has none."""

    def _materialize_chains(self, rows: List[_Row], pending):
        """Resolve chains as per-row (pri_idx, ps, sec_idx, ss) tuples: the
        native windowed DP + backtrack (chain_small_batch_c handles any row
        width) in width-sorted chunks of 2048 rows, so one wide row does
        not widen the dense [m, cap] matrices of thousands of narrow ones;
        the python chain and backtrack where the native library is
        unavailable."""
        out: List[Optional[tuple]] = [None] * len(rows)
        lib = get_lib()
        if lib is None or not rows:
            for i, r in enumerate(rows):
                f, parent = chain_anchors(r.qpos, r.gpos, self.p.chain)
                out[i] = backtrack(f, parent, self.p.min_score)
            return out
        pc = self.p.chain
        widths = np.array([len(r.qpos) for r in rows], np.int64)
        order = np.argsort(widths, kind="stable")
        CH = 2048
        for off in range(0, len(order), CH):
            sel = order[off: off + CH]
            cap = max(int(widths[sel[-1]]), 1)
            m = len(sel)
            qp = np.zeros((m, cap), np.int32)
            gp = np.zeros((m, cap), np.int32)
            nn = np.zeros(m, np.int32)
            for bi, i in enumerate(sel):
                r = rows[i]
                n = len(r.qpos)
                qp[bi, :n] = r.qpos
                gp[bi, :n] = r.gpos - r.base
                nn[bi] = n
            mask = np.zeros((m, cap), np.uint8)
            ps = np.zeros(m, np.float32)
            ss = np.zeros(m, np.float32)
            lib.chain_small_batch_c(
                qp, gp, nn, m, cap,
                pc.k, pc.window, pc.max_intron, pc.max_qgap,
                pc.gap_open, pc.gap_scale, pc.intron_scale,
                pc.min_intron_gap, float(self.p.min_score),
                mask.reshape(-1), ps, ss)
            _decode(out, sel, nn, cap, mask, ps, ss)
        return out

    @staticmethod
    def _apply_survivor_ranks(out, mapq_primary):
        """Scalar twin of _survivor_ranks for the AlnRec build paths:
        `out` is one read's surviving records in candidate-rank order —
        the first survivor becomes the primary."""
        for si, r in enumerate(out):
            r.tags["NH"] = len(out)
            if si == 0:
                r.flag &= ~FSECONDARY
                r.mapq = mapq_primary
            else:
                r.flag |= FSECONDARY
                r.mapq = 0
        return out

    def _chain_rows(self, rows: List[_Row]):
        """Run chain DP + backtrack for all rows; returns list of
        (pri_idx, pri_score, sec_idx, sec_score)."""
        return self._materialize_chains(rows, self._chain_rows_async(rows))

    # ------------------------------------------------------------ top level
    def align_batch(self, names: Sequence[str], reads: List[np.ndarray]
                    ) -> List[AlnRec]:
        rows = self._batch_anchors(reads)
        chained = self._chain_rows(rows)
        return self._build_records(names, reads, rows, chained)

    @staticmethod
    def _collect_candidates(rows, chained):
        """Per-read candidate chains (score, strand, q, g) — shared by the
        packed and AlnRec build paths, which must stay bit-identical."""
        per_read: Dict[int, List[Tuple[float, int, np.ndarray, np.ndarray]]] = {}
        for r, ch in zip(rows, chained):
            pri, ps, sec, ss = ch
            if len(pri):
                per_read.setdefault(r.read_i, []).append(
                    (ps, r.strand, r.qpos[pri], r.gpos[pri]))
            if len(sec):
                per_read.setdefault(r.read_i, []).append(
                    (ss, r.strand, r.qpos[sec], r.gpos[sec]))
        return per_read

    def _build_records(self, names, reads, rows, chained,
                       per_read=None) -> List[AlnRec]:
        p = self.p
        if per_read is None:
            per_read = self._collect_candidates(rows, chained)
        def _extend_read(ri):
            cands = sorted(per_read[ri], key=lambda c: -c[0])[:2]
            codes = reads[ri]
            rc = revcomp(codes)
            out = []
            for rank, (score, s, cq, cg) in enumerate(cands):
                seq_codes = rc if s == 1 else codes
                pos_g, ops, ed, nmatch, vote = self.inner._extend(
                    seq_codes, cq, cg)
                if nmatch < p.min_score:
                    continue
                tid, pos = self.index.global_to_chrom(np.array([pos_g]))
                tid, pos = int(tid[0]), int(pos[0])
                flag = (FREVERSE if s == 1 else 0) | (FSECONDARY if rank else 0)
                cigar = np.array([(l << 4) | op for op, l in ops if l > 0],
                                 np.uint32)
                tags = {"NM": ed, "AS": int(2 * nmatch - 4 * ed),
                        "NH": len(cands)}
                has_intron = any(op == OP_N for op, _ in ops)
                if has_intron and vote != 0:
                    tags["XS"] = "+" if vote > 0 else "-"
                out.append(AlnRec(
                    qname=names[ri], flag=flag, tid=tid, pos=pos,
                    mapq=0, cigar=cigar,
                    seq=decode_seq(seq_codes), qual="*", tags=tags))
            mapq = (MAPQ_UNIQUE if len(cands) == 1 else
                    mapq_from_scores(cands[0][0], cands[1][0]))
            return self._apply_survivor_ranks(out, mapq)

        order = sorted(per_read)
        lib = get_lib()
        if lib is not None and len(order) > 8:
            return self._build_records_native(lib, names, reads, per_read,
                                              order)
        if self.n_threads > 1 and len(order) > 8:
            if self._pool is None:
                with self._pool_lock:   # two build workers can race here
                    if self._pool is None:
                        self._pool = ThreadPoolExecutor(self.n_threads)
            results = list(self._pool.map(_extend_read, order))
        else:
            results = [_extend_read(ri) for ri in order]
        recs: List[AlnRec] = []
        for rr in results:
            recs.extend(rr)
        return recs

    def _flatten_candidates(self, reads, per_read, order):
        """Top-2 candidate selection + packed arrays for the native batch
        kernels.  Returns None when the batch is empty."""
        cands_by_read = {ri: sorted(per_read[ri], key=lambda c: -c[0])[:2]
                         for ri in order}
        flat = [(ri, rank) for ri in order
                for rank in range(len(cands_by_read[ri]))]
        n_cand = len(flat)
        if not n_cand:
            return None
        read_offs = np.zeros(len(reads) + 1, np.int64)
        np.cumsum([len(r) for r in reads], out=read_offs[1:])
        reads_concat = np.ascontiguousarray(
            np.concatenate(reads) if reads else np.zeros(0, np.uint8),
            np.uint8)
        cand_read = np.empty(n_cand, np.int32)
        cand_strand = np.empty(n_cand, np.int8)
        a_offs = np.zeros(n_cand + 1, np.int64)
        aqs, ags = [], []
        max_len = 1
        for i, (ri, rank) in enumerate(flat):
            score, s, cq, cg = cands_by_read[ri][rank]
            cand_read[i] = ri
            cand_strand[i] = s
            aqs.append(cq)
            ags.append(cg)
            a_offs[i + 1] = a_offs[i] + len(cq)
            max_len = max(max_len, len(reads[ri]))
        aq = np.ascontiguousarray(np.concatenate(aqs), np.int64)
        ag = np.ascontiguousarray(np.concatenate(ags), np.int64)
        return (cands_by_read, flat, reads_concat, read_offs, cand_read,
                cand_strand, aq, ag, a_offs, max_len)

    def _extend_candidates_native(self, lib, reads, per_read, order):
        """One native call extends every candidate of the batch (the
        per-candidate ctypes crossing cost ~85 us; csrc
        extend_chain_batch_c).  Returns (packed, ext) or None."""
        p = self.p
        packed = self._flatten_candidates(reads, per_read, order)
        if packed is None:
            return None
        (cands_by_read, flat, reads_concat, read_offs, cand_read,
         cand_strand, aq, ag, a_offs, max_len) = packed
        n_cand = len(flat)
        if self.junction_backend == "device":
            ext = self._extend_device_junctions(
                lib, packed, n_cand, max_len)
        else:
            stride = max_len + 80                  # ops pairs per candidate
            pos_out = np.empty(n_cand, np.int64)
            ops_out = np.empty(n_cand * 2 * stride, np.int32)
            n_ops = np.empty(n_cand, np.int32)
            ed_out = np.empty(n_cand, np.int64)
            nm_out = np.empty(n_cand, np.int64)
            vote_out = np.empty(n_cand, np.int32)
            rc_out = np.empty(n_cand, np.int32)
            lib.extend_chain_batch_c(
                reads_concat, read_offs,
                self.inner.genome.codes, len(self.inner.genome.codes),
                self.index.chrom_offsets,
                len(self.index.chrom_offsets) - 1,
                cand_read, cand_strand, aq, ag, a_offs,
                p.k, p.min_intron_gap, p.min_intron_len, p.band_pad,
                p.ext_match, p.ext_mismatch, 4,
                n_cand, stride, self.n_threads,
                pos_out, ops_out, n_ops, ed_out, nm_out, vote_out, rc_out)
            ext = (stride, pos_out, ops_out, n_ops, ed_out, nm_out,
                   vote_out, rc_out)
        return packed, ext

    def _build_records_native(self, lib, names, reads, per_read, order
                              ) -> List[AlnRec]:
        res = self._extend_candidates_native(lib, reads, per_read, order)
        if res is None:
            return []
        packed, ext = res
        return self._records_from_extension(names, reads, packed[1],
                                            packed[0], ext)

    def _build_packed(self, names, reads, rows, chained):
        """RecordBatch (struct-of-arrays) result for the batch — the
        production path; AlnRec assembly (`_build_records`) is the legacy
        bridge on top."""
        per_read = self._collect_candidates(rows, chained)
        order = sorted(per_read)
        lib = get_lib()
        if lib is None and self.junction_backend == "device":
            raise RuntimeError("the device junction backend needs the native "
                               "library (csrc/lrio.cpp), which is unavailable")
        if lib is None or len(order) <= 8:
            return RecordBatch.from_alnrecs(
                self._build_records(names, reads, rows, chained,
                                    per_read=per_read))
        res = self._extend_candidates_native(lib, reads, per_read, order)
        if res is None:
            return RecordBatch.from_alnrecs([])
        packed, ext = res
        (cands_by_read, flat, reads_concat, read_offs, cand_read,
         cand_strand, aq, ag, a_offs, max_len) = packed
        return self._packed_from_extension(names, reads, flat,
                                           cands_by_read, reads_concat,
                                           read_offs, cand_read,
                                           cand_strand, ext)

    def _packed_from_extension(self, names, reads, flat, cands_by_read,
                               reads_concat, read_offs, cand_read,
                               cand_strand, ext):
        """Vectorized RecordBatch assembly from the batch extension
        outputs — the per-record python of `_records_from_extension`
        (~70 us/record measured) collapses to array ops; only the rare
        native-refused (rc != 0) and terminal-rescue candidates take the
        per-record path.  Bit-identical output is tested against the
        AlnRec reference path."""
        p = self.p
        (stride, pos_out, ops_out, n_ops, ed_out, nm_out, vote_out,
         rc_out) = ext
        n = len(flat)
        MIN_RESCUE = p.k + p.w + 4
        no = n_ops.astype(np.int64)
        # RAGGED view of the op stream: record i's (code, len) pairs live at
        # ops_out[2*(i*stride) ... ], only no[i] of the stride slots real.
        # (The dense [n, stride] matrices this used to build were ~99%
        # padding — stride is max_len+80 ~ 3000 — and fell off the cache at
        # production batch sizes: build wall 0.12 s -> 3.8 s at B=1536.)
        total_ops = int(no.sum())
        rowrep = np.repeat(np.arange(n), no)
        ostarts = np.cumsum(no) - no
        colidx = np.arange(total_ops) - np.repeat(ostarts, no)
        obase = rowrep * stride + colidx
        opc_f = ops_out[2 * obase]
        opl_f = ops_out[2 * obase + 1]
        ar = np.arange(n)
        nz = no > 0
        # terminal-exon rescue triggers on the UNFILTERED first/last op
        first_c = np.where(nz, ops_out[2 * (ar * stride)], -1)
        first_l = np.where(nz, ops_out[2 * (ar * stride) + 1], 0)
        last_at = ar * stride + np.maximum(no - 1, 0)
        last_c = np.where(nz, ops_out[2 * last_at], -1)
        last_l = np.where(nz, ops_out[2 * last_at + 1], 0)
        first_clip = (first_c == OP_S) & (first_l >= MIN_RESCUE)
        last_clip = (last_c == OP_S) & (last_l >= MIN_RESCUE)
        special = (rc_out != 0) | first_clip | last_clip
        pos_g = pos_out.astype(np.int64).copy()
        ed = ed_out.astype(np.int64).copy()
        nmatch = nm_out.astype(np.int64).copy()
        vote = vote_out.astype(np.int64).copy()
        cig_list: Dict[int, np.ndarray] = {}
        intron_special = {}
        special_idx = np.nonzero(special)[0]
        # one revcomp per (read, strand) — several specials share a read
        seq_cache: Dict[tuple, np.ndarray] = {}

        def _seq(i):
            ri, rank = flat[i]
            s = cands_by_read[ri][rank][1]
            key = (ri, s)
            sc = seq_cache.get(key)
            if sc is None:
                sc = revcomp(reads[ri]) if s == 1 else reads[ri]
                seq_cache[key] = sc
            return sc

        # batch-precompute the rescue clip seeds: ONE native minimizer
        # extraction + ONE index lookup for every clip in the batch
        # (the per-clip python pair cost ~0.25 ms x ~2k rescues/batch on
        # the ONT profile)
        pre_by_i: Dict[int, dict] = {}
        clip_specs = []                       # (record idx, side, clip)
        for i in special_idx:
            if rc_out[i]:
                continue                      # full re-extend path
            sc = _seq(i)
            if first_clip[i]:
                clip_specs.append((i, "lead", sc[:int(first_l[i])]))
            if last_clip[i]:
                clip_specs.append((i, "trail", sc[len(sc) -
                                                  int(last_l[i]):]))
        if clip_specs:
            h, qp, qs, rid, _l = self._batch_minimizers(
                [c for _, _, c in clip_specs])
            if h is None:
                h = np.zeros(0, np.uint64)
                qp = np.zeros(0, np.int64)
                qs = np.zeros(0, np.int8)
                rid = np.zeros(0, np.int32)
            lo, hi = self.index.lookup(h) if len(h) else (
                np.zeros(0, np.int64), np.zeros(0, np.int64))
            bounds = np.searchsorted(rid, np.arange(len(clip_specs) + 1))
            for j, (i, side, _) in enumerate(clip_specs):
                s0, s1 = int(bounds[j]), int(bounds[j + 1])
                pre_by_i.setdefault(int(i), {})[side] = (
                    h[s0:s1], qp[s0:s1], qs[s0:s1], lo[s0:s1], hi[s0:s1])
        for i in special_idx:
            ri, rank = flat[i]
            _, s, cq, cg = cands_by_read[ri][rank]
            seq_codes = _seq(i)
            if rc_out[i]:
                res = self.inner._extend(seq_codes, cq, cg)
            else:
                o0 = int(ostarts[i])
                base_ops = [(int(opc_f[o0 + t]), int(opl_f[o0 + t]))
                            for t in range(int(no[i]))]
                res = (int(pos_g[i]), base_ops, int(ed[i]), int(nmatch[i]),
                       int(vote[i]))
                res = self.inner._rescue_terminal_exons(
                    seq_codes, res, pre=pre_by_i.get(int(i)))
            pos_g[i], ops_i, ed[i], nmatch[i], vote[i] = res
            cig_list[i] = np.array([(l << 4) | op for op, l in ops_i
                                    if l > 0], np.uint32)
            intron_special[i] = any(op == OP_N for op, _ in ops_i)
        keep = nmatch >= p.min_score
        kept = np.nonzero(keep)[0]
        if not len(kept):
            return RecordBatch(
                [], np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.int64), np.zeros(0, np.int32),
                np.zeros(0, np.uint32), np.zeros(1, np.int64),
                reads_concat, read_offs, np.zeros(0, np.int32),
                np.zeros(0, np.int8), np.zeros(0, np.int64),
                np.zeros(0, np.int64), np.zeros(0, np.int32),
                np.zeros(0, np.int8))
        # vectorized CIGARs (drop zero-length ops, like the AlnRec path)
        emit_f = opl_f > 0
        vec_counts = np.bincount(rowrep[emit_f], minlength=n
                                 ).astype(np.int64)
        vec_flat = ((opl_f[emit_f].astype(np.int64) << 4) |
                    opc_f[emit_f].astype(np.int64)).astype(np.uint32)
        vec_offs = np.zeros(n + 1, np.int64)
        np.cumsum(vec_counts, out=vec_offs[1:])
        has_intron = np.zeros(n, bool)
        has_intron[rowrep[(opc_f == OP_N) & emit_f]] = True
        if not cig_list:
            # pure-vectorized fast path: select kept records' entries
            cig_buf = vec_flat[np.repeat(keep, vec_counts)]
            counts_kept = vec_counts[kept]
        else:
            segs = []
            counts_kept = np.empty(len(kept), np.int64)
            for t, i in enumerate(kept):
                c = cig_list.get(i)
                if c is None:
                    c = vec_flat[vec_offs[i]: vec_offs[i + 1]]
                else:
                    has_intron[i] = intron_special[i]
                segs.append(c)
                counts_kept[t] = len(c)
            cig_buf = (np.concatenate(segs) if segs
                       else np.zeros(0, np.uint32))
        cig_offs = np.zeros(len(kept) + 1, np.int64)
        np.cumsum(counts_kept, out=cig_offs[1:])
        tid, pos = self.index.global_to_chrom(pos_g[kept])
        # primary/secondary + NH are decided among SURVIVORS: when the
        # top-scoring chain fails the extension gate, the next kept
        # candidate is the read's primary (not an orphaned secondary with
        # MAPQ 0 and an overcounted NH).  The MAPQ margin still uses the
        # original candidate scores — a competing chain that failed
        # extension is still ambiguity evidence (mapq.py calibration).
        rid_kept = np.array([flat[i][0] for i in kept], np.int64)
        ranks, nh = _survivor_ranks(rid_kept)
        nh_cands = np.array([len(cands_by_read[ri]) for ri, _ in flat],
                            np.int32)[kept]
        s1 = np.array([cands_by_read[ri][0][0] for ri, _ in flat],
                      np.float64)[kept]
        s2 = np.array([cands_by_read[ri][1][0]
                       if len(cands_by_read[ri]) > 1 else 0.0
                       for ri, _ in flat], np.float64)[kept]
        mq = mapq_from_scores_vec(s1, s2, nh_cands, ranks)
        if self.record_margins:
            margin = 1.0 - s2 / np.maximum(s1, 1e-9)
            qn = [names[flat[i][0]] for i in kept]
            for t in np.nonzero(ranks == 0)[0]:
                self._mapq_margins[qn[t]] = float(margin[t])
        strand = cand_strand.astype(np.int8)[kept]
        flag = (np.where(strand == 1, FREVERSE, 0) |
                np.where(ranks > 0, FSECONDARY, 0)).astype(np.int32)
        xs = np.where(has_intron[kept] & (vote[kept] != 0),
                      np.sign(vote[kept]), 0).astype(np.int8)
        return RecordBatch(
            [names[flat[i][0]] for i in kept], flag,
            tid.astype(np.int32), pos.astype(np.int64), mq,
            cig_buf, cig_offs, reads_concat, read_offs,
            cand_read[kept].astype(np.int32), strand,
            ed[kept], (2 * nmatch[kept] - 4 * ed[kept]), nh, xs)

    def _records_from_extension(self, names, reads, flat, cands_by_read,
                                ext) -> List[AlnRec]:
        p = self.p
        (stride, pos_out, ops_out, n_ops, ed_out, nm_out, vote_out,
         rc_out) = ext
        recs: List[AlnRec] = []
        MIN_RESCUE = p.k + p.w + 4

        cur_ri = None
        cur_out: List[AlnRec] = []

        def _flush():
            if cur_ri is None or not cur_out:
                return
            cands = cands_by_read[cur_ri]
            mapq = (MAPQ_UNIQUE if len(cands) == 1 else
                    mapq_from_scores(cands[0][0], cands[1][0]))
            recs.extend(self._apply_survivor_ranks(cur_out, mapq))

        for i, (ri, rank) in enumerate(flat):
            if ri != cur_ri:
                _flush()
                cur_ri, cur_out = ri, []
            cands = cands_by_read[ri]
            score, s, cq, cg = cands[rank]
            codes = reads[ri]
            seq_codes = revcomp(codes) if s == 1 else codes
            if rc_out[i] != 0:
                res = self.inner._extend(seq_codes, cq, cg)
            else:
                base = i * 2 * stride
                no = int(n_ops[i])
                ops = [(int(ops_out[base + 2 * t]),
                        int(ops_out[base + 2 * t + 1])) for t in range(no)]
                res = (int(pos_out[i]), ops, int(ed_out[i]), int(nm_out[i]),
                       int(vote_out[i]))
                # terminal-exon rescue only when a big clip survived
                if ops and ((ops[0][0] == OP_S and ops[0][1] >= MIN_RESCUE) or
                            (ops[-1][0] == OP_S and
                             ops[-1][1] >= MIN_RESCUE)):
                    res = self.inner._rescue_terminal_exons(seq_codes, res)
            pos_g, ops, ed, nmatch, vote = res
            if nmatch < p.min_score:
                continue
            tid, pos = self.index.global_to_chrom(np.array([pos_g]))
            tid, pos = int(tid[0]), int(pos[0])
            flag = (FREVERSE if s == 1 else 0) | (FSECONDARY if rank else 0)
            cigar = np.array([(l << 4) | op for op, l in ops if l > 0],
                             np.uint32)
            tags = {"NM": ed, "AS": int(2 * nmatch - 4 * ed),
                    "NH": len(cands)}
            if vote != 0 and any(op == OP_N for op, _ in ops):
                tags["XS"] = "+" if vote > 0 else "-"
            cur_out.append(AlnRec(
                qname=names[ri], flag=flag, tid=tid, pos=pos,
                mapq=0, cigar=cigar,
                seq=decode_seq(seq_codes), qual="*", tags=tags))
        _flush()
        return recs

    def dispatch_batch(self, names: Sequence[str], reads: List[np.ndarray]):
        """Phase 1: seeding + async chain dispatch; returns a handle (the
        lockstep driver of a multi-process sharded index)."""
        t0 = time.perf_counter()
        rows = self._batch_anchors(reads)
        t1 = time.perf_counter()
        pending = self._chain_rows_async(rows)
        t2 = time.perf_counter()
        st = self.stats
        st["seed_s"] = st.get("seed_s", 0.0) + (t1 - t0)
        st["dispatch_s"] = st.get("dispatch_s", 0.0) + (t2 - t1)
        return (names, reads, rows, pending)

    def finish_batch(self, handle) -> List[AlnRec]:
        """Phase 2: materialize chains, extend, build records."""
        names, reads, rows, pending = handle
        chained = self._materialize_chains(rows, pending)
        return self._build_records(names, reads, rows, chained)

    def finish_batch_packed(self, handle):
        import time as _time
        names, reads, rows, pending = handle
        chained = self._materialize_chains(rows, pending)
        t0 = _time.perf_counter()
        out = self._build_packed(names, reads, rows, chained)
        self.stats["build_s"] = (self.stats.get("build_s", 0.0) +
                                 _time.perf_counter() - t0)
        return out

    def align_seqset_packed(self, reads: SeqSet,
                            batch_size: int = DEFAULT_BATCH,
                            pipeline_depth: int = 2,
                            polish: Optional[bool] = None) -> RecordBatch:
        """Whole-seqset alignment as one packed RecordBatch.

        A seed worker seeds batch N+1 (and packs its chain chunks) while
        the main thread launches batch N's chain kernels; a build worker
        extends and assembles batch N while the main thread waits on
        batch N+1's chains.  Up to `pipeline_depth` launched batches stay
        in flight.  Then the junction polish (default on; env
        LR2RMATS_NO_POLISH=1 turns it off) runs over the whole batch
        (`_polish`: the host DP here, the card's in TorchBatchAligner).

        The reference's weather router, device-failure fallbacks and
        auto-batch doubling guarded a remote TPU link and are left out."""
        if polish is None:
            polish = not os.environ.get("LR2RMATS_NO_POLISH")
        if getattr(self.index, "local_only", False):
            raise ValueError(
                "align_seqset_packed cannot drive a local_only "
                "(multi-process) sharded index: the seed-ahead worker "
                "would race its collective lookup")
        st = self.stats

        def _seed(lo: int, hi: int):
            names = [reads.names[i] for i in range(lo, hi)]
            codes = [reads.get(i) for i in range(lo, hi)]
            t0 = time.perf_counter()
            rows = self._batch_anchors(codes)
            prep = self._prepare_dispatch(rows)
            return names, codes, rows, prep, time.perf_counter() - t0

        def _build_one(names, codes, rows, chained):
            t0 = time.perf_counter()
            out = self._build_packed(names, codes, rows, chained)
            return out, time.perf_counter() - t0

        spans = [(off, min(off + batch_size, reads.n))
                 for off in range(0, reads.n, batch_size)]
        inflight = deque()
        build_futs = []
        with ThreadPoolExecutor(1) as seed_pool, \
                ThreadPoolExecutor(1) as build_pool:
            seed_futs = deque([seed_pool.submit(_seed, *spans[0])]
                              if spans else [])

            def _finish_one():
                names, codes, rows, pending = inflight.popleft()
                chained = self._materialize_chains(rows, pending)
                build_futs.append(build_pool.submit(
                    _build_one, names, codes, rows, chained))

            for si in range(len(spans)):
                names, codes, rows, prep, seed_s = seed_futs.popleft().result()
                st["seed_s"] = st.get("seed_s", 0.0) + seed_s
                if si + 1 < len(spans):
                    seed_futs.append(seed_pool.submit(_seed, *spans[si + 1]))
                t1 = time.perf_counter()
                pending = self._chain_rows_async(rows, prep)
                st["dispatch_s"] = (st.get("dispatch_s", 0.0) +
                                    time.perf_counter() - t1)
                inflight.append((names, codes, rows, pending))
                if len(inflight) > pipeline_depth:
                    _finish_one()
            while inflight:
                _finish_one()
            chunks = []
            for fut in build_futs:
                rb_i, build_s = fut.result()
                st["build_s"] = st.get("build_s", 0.0) + build_s
                chunks.append(rb_i)
        rb = RecordBatch.concat(chunks) if chunks else \
            RecordBatch.from_alnrecs([])
        if polish:
            t0 = time.perf_counter()
            n = self._polish(rb)
            st["polish_s"] = (st.get("polish_s", 0.0) +
                              time.perf_counter() - t0)
            if n:
                log("align", "junction consensus polish: %d re-placed", n)
        return rb

    def align_seqset(self, reads: SeqSet, batch_size: int = DEFAULT_BATCH,
                     pipeline_depth: int = 2,
                     polish: Optional[bool] = None) -> Iterator[AlnRec]:
        """Legacy per-record generator over `align_seqset_packed`."""
        rb = self.align_seqset_packed(reads, batch_size, pipeline_depth,
                                      polish)
        yield from rb.to_alnrecs()

    def _polish(self, rb: RecordBatch) -> int:
        """The junction consensus polish of the whole seqset (host DP)."""
        return polish_batch(rb, self.inner.genome.codes,
                            self.index.chrom_offsets)


class TorchBatchAligner(BatchAligner):
    """BatchAligner whose device paths run as hand-written CUDA kernels
    and torch ops (device="cuda") or as their plain PyTorch versions
    (device="cpu")."""

    def __init__(self, genome, params=None, index=None, device="cuda",
                 n_threads: Optional[int] = None,
                 junction_backend: Optional[str] = None,
                 seed_lookup: Optional[bool] = None,
                 backend: str = "torch",
                 devices: Optional[Sequence] = None):
        """junction_backend: "host" (inline in the native extension) or
        "device" (ops/junction.py; needs the native library, raises
        without it); None reads LR2RMATS_DEVICE_JUNCTIONS.
        seed_lookup: index lookup on the device (when the index supports
        it); None reads LR2RMATS_DEVICE_SEED=1.
        backend: "torch" (the fused chain kernel in the reference's row
        routing) or "pallas" (every row through the DP-only kernel, host
        backtrack).
        devices: the devices each chain launch is split over; default
        [device]."""
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        if junction_backend is None:
            junction_backend = (
                "device" if os.environ.get("LR2RMATS_DEVICE_JUNCTIONS")
                in _JUNCTION_ENV else "host")
        if junction_backend not in ("host", "device"):
            raise ValueError(f"junction_backend must be 'host' or 'device', "
                             f"got {junction_backend!r}")
        if junction_backend == "device" and get_lib() is None:
            raise RuntimeError(
                "junction_backend='device' needs the native library "
                "(csrc/lrio.cpp) for its collect and assemble passes, and "
                "it is unavailable (no g++, or LR2RMATS_NO_NATIVE is set)")
        self.device = resolve_device(device)
        self.devices = ([self.device] if devices is None else
                        [resolve_device(d) for d in devices])
        if not self.devices:
            raise ValueError("devices must name at least one device")
        super().__init__(genome, params, index, n_threads=n_threads)
        self.backend = backend
        self.junction_backend = junction_backend
        if seed_lookup is None:
            seed_lookup = os.environ.get("LR2RMATS_DEVICE_SEED") == "1"
        self._seed_lookup = (TorchSeedLookup(self.index, self.device)
                             if seed_lookup and
                             TorchSeedLookup.supports(self.index) else None)

    @staticmethod
    def fresh_stats() -> Dict[str, float]:
        return {"device_wall_s": 0.0, "anchors": 0, "device_calls": 0,
                "chain_kernel_launches": 0, "shift_dp_kernel_launches": 0,
                "junction_kernel_launches": 0, "seed_lookup_calls": 0,
                "junction_calls": 0, "junction_gaps": 0, "junction_found": 0}

    @classmethod
    def from_jax_aligner(cls, al, device="cuda",
                         devices: Optional[Sequence] = None
                         ) -> "TorchBatchAligner":
        """A port aligner built from a reference `BatchAligner` `al`: the
        port's Genome, AlignParams / ChainParams and MinimizerIndex (or
        sharded index) are made from `al`'s fields and share its numpy
        arrays, without importing the reference package.  It takes `al`'s
        junction backend, its choice of device seed lookup and its chain
        backend ("pallas" stays "pallas"; "jax" and "host" take the port's
        default fused kernel)."""
        return cls(_port_genome(al.inner.genome), params=_port_params(al.p),
                   index=_port_index(al.index), device=device,
                   n_threads=al.n_threads,
                   junction_backend=al.junction_backend,
                   seed_lookup=al._seed_lookup is not None,
                   backend="pallas" if al.backend == "pallas" else "torch",
                   devices=devices)

    # ------------------------------------------------------------ chaining
    def _prepare_dispatch(self, rows: List[_Row]):
        """Host side of the chain dispatch: route rows, chain the small
        bucket natively, pack the fixed device chunks (backend="pallas":
        pack every row into PALLAS_CHUNK-row chunks).  Numpy/C only, so it
        runs on the seed worker."""
        if self.backend == "pallas":
            dp = []
            for off in range(0, len(rows), PALLAS_CHUNK):
                part = range(off, min(off + PALLAS_CHUNK, len(rows)))
                widest = max(len(rows[i].qpos) for i in part)
                A = max(A_BUCKETS[0], 1 << (widest - 1).bit_length())
                dp.append((off, *_pack_rows(rows, part, A, len(part))))
            return dict(pre=[], chunks=[], host_rows=[], dp=dp)
        a_cap = A_BUCKETS[-1]
        n_rows = len(rows)
        lens = np.fromiter((len(r.qpos) for r in rows), np.int64, n_rows)
        nbig = np.fromiter((r.n_big for r in rows), np.int64, n_rows)
        qmx = np.fromiter((r.q_max for r in rows), np.int64, n_rows)
        host_mask = (lens > a_cap) | (nbig > EXC_ROWS) | (qmx >= (1 << 16))
        host_rows: List[int] = np.nonzero(host_mask)[0].tolist()
        bsel = np.searchsorted(np.array(A_BUCKETS, np.int64), lens)
        buckets: Dict[int, List[int]] = {}
        for bi, A in enumerate(A_BUCKETS):
            members = np.nonzero(~host_mask & (bsel == bi))[0].tolist()
            if members:
                buckets[A] = members

        pending = []
        lib = get_lib()
        small_max = A_BUCKETS[0]
        if lib is not None and small_max in buckets:
            part = buckets.pop(small_max)
            m = len(part)
            qp, gp, nn = _pack_rows(rows, part, small_max, m)
            mask = np.zeros((m, small_max), np.uint8)
            ps = np.zeros(m, np.float32)
            ss = np.zeros(m, np.float32)
            pc = self.p.chain
            lib.chain_small_batch_c(
                qp, gp, nn, m, small_max,
                pc.k, pc.window, pc.max_intron, pc.max_qgap,
                pc.gap_open, pc.gap_scale, pc.intron_scale,
                pc.min_intron_gap, float(self.p.min_score),
                mask.reshape(-1), ps, ss)
            pending.append(("small", part, nn, small_max, (mask, ps, ss)))
        chunks = []
        for A in (A_BUCKETS[1:] if lib is not None else A_BUCKETS):
            members = buckets.get(A, [])
            C = self._chunk(A)
            for off in range(0, len(members), C):
                part = members[off: off + C]
                chunks.append((part, A, *_pack_rows(rows, part, A, C)))
        return dict(pre=pending, chunks=chunks, host_rows=host_rows, dp=[])

    def _chain_rows_async(self, rows: List[_Row], prep=None):
        """Launch the chain kernel on every device chunk, split over the
        devices; returns the pending list (device tensors not yet copied
        back)."""
        if prep is None:
            prep = self._prepare_dispatch(rows)
        pending = list(prep["pre"])
        kp = chain_params_for_kernel(self.p.chain)
        n0 = _chain_launches()
        for part, A, qp, gp, nn in prep["chunks"]:
            res = launch_rows(chain_dp_backtrack, (qp, gp, nn), self.devices,
                              FUSED_MIN_ROWS, kp, self.p.min_score)
            pending.append(("device", part, nn, A, res))
            self.stats["device_calls"] += 1
        for off, qp, gp, nn in prep["dp"]:
            res = launch_rows(chain_dp, (qp, gp, nn), self.devices,
                              DP_MIN_ROWS, kp)
            pending.append(("dp", off, nn, res))
            self.stats["device_calls"] += 1
        self.stats["chain_kernel_launches"] += _chain_launches() - n0
        if prep["host_rows"]:
            pending.append(("hostrows", prep["host_rows"]))
        return pending

    def _materialize_chains(self, rows: List[_Row], pending):
        """Resolve chains as per-row (pri_idx, ps, sec_idx, ss) tuples."""
        out: List[Optional[tuple]] = [None] * len(rows)
        for entry in pending:
            kind = entry[0]
            if kind == "hostrows":
                for i in entry[1]:
                    r = rows[i]
                    f, parent = chain_anchors(r.qpos, r.gpos, self.p.chain)
                    out[i] = backtrack(f, parent, self.p.min_score)
                self.stats["anchors"] += sum(len(rows[i].qpos)
                                             for i in entry[1])
                continue
            if kind == "dp":
                _, off, nn, res = entry
                t0 = time.perf_counter()
                f, parent = gather_rows(res)
                self.stats["device_wall_s"] += time.perf_counter() - t0
                self.stats["anchors"] += int(np.sum(nn))
                for bi, n in enumerate(nn.tolist()):
                    out[off + bi] = backtrack(
                        f[bi, :n].astype(np.float64),
                        parent[bi, :n].astype(np.int64), self.p.min_score)
                continue
            _, part, nn, A, res = entry
            if kind == "device":
                t0 = time.perf_counter()
                res = gather_rows(res)
                self.stats["device_wall_s"] += time.perf_counter() - t0
            self.stats["anchors"] += int(np.sum(nn))
            _decode(out, part, nn, A, *res)
        return out

    # ------------------------------------------------- junctions on device
    def _collect_junction_gaps(self, lib, packed, n_cand):
        """The native collect pass (csrc collect_gaps_batch_c) over the
        batch's candidates.  Returns (col, gaps, dev_offs): col holds the
        pass's output arrays for the assemble pass, gaps the (q, left_ref,
        right_ref, el, er) slots left to the device DP in candidate order,
        dev_offs the per-candidate offsets into gaps."""
        p = self.p
        (_, _, reads_concat, read_offs, cand_read, cand_strand, aq, ag,
         a_offs, _) = packed
        ref = self.inner.genome.codes
        BLK = A_BUCKETS[-1]
        n_slot = n_cand * _GSTRIDE
        col = dict(
            blocks=np.zeros(n_cand * BLK * 3, np.int64),
            n_blocks=np.zeros(n_cand, np.int32),
            jflag=np.zeros(n_slot, np.int8),
            jq=np.zeros(n_slot * MGAP, np.uint8),
            jqlen=np.zeros(n_slot, np.int32),
            jlref=np.zeros(n_slot, np.int64),
            jrref=np.zeros(n_slot, np.int64),
            jclean_j=np.zeros(n_slot, np.int32),
            jclean_vote=np.zeros(n_slot, np.int32),
            jel=np.zeros(n_slot, np.int32),
            jer=np.zeros(n_slot, np.int32),
            n_junc=np.zeros(n_cand, np.int32))
        lib.collect_gaps_batch_c(
            reads_concat, read_offs, ref, len(ref),
            cand_read, cand_strand, aq, ag, a_offs,
            p.k, p.min_intron_gap, p.min_intron_len, MGAP,
            n_cand, BLK, _GSTRIDE,
            col["blocks"], col["n_blocks"], col["jflag"], col["jq"],
            col["jqlen"], col["jlref"], col["jrref"], col["jclean_j"],
            col["jclean_vote"], col["jel"], col["jer"], col["n_junc"],
            self.n_threads)
        jflag, jq, jqlen = col["jflag"], col["jq"], col["jqlen"]
        dev_offs = np.zeros(n_cand + 1, np.int64)
        gaps = []
        for i in range(n_cand):
            base = i * _GSTRIDE
            for s in range(max(int(col["n_junc"][i]), 0)):
                if jflag[base + s] == 0:
                    k = base + s
                    gaps.append((jq[k * MGAP: k * MGAP + int(jqlen[k])],
                                 int(col["jlref"][k]), int(col["jrref"][k]),
                                 int(col["jel"][k]), int(col["jer"][k])))
            dev_offs[i + 1] = len(gaps)
        return col, gaps, dev_offs

    def _extend_device_junctions(self, lib, packed, n_cand, max_len):
        """Two-pass extension with the junction DP on the device (reference
        BatchAligner._extend_device_junctions): collect (C) -> placements
        (the junction kernel: both flank DPs and the combine) -> cell op
        recovery (C) -> assemble
        (C).  Runs on the build worker."""
        p = self.p
        (_, _, reads_concat, read_offs, cand_read, cand_strand, _, _, _,
         _) = packed
        ref = self.inner.genome.codes
        col, gaps, dev_offs = self._collect_junction_gaps(lib, packed, n_cand)
        n_dev = len(gaps)
        B = JUNCTION_BAND
        dev_stride = MGAP + 2 * B + 4
        n_out = max(n_dev, 1)
        dev_found = np.zeros(n_out, np.uint8)
        dev_ilen = np.zeros(n_out, np.int64)
        dev_vote = np.zeros(n_out, np.int32)
        dev_lo = np.zeros((n_out, 2 * dev_stride), np.int32)
        dev_ro = np.zeros((n_out, 2 * dev_stride), np.int32)
        dev_ln = np.zeros(n_out, np.int32)
        dev_rn = np.zeros(n_out, np.int32)
        if n_dev:
            st = self.stats
            n0 = dict(_build.LAUNCHES)
            batch = prepare_junction_batch(ref, gaps, B)
            score, bj, bcl, bcr, vote, found = junction_batch(
                batch, p.min_intron_len, self.device)
            st["junction_calls"] += 1
            st["junction_gaps"] += n_dev
            st["junction_found"] += int(found.sum())
            st["junction_kernel_launches"] += (_build.LAUNCHES["junction"] -
                                               n0["junction"])
            dev_found[:n_dev] = found
            dev_vote[:n_dev] = vote
            dev_ilen[:n_dev] = (batch["span"] - batch["m"] + 2 * B -
                                (bcl + bcr))
            sel = np.nonzero(found)[0]
            if len(sel):
                lo, ln, ro, rn = cell_ops(lib, ref, gaps, sel, bj, bcl, bcr,
                                          B)
                dev_lo[sel] = lo
                dev_ro[sel] = ro
                dev_ln[sel] = ln
                dev_rn[sel] = rn
        stride = max_len + 80
        pos_out = np.empty(n_cand, np.int64)
        ops_out = np.empty(n_cand * 2 * stride, np.int32)
        n_ops = np.empty(n_cand, np.int32)
        ed_out = np.empty(n_cand, np.int64)
        nm_out = np.empty(n_cand, np.int64)
        vote_out = np.empty(n_cand, np.int32)
        rc_out = np.empty(n_cand, np.int32)
        lib.assemble_ops_batch_c(
            reads_concat, read_offs, ref, len(ref),
            self.index.chrom_offsets, len(self.index.chrom_offsets) - 1,
            cand_read, cand_strand, col["blocks"], col["n_blocks"],
            col["jflag"], col["jq"], col["jqlen"], col["jlref"],
            col["jrref"], col["jclean_j"], col["jclean_vote"], col["jel"],
            col["jer"], col["n_junc"],
            dev_offs, dev_found, dev_ilen, dev_vote,
            dev_lo.reshape(-1), dev_ln, dev_ro.reshape(-1), dev_rn,
            dev_stride,
            p.k, p.min_intron_gap, p.min_intron_len, p.band_pad,
            p.ext_match, p.ext_mismatch, 4,
            n_cand, A_BUCKETS[-1], _GSTRIDE, stride, self.n_threads,
            pos_out, ops_out, n_ops, ed_out, nm_out, vote_out, rc_out)
        return (stride, pos_out, ops_out, n_ops, ed_out, nm_out, vote_out,
                rc_out)

    def warmup_chain_shapes(self) -> None:
        """Build the kernels and launch each production shape once on every
        device (every chain bucket chunk, or one DP-only chunk for
        backend="pallas"; the polish shift DP, and the junction kernel),
        so neither the nvcc build nor a first launch lands
        inside a timed region.  No-op on the CPU."""
        if self.device.type != "cuda":
            return
        _build.load()
        kp = chain_params_for_kernel(self.p.chain)
        dev = self.device
        if self.backend == "pallas":
            shapes = [(PALLAS_CHUNK, A_BUCKETS[-1])]
        else:
            shapes = [(self._chunk(A), A) for A in
                      (A_BUCKETS[1:] if get_lib() is not None else A_BUCKETS)]
        for B, A in shapes:
            qp = np.zeros((B, A), np.int32)
            qp[:, 1] = 1
            nn = np.full(B, 2, np.int32)
            if self.backend == "pallas":
                launch_rows(chain_dp, (qp, qp, nn), self.devices,
                            DP_MIN_ROWS, kp)
            else:
                launch_rows(chain_dp_backtrack, (qp, qp, nn), self.devices,
                            FUSED_MIN_ROWS, kp, self.p.min_score)
        q = torch.zeros((_PLACE_M, _PLACE_G), dtype=torch.int8, device=dev)
        win = torch.zeros((_PLACE_M + POLISH_BAND, _PLACE_G),
                          dtype=torch.int8, device=dev)
        m = torch.full((_PLACE_G,), _PLACE_M, dtype=torch.int32, device=dev)
        shift_dp(q, win, m, POLISH_BAND)
        G, B = 128, JUNCTION_BAND
        q = torch.zeros((MGAP, G), dtype=torch.int32, device=dev)
        win = torch.zeros((MGAP + B, G), dtype=torch.int32, device=dev)
        m = torch.full((G,), MGAP, dtype=torch.int32, device=dev)
        cls = torch.zeros((MGAP + 2 * B + 1, G), dtype=torch.int8,
                          device=dev)
        span = torch.full((G,), 1000, dtype=torch.int64, device=dev)
        junction_place(q, q, win, win, m, span, cls, cls, m, m, B,
                       self.p.min_intron_len)
        for d in {dev, *self.devices}:
            torch.cuda.synchronize(d)

    def _polish(self, rb: RecordBatch) -> int:
        """The junction consensus polish with its placement DP on
        `device`, counting the shift-DP launches."""
        n0 = _build.LAUNCHES["shift_dp"]
        n = polish_batch(rb, self.inner.genome.codes,
                         self.index.chrom_offsets, self.device)
        self.stats["shift_dp_kernel_launches"] += (_build.LAUNCHES["shift_dp"]
                                                   - n0)
        return n


def _copy_fields(cls, obj, **override):
    """An instance of dataclass `cls` with the same-named fields of `obj`."""
    return cls(**{f.name: override.get(f.name, getattr(obj, f.name))
                  for f in fields(cls)})


def _port_genome(g) -> Genome:
    return Genome(list(g.names), g.codes, g.offsets)


def _port_params(p) -> AlignParams:
    return _copy_fields(AlignParams, p,
                        chain=_copy_fields(ChainParams, p.chain))


def _port_index(idx):
    """The port's MinimizerIndex (or ShardedMinimizerIndex) of a reference
    index object."""
    if hasattr(idx, "shards"):
        from ..parallel.shard_index import ShardedMinimizerIndex
        out = ShardedMinimizerIndex(
            [None if s is None else _port_index(s) for s in idx.shards],
            local_only=idx.local_only)
        if idx.local_only:
            out.local_shard = idx.local_shard
        return out
    return _copy_fields(MinimizerIndex, idx, names=list(idx.names))
