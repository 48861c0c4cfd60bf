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
    (ops/chain.py `chain_dp_backtrack`);
  * the junction polish runs its placement DP on the shift-DP kernel
    (align/polish.py);
  * with the device junction backend (`junction_backend="device"`, or
    LR2RMATS_DEVICE_JUNCTIONS=1|scan|pallas) the extension's junction gaps
    are placed by the junction kernel (ops/junction.py junction_place),
    between the native collect and assemble passes;
  * with LR2RMATS_DEVICE_SEED=1 the index lookup runs against a
    device-resident table (index/seed_device.py), and where the host
    path's sort key fits, the hits are expanded, sorted, grouped and
    selected there too (the seed_select kernel, `_card_anchors`): the
    same rows as the host path, with only the kept anchors copied back.

Row routing is the reference's, so the same rows chain on the card, in the
native small-row chain and on the host: rows of at most A_BUCKETS[0]
anchors chain natively; rows over A_BUCKETS[-1] anchors, with more than
EXC_ROWS reference deltas >= 2^16, or with query positions >= 2^16 chain on
the host; the rest go to the card in fixed CHAIN_CHUNK chunks per bucket.

With several `devices` (cards of this process) each chain launch is split
into contiguous row blocks, one per card, as the reference shards its
chain dispatch over its local devices (ops/chain.py `split_rows`); the
outputs are the same.  Seeding lookups, junctions and polish run on
`device`.

Left out with respect to the reference: its "pallas" chain backend (every
row on the DP-only kernel, then a host backtrack; the same SAM, and slower
on the card), and, as the reference needed them only to survive a remote
TPU link, its JAX backends, the weather router, the
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
from ..index.seed_device import MAX_CLUSTERS_PER_STRAND, TorchSeedLookup
from ..io.fasta import Genome, SeqSet, decode_seq, revcomp
from ..io.sam import FREVERSE, FSECONDARY, OP_N, AlnRec
from ..native import get_lib
from ..ops import _build
from ..ops.chain import (FUSED_MIN_ROWS, chain_dp_backtrack,
                         chain_params_for_kernel, gather_rows, launch_rows)
from ..ops.junction import (B_DEF as JUNCTION_BAND, MGAP, cell_ops,
                            junction_batch, junction_place,
                            prepare_junction_batch)
from ..utils import default_threads, log
from ..utils.log import count, current_call, span
from .aligner import AlignParams, SpliceAligner
from .chain import ChainParams, backtrack, chain_anchors
from .mapq import MAPQ_UNIQUE, mapq_from_scores, mapq_from_scores_vec
from .polish import (_PLACE_G, _PLACE_M, B as POLISH_BAND, place_lanes,
                     polish_batch)
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
# band of the terminal-exon rescue's junction DP (align/splice.py
# refine_splice_indel's default, as SpliceAligner._rescue_terminal_exons
# calls it)
RESCUE_BAND = 4


def _rescue_tables(index):
    """The index as the native rescue pass reads it: six columns over its
    hash tables (address, length, bucket starts' address, bucket count,
    shift, base into the position and strand arrays), and those two
    arrays.  A plain index is one table; an in-process sharded index one a
    shard, routed by hash % shards (its `lookup`'s routing); a
    multi-process one answers from its local shard alone, as its `lookup`
    does."""
    shards = getattr(index, "shards", None)
    if shards is None:
        tabs, pos, strand = [(index, 0)], index.pos, index.strand
    elif index.local_only:
        tabs = [(s if i == index.local_shard else None, 0)
                for i, s in enumerate(shards)]
        local = shards[index.local_shard]
        pos, strand = local.pos, local.strand
    else:
        tabs = list(zip(shards, index._base.tolist()))
        pos, strand = index.pos, index.strand
    rows = []
    for t, base in tabs:
        if t is None or not len(t.hashes):
            rows.append((0, 0, 0, 0, 0, 0))
            continue
        if t.hashes.dtype != np.uint64 or not t.hashes.flags.c_contiguous:
            raise TypeError("the rescue reads a C-ordered uint64 hash table")
        t._ensure_buckets()
        rows.append((t.hashes.ctypes.data, len(t.hashes),
                     t._bstart.ctypes.data, t._nbuckets, t._bshift, base))
    cols = [np.array(c, np.int32 if j == 4 else np.int64)
            for j, c in enumerate(zip(*rows))]
    # passed as they are (the binding checks int64 / int8, C order): a
    # converted copy of a whole-genome table would cost gigabytes a batch
    return cols, pos, strand


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


def _rows(read, strand, base, n_big, q_max, offs, q, g) -> List[_Row]:
    """_Rows from columns: row j is read[j]'s on strand[j], its anchors
    q, g [offs[j]:offs[j + 1]] (plain slices: np.split's wrapper costs ~10
    us a row)."""
    o = offs.tolist()
    return [_Row(r, s, q[o[j]: o[j + 1]], g[o[j]: o[j + 1]], b, nb, qm)
            for j, (r, s, b, nb, qm) in enumerate(zip(
                read.tolist(), strand.tolist(), base.tolist(),
                n_big.tolist(), q_max.tolist()))]


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
        # the seed and build workers and the main thread add to one stats
        # dict (`_add_stats`)
        self._stats_lock = threading.Lock()
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

    def _add_stats(self, **inc) -> None:
        """stats[k] += v for each keyword, under the stats lock."""
        with self._stats_lock:
            st = self.stats
            for k, v in inc.items():
                st[k] = st.get(k, 0) + v

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
        idx = self.index
        h, qp, qs, rid, lens = self._batch_minimizers(reads)
        if h is None:
            return []
        # sharded indexes expose the batch-level (possibly collective)
        # lookup separately (parallel/shard_index.py); the device lookup
        # (index/seed_device.py, LR2RMATS_DEVICE_SEED=1) slots in only
        # for plain single-shard indexes, and selects the hits on the
        # device too where its key fits (`_card_anchors`)
        look = getattr(idx, "lookup_collective", None)
        if (look is None and self._seed_lookup is not None and
                self._seed_lookup.selects(len(reads), max(lens))):
            return self._card_anchors(h, qp, qs, rid, lens)
        if look is None and self._seed_lookup is not None:
            tw = self._seed_lookup
            c0, w0 = tw.thread_counts()
            lo, hi = tw.lookup(h)
            c1, w1 = tw.thread_counts()
            self._add_stats(device_wall_s=w1 - w0, device_calls=c1 - c0,
                            seed_lookup_calls=c1 - c0)
        else:
            lo, hi = (look or idx.lookup)(h)
        cnt = (hi - lo).astype(np.int64)
        # the lookup's work, under tracing: its queries and the places
        # they hit before grouping
        count("lr2rmats.align.lookup_queries", len(h))
        count("lr2rmats.align.hits", int(cnt.sum()))
        keep = cnt > 0
        if not keep.any():
            return []
        return self._rows_from_ranges(lo[keep], cnt[keep], qp[keep],
                                      qs[keep], rid[keep], lens, len(reads))

    def _rows_from_ranges(self, lo, cnt, qp, qs, rid, lens,
                          n_reads: int) -> List[_Row]:
        """The host path's rows of the queries (qp, qs, rid) with index
        ranges lo .. lo + cnt (cnt > 0), of a batch of `n_reads` reads of
        `lens` bases: expand, sort, group, select and subsample."""
        p = self.p
        idx = self.index
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
                  and n_reads <= (1 << 12)
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
        if n_reads <= (1 << 12) and (not n_g or
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
        return _rows(g_rid[sel], g_str[sel], gp[starts], n_big, q_max, cum,
                     q_all, g_all)

    def _card_anchors(self, h, qp, qs, rid, lens) -> List[_Row]:
        """The rows of `_rows_from_ranges`, with the lookup and the hit
        selection on the device (index/seed_device.py
        `TorchSeedLookup.select`): only the kept anchors come back.  The
        reads whose hits overflow the device's sort take the host path
        alone; the rows keep the order read, strand, rank.  Counts (under
        tracing) the hits selected on the device (`hits_card`) and the
        reads left to the host (`seed_host_reads`)."""
        tw = self._seed_lookup
        c0, w0 = tw.thread_counts()
        pc = self.p.chain
        sel = tw.select(h, qp, qs, rid, np.asarray(lens, np.int64), self.p.k,
                        pc.max_intron, pc.max_qgap, A_BUCKETS[-1])
        c1, w1 = tw.thread_counts()
        self._add_stats(device_wall_s=w1 - w0, device_calls=c1 - c0,
                        seed_lookup_calls=c1 - c0)
        hits = int(sel.read_hits.sum())
        host = sel.meta[:, 0] < 0
        count("lr2rmats.align.lookup_queries", len(h))
        count("lr2rmats.align.hits", hits)
        count("lr2rmats.align.hits_card",
              hits - int(sel.read_hits[host].sum()))
        count("lr2rmats.align.seed_host_reads", int(host.sum()))
        rows = _rows(*sel.rows())
        cnt = sel.host_hi - sel.host_lo
        keep = cnt > 0
        if keep.any():
            hq = sel.host_queries[keep]
            rows = sorted(rows + self._rows_from_ranges(
                sel.host_lo[keep], cnt[keep], qp[hq], qs[hq], rid[hq], lens,
                len(lens)), key=lambda r: r.read_i)
        return rows

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
        """Scalar twin of _survivor_ranks for `_extend_read`:
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
        native packed builder and the python `_extend_read`, which must
        stay bit-identical."""
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
        """The batch's records as AlnRecs: with the native library and
        more than 8 reads, `_build_packed`'s records; otherwise one python
        extension a read."""
        p = self.p
        if per_read is None:
            per_read = self._collect_candidates(rows, chained)
        order = sorted(per_read)
        if get_lib() is not None and len(order) > 8:
            return self._build_packed(names, reads, rows, chained,
                                      per_read).to_alnrecs()

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

    def _build_packed(self, names, reads, rows, chained, per_read=None):
        """RecordBatch (struct-of-arrays) result for the batch — the
        production path; `_build_records` gives its records as AlnRecs,
        and is its fallback without the native library or with at most 8
        reads."""
        if per_read is None:
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

    def _rescue_terminal(self, lib, reads_concat, read_offs, cand_read,
                         cand_strand, ext) -> np.ndarray:
        """The terminal-exon rescue of the batch's candidates with rc == 0
        (`SpliceAligner._rescue_terminal_exons`, the same records): one
        threaded native pass (csrc rescue_terminal_batch_c) that rewrites
        the placed candidates in `ext` in place.  Returns its flags a
        candidate: clips seeded (bits 0-1), placed (bits 2-3), and 16 where
        the rewritten ops outgrew the stride and nothing was written."""
        p = self.p
        (stride, pos_out, ops_out, n_ops, ed_out, nm_out, vote_out,
         rc_out) = ext
        n = len(pos_out)
        tabs, pos, strand = _rescue_tables(self.index)
        flags = np.zeros(n, np.int8)
        ref = self.inner.genome.codes
        lib.rescue_terminal_batch_c(
            reads_concat, read_offs, ref, len(ref),
            self.index.chrom_offsets, len(self.index.chrom_offsets) - 1,
            cand_read, cand_strand, len(tabs[0]), *tabs,
            pos, strand, p.k, p.w, p.chain.max_intron, p.min_intron_len,
            RESCUE_BAND, n, stride, self.n_threads, rc_out,
            pos_out, ops_out, n_ops, ed_out, nm_out, vote_out, flags)
        return flags

    def _packed_from_extension(self, names, reads, flat, cands_by_read,
                               reads_concat, read_offs, cand_read,
                               cand_strand, ext):
        """Vectorized RecordBatch assembly from the batch extension
        outputs, after the native terminal-exon rescue: only the rare
        native-refused (rc != 0) candidates, and those whose rescue
        outgrew the op stride, take a per-record path.  Bit-identical
        output is tested against the reference's records."""
        p = self.p
        with span("lr2rmats.align.rescue"):
            flags = self._rescue_terminal(get_lib(), reads_concat,
                                          read_offs, cand_read, cand_strand,
                                          ext)
        count("lr2rmats.align.rescue_clips", int((flags & 3).sum()))
        count("lr2rmats.align.rescue_placed",
              int(((flags >> 2) & 3).sum()))
        (stride, pos_out, ops_out, n_ops, ed_out, nm_out, vote_out,
         rc_out) = ext
        n = len(flat)
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
        pos_g = pos_out.astype(np.int64).copy()
        ed = ed_out.astype(np.int64).copy()
        nmatch = nm_out.astype(np.int64).copy()
        vote = vote_out.astype(np.int64).copy()
        cig_list: Dict[int, np.ndarray] = {}
        intron_special = {}
        for i in np.nonzero((rc_out != 0) | (flags >= 16))[0]:
            ri, rank = flat[i]
            _, s, cq, cg = cands_by_read[ri][rank]
            seq_codes = revcomp(reads[ri]) if s == 1 else reads[ri]
            if rc_out[i]:
                res = self.inner._extend(seq_codes, cq, cg)
            else:
                o0 = int(ostarts[i])
                base_ops = [(int(opc_f[o0 + t]), int(opl_f[o0 + t]))
                            for t in range(int(no[i]))]
                res = self.inner._rescue_terminal_exons(
                    seq_codes, (int(pos_g[i]), base_ops, int(ed[i]),
                                int(nmatch[i]), int(vote[i])))
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
        # vectorized CIGARs (drop zero-length ops, like `_extend_read`)
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

    def dispatch_batch(self, names: Sequence[str], reads: List[np.ndarray]):
        """Phase 1: seeding + async chain dispatch; returns a handle (the
        lockstep driver of a multi-process sharded index)."""
        with span("lr2rmats.align.seed", self, "seed_s"):
            rows = self._batch_anchors(reads)
        with span("lr2rmats.align.dispatch", self, "dispatch_s"):
            pending = self._chain_rows_async(rows)
        return (names, reads, rows, pending)

    def finish_batch(self, handle) -> List[AlnRec]:
        """Phase 2: materialize chains, extend, build records."""
        names, reads, rows, pending = handle
        chained = self._materialize_chains(rows, pending)
        return self._build_records(names, reads, rows, chained)

    def finish_batch_packed(self, handle):
        names, reads, rows, pending = handle
        with span("lr2rmats.align.chain_wait"):
            chained = self._materialize_chains(rows, pending)
        with span("lr2rmats.align.build", self, "build_s"):
            return self._build_packed(names, reads, rows, chained)

    def align_seqset_packed(self, reads: SeqSet,
                            batch_size: int = DEFAULT_BATCH,
                            pipeline_depth: int = 2,
                            polish: Optional[bool] = None) -> RecordBatch:
        """Whole-seqset alignment as one packed RecordBatch.

        Seed workers seed the next batches (and pack their chain chunks)
        while the main thread launches batch N's chain kernels; build
        workers extend and assemble the launched batches while the main
        thread waits on the next batch's chains.  Up to `pipeline_depth`
        launched batches stay in flight.  LR2RMATS_SEED_WORKERS and
        LR2RMATS_BUILD_WORKERS (default 1 each) size the two pools; the
        batches keep their order whatever order the workers finish in.
        Then the junction polish (default on; env LR2RMATS_NO_POLISH=1
        turns it off) runs over the whole batch (`_polish`: the host DP
        here, the card's in TorchBatchAligner).

        The reference's weather router, device-failure fallbacks and
        auto-batch doubling guarded a remote TPU link and are left out."""
        if polish is None:
            polish = not os.environ.get("LR2RMATS_NO_POLISH")
        if getattr(self.index, "local_only", False):
            raise ValueError(
                "align_seqset_packed cannot drive a local_only "
                "(multi-process) sharded index: the seed-ahead worker "
                "would race its collective lookup")
        with span("lr2rmats.align.call"):
            return self._align_packed(reads, batch_size, pipeline_depth,
                                      polish)

    def _align_packed(self, reads: SeqSet, batch_size: int,
                      pipeline_depth: int, polish: bool) -> RecordBatch:
        """The body of `align_seqset_packed`, inside its call span.  Each
        layer boundary is a span (utils/log.py): the workers' seed,
        prepare and build; the main thread's seed_wait, dispatch,
        chain_wait, build_wait and polish.  The worker spans add to
        stats seed_s (seed and prepare) and build_s, the main thread's to
        dispatch_s and polish_s."""
        cid = current_call()

        def _seed(lo: int, hi: int):
            names = [reads.names[i] for i in range(lo, hi)]
            codes = [reads.get(i) for i in range(lo, hi)]
            with span("lr2rmats.align.seed", self, "seed_s", call=cid):
                rows = self._batch_anchors(codes)
            with span("lr2rmats.align.prepare", self, "seed_s", call=cid):
                prep = self._prepare_dispatch(rows)
            return names, codes, rows, prep

        def _build_one(names, codes, rows, chained):
            with span("lr2rmats.align.build", self, "build_s", call=cid):
                return self._build_packed(names, codes, rows, chained)

        spans = [(off, min(off + batch_size, reads.n))
                 for off in range(0, reads.n, batch_size)]
        count("lr2rmats.align.batches", len(spans))
        inflight = deque()
        build_futs = []
        n_build = int(os.environ.get("LR2RMATS_BUILD_WORKERS", "1"))
        # the device junction build makes card calls on its build worker;
        # it keeps to one worker, as the reference's does
        if n_build > 1 and self.junction_backend == "device":
            log("align", "LR2RMATS_BUILD_WORKERS>1 ignored: "
                "the device junction backend builds on one worker")
            n_build = 1
        # extra seed workers are safe (the seed work is batch-local, the
        # index is read-only, and the seed_futs deque keeps batch order),
        # but where the native kernels already use every core they can
        # lose: the reference measured seeding and the device wait both
        # slower with 2 seed workers on a 4-core host.  Default 1; raise
        # LR2RMATS_SEED_WORKERS on hosts with spare cores.
        n_seed = max(int(os.environ.get("LR2RMATS_SEED_WORKERS", "1")), 1)
        with ThreadPoolExecutor(n_seed) as seed_pool, \
                ThreadPoolExecutor(max(n_build, 1)) as build_pool:
            seed_futs = deque(seed_pool.submit(_seed, *spans[i])
                              for i in range(min(n_seed, len(spans))))

            def _finish_one():
                names, codes, rows, pending = inflight.popleft()
                with span("lr2rmats.align.chain_wait"):
                    chained = self._materialize_chains(rows, pending)
                build_futs.append(build_pool.submit(
                    _build_one, names, codes, rows, chained))

            for si in range(len(spans)):
                with span("lr2rmats.align.seed_wait"):
                    names, codes, rows, prep = seed_futs.popleft().result()
                nxt = si + len(seed_futs) + 1
                if nxt < len(spans):
                    seed_futs.append(seed_pool.submit(_seed, *spans[nxt]))
                with span("lr2rmats.align.dispatch", self, "dispatch_s"):
                    pending = self._chain_rows_async(rows, prep)
                inflight.append((names, codes, rows, pending))
                if len(inflight) > pipeline_depth:
                    _finish_one()
            while inflight:
                _finish_one()
            # the wait on the build workers and the join of their batches
            with span("lr2rmats.align.build_wait"):
                rb = RecordBatch.concat([fut.result() for fut in build_futs])
        if polish:
            with span("lr2rmats.align.polish", self, "polish_s"):
                n = self._polish(rb)
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
        backend: "torch", the one chain dispatch (the fused chain kernel in
        the reference's row routing); any other value raises.
        devices: the devices each chain launch is split over; default
        [device]."""
        if backend != "torch":
            raise ValueError(f"backend must be 'torch', got {backend!r}")
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
                "polish_trace_kernel_launches": 0,
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
        junction backend and its choice of device seed lookup; every chain
        backend of the reference ("jax", "pallas", "host") takes the
        port's one chain dispatch, which gives the same SAM."""
        return cls(_port_genome(al.inner.genome), params=_port_params(al.p),
                   index=_port_index(al.index), device=device,
                   n_threads=al.n_threads,
                   junction_backend=al.junction_backend,
                   seed_lookup=al._seed_lookup is not None,
                   devices=devices)

    # ------------------------------------------------------------ chaining
    def _prepare_dispatch(self, rows: List[_Row]):
        """Host side of the chain dispatch: route rows, chain the small
        bucket natively, pack the fixed device chunks.  Numpy/C only, so it
        runs on the seed worker.  Counts (under tracing) the chain rows,
        their anchors (as stats["anchors"] will) and the anchors of the
        rows routed to the host chain."""
        n_rows = len(rows)
        lens = np.fromiter((len(r.qpos) for r in rows), np.int64, n_rows)
        count("lr2rmats.align.rows", n_rows)
        count("lr2rmats.align.anchors", int(lens.sum()))
        a_cap = A_BUCKETS[-1]
        nbig = np.fromiter((r.n_big for r in rows), np.int64, n_rows)
        qmx = np.fromiter((r.q_max for r in rows), np.int64, n_rows)
        host_mask = (lens > a_cap) | (nbig > EXC_ROWS) | (qmx >= (1 << 16))
        count("lr2rmats.align.anchors_host", int(lens[host_mask].sum()))
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
        return dict(pre=pending, chunks=chunks, host_rows=host_rows)

    def _chain_rows_async(self, rows: List[_Row], prep=None):
        """Launch the chain kernel on every device chunk, split over the
        devices; returns the pending list (device tensors not yet copied
        back)."""
        if prep is None:
            prep = self._prepare_dispatch(rows)
        pending = list(prep["pre"])
        kp = chain_params_for_kernel(self.p.chain)
        n0 = _build.thread_launches("chain_dp_backtrack")
        for part, A, qp, gp, nn in prep["chunks"]:
            res = launch_rows(chain_dp_backtrack, (qp, gp, nn), self.devices,
                              FUSED_MIN_ROWS, kp, self.p.min_score)
            pending.append(("device", part, nn, A, res))
        self._add_stats(device_calls=len(prep["chunks"]),
                        chain_kernel_launches=(
                            _build.thread_launches("chain_dp_backtrack") - n0))
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
                self._add_stats(anchors=sum(len(rows[i].qpos)
                                            for i in entry[1]))
                continue
            _, part, nn, A, res = entry
            if kind == "device":
                t0 = time.perf_counter()
                res = gather_rows(res)
                self._add_stats(device_wall_s=time.perf_counter() - t0)
            self._add_stats(anchors=int(np.sum(nn)))
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
            # this thread's launches, whatever other threads launch
            n0 = _build.thread_launches("junction")
            batch = prepare_junction_batch(ref, gaps, B)
            score, bj, bcl, bcr, vote, found = junction_batch(
                batch, p.min_intron_len, self.device)
            self._add_stats(
                junction_calls=1, junction_gaps=n_dev,
                junction_found=int(found.sum()),
                junction_kernel_launches=(_build.thread_launches("junction")
                                          - n0))
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
        device (every chain bucket chunk; the polish placement's two shift
        DPs and its traceback, and the junction kernel),
        so neither the nvcc build nor a first launch lands
        inside a timed region.  No-op on the CPU."""
        if self.device.type != "cuda":
            return
        _build.load()
        kp = chain_params_for_kernel(self.p.chain)
        dev = self.device
        for A in A_BUCKETS[1:] if get_lib() is not None else A_BUCKETS:
            B = self._chunk(A)
            qp = np.zeros((B, A), np.int32)
            qp[:, 1] = 1
            nn = np.full(B, 2, np.int32)
            launch_rows(chain_dp_backtrack, (qp, qp, nn), self.devices,
                        FUSED_MIN_ROWS, kp, self.p.min_score)
        q = torch.zeros((_PLACE_M, _PLACE_G), dtype=torch.int8, device=dev)
        win = torch.zeros((_PLACE_M + POLISH_BAND, _PLACE_G),
                          dtype=torch.int8, device=dev)
        m = torch.full((_PLACE_G,), _PLACE_M, dtype=torch.int32, device=dev)
        d = torch.zeros((_PLACE_G,), dtype=torch.int32, device=dev)
        place_lanes(q, q, win, win, m, d, d, POLISH_BAND)
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
        `device`, counting the shift-DP and traceback launches."""
        n0 = _build.thread_launches("shift_dp")
        t0 = _build.thread_launches("polish_trace")
        n = polish_batch(rb, self.inner.genome.codes,
                         self.index.chrom_offsets, self.device)
        self._add_stats(
            shift_dp_kernel_launches=_build.thread_launches("shift_dp") - n0,
            polish_trace_kernel_launches=(
                _build.thread_launches("polish_trace") - t0))
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
