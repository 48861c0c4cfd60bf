"""Batched long-read aligner with its accelerator layer on PyTorch + CUDA.

`TorchBatchAligner` subclasses the reference's `BatchAligner`
(lr2rmats_tpu/align/batch.py) and keeps its host work unchanged: minimizer
extraction, anchor clustering, the native chain of small rows, splice-aware
extension, RecordBatch assembly and SAM.  The device paths are the port's:

  * the chain dispatch runs the fused chain DP + backtrack kernel
    (ops/chain.py `chain_dp_backtrack`), or with backend="pallas" the
    DP-only kernel at any row width (`chain_dp`) and the reference's host
    backtrack;
  * the junction polish runs its placement DP on the shift-DP kernel
    (align/polish.py);
  * with the device junction backend (`junction_backend="device"`, or
    LR2RMATS_DEVICE_JUNCTIONS=1|scan|pallas) the extension's junction gaps
    are placed by the shift-DP and combine kernels (ops/junction.py),
    between the reference's native collect and assemble passes;
  * with LR2RMATS_DEVICE_SEED=1 the index lookup runs against a
    device-resident table (index/seed_device.py).

Row routing is the reference's, so the same rows chain on the card, in the
native small-row chain and on the host: rows of at most A_BUCKETS[0]
anchors chain natively; rows over A_BUCKETS[-1] anchors, with more than
EXC_ROWS reference deltas >= 2^16, or with query positions >= 2^16 chain on
the host; the rest go to the card in fixed CHAIN_CHUNK chunks per bucket.
backend="pallas" mirrors the reference's backend of that name
(batch.py:879-902): every row, in chunks of PALLAS_CHUNK rows at the next
power of two of the chunk's widest row, goes to the DP-only kernel, and
align/chain.py `backtrack` runs on each row's f / parent in float64.

With several `devices` (cards of this process) each chain launch is split
into contiguous row blocks, one per card, as the reference shards its
chain dispatch over its local devices (ops/chain.py `split_rows`); the
outputs are the same.  Seeding lookups, junctions and polish run on
`device`.

Dropped with respect to the reference, which needed them only to survive
a remote TPU link: the weather router, the device-failure fallbacks (a
failing device path raises), the u16/delta packing of the chain input, and
the auto-batch doubling.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from lr2rmats_tpu.align.aligner import SpliceAligner
from lr2rmats_tpu.align.batch import (A_BUCKETS, DEFAULT_BATCH,
                                      BatchAligner, _Row)
from lr2rmats_tpu.align.chain import backtrack, chain_anchors
from lr2rmats_tpu.align.records import RecordBatch
from lr2rmats_tpu.io.fasta import SeqSet
from lr2rmats_tpu.native import get_lib
from lr2rmats_tpu.utils import default_threads, log

from ..device import resolve_device
from ..index.seed_device import TorchSeedLookup
from ..ops import _build
from ..ops.chain import (DP_MIN_ROWS, FUSED_MIN_ROWS, chain_dp,
                         chain_dp_backtrack, chain_params_for_kernel,
                         gather_rows, launch_rows)
from ..ops.junction import (B_DEF as JUNCTION_BAND, MGAP, cell_ops, combine,
                            junction_batch, prepare_junction_batch)
from ..ops.splice import shift_dp
from .polish import _PLACE_G, _PLACE_M, B as POLISH_BAND, polish_batch

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
    """Per-row (pri_idx, ps, sec_idx, ss) from a chunk's mask / scores
    (the reference's decode in BatchAligner._materialize_chains)."""
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
        "device" (ops/junction.py); None reads LR2RMATS_DEVICE_JUNCTIONS.
        seed_lookup: index lookup on the device (when the index supports
        it); None reads LR2RMATS_DEVICE_SEED=1.
        backend: "torch" (the fused chain kernel in the reference's row
        routing) or "pallas" (every row through the DP-only kernel, host
        backtrack).
        devices: the devices each chain launch is split over; default
        [device].

        The reference constructor is not called: it would build its JAX
        seed table under LR2RMATS_DEVICE_SEED=1.  This sets the state that
        the inherited host methods read."""
        self.device = resolve_device(device)
        self.devices = ([self.device] if devices is None else
                        [resolve_device(d) for d in devices])
        if not self.devices:
            raise ValueError("devices must name at least one device")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        self.backend = backend
        self.inner = SpliceAligner(genome, params, index)
        self.p = self.inner.p
        self.index = self.inner.index
        self.refs = self.inner.refs
        if junction_backend is None:
            junction_backend = (
                "device" if os.environ.get("LR2RMATS_DEVICE_JUNCTIONS")
                in _JUNCTION_ENV else "host")
        if junction_backend not in ("host", "device"):
            raise ValueError(f"junction_backend must be 'host' or 'device', "
                             f"got {junction_backend!r}")
        self.junction_backend = junction_backend
        if seed_lookup is None:
            seed_lookup = os.environ.get("LR2RMATS_DEVICE_SEED") == "1"
        self._seed_lookup = (TorchSeedLookup(self.index, self.device)
                             if seed_lookup and
                             TorchSeedLookup.supports(self.index) else None)
        self.n_threads = max(1, n_threads if n_threads is not None
                             else default_threads())
        self._pool = None
        self._pool_lock = threading.Lock()
        self.chunk_scale = 1
        self.record_margins = False
        self._mapq_margins: Dict[str, float] = {}
        self.stats = self.fresh_stats()

    @staticmethod
    def fresh_stats() -> Dict[str, float]:
        return {"device_wall_s": 0.0, "anchors": 0, "device_calls": 0,
                "chain_kernel_launches": 0, "shift_dp_kernel_launches": 0,
                "combine_kernel_launches": 0, "seed_lookup_calls": 0,
                "junction_calls": 0, "junction_gaps": 0, "junction_found": 0}

    @classmethod
    def from_jax_aligner(cls, al: BatchAligner, device="cuda",
                         devices: Optional[Sequence] = None
                         ) -> "TorchBatchAligner":
        """A port aligner sharing `al`'s AlignParams / ChainParams and its
        MinimizerIndex object, with its junction backend, its choice of
        device seed lookup and its chain backend ("pallas" stays "pallas";
        "jax" and "host" take the port's default fused kernel)."""
        return cls(al.inner.genome, params=al.p, index=al.index,
                   device=device, n_threads=al.n_threads,
                   junction_backend=al.junction_backend,
                   seed_lookup=al._seed_lookup is not None,
                   backend="pallas" if al.backend == "pallas" else "torch",
                   devices=devices)

    def _device_fallback(self, where: str, err: BaseException) -> None:
        """The reference logs a device failure here and routes the rest of
        the run to its host paths; the port has no fallback and re-raises."""
        raise err

    # ------------------------------------------------------------- seeding
    def _batch_anchors(self, reads: List[np.ndarray]) -> List[_Row]:
        """The reference's seeding (its lookup through `_seed_lookup` when
        one is installed), counting the device lookups in stats."""
        lk = self._seed_lookup
        n0 = lk.calls if lk is not None else 0
        rows = super()._batch_anchors(reads)
        if lk is not None:
            self.stats["seed_lookup_calls"] += lk.calls - n0
        return rows

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
        (shift-DP + combine kernels) -> cell op recovery (C) -> assemble
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
            st["combine_kernel_launches"] += (_build.LAUNCHES["combine"] -
                                              n0["combine"])
            st["shift_dp_kernel_launches"] += (_build.LAUNCHES["shift_dp"] -
                                               n0["shift_dp"])
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
        backend="pallas"; the polish shift DP, and the junction shift DP
        and combine), so neither the nvcc build nor a first launch lands
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
        S = shift_dp(q, win, m, B)
        cls = torch.zeros((MGAP + 2 * B + 1, G), dtype=torch.int8,
                          device=dev)
        span = torch.full((G,), 1000, dtype=torch.int64, device=dev)
        combine(S, S, m, span, cls, cls, m, m, B, self.p.min_intron_len)
        for d in {dev, *self.devices}:
            torch.cuda.synchronize(d)

    # ------------------------------------------------------------ top level
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
        LR2RMATS_NO_POLISH=1 turns it off) runs over the whole batch."""
        if polish is None:
            polish = not os.environ.get("LR2RMATS_NO_POLISH")
        if getattr(self.index, "local_only", False):
            raise ValueError(
                "align_seqset_packed cannot drive a local_only "
                "(multi-process) sharded index: the seed-ahead worker "
                "would race its collective lookup")
        self.chunk_scale = 1
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
            n0 = _build.LAUNCHES["shift_dp"]
            n = polish_batch(rb, self.inner.genome.codes,
                             self.index.chrom_offsets, self.device)
            st["shift_dp_kernel_launches"] += _build.LAUNCHES["shift_dp"] - n0
            st["polish_s"] = (st.get("polish_s", 0.0) +
                              time.perf_counter() - t0)
            if n:
                log("align", "junction consensus polish: %d re-placed", n)
        return rb
