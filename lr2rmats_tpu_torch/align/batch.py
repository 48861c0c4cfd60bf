"""Batched long-read aligner with its accelerator layer on PyTorch + CUDA.

`TorchBatchAligner` subclasses the reference's `BatchAligner`
(lr2rmats_tpu/align/batch.py) and keeps its host work unchanged: seeding
(minimizer extraction + index lookup in csrc), anchor clustering, the
native chain of small rows, splice-aware extension, RecordBatch assembly
and SAM.  It overrides only the chain dispatch, which runs the fused chain
DP + backtrack kernel (ops/chain.py), the whole-seqset entry point and the
polish call, whose placement DP runs the shift-DP kernel (align/polish.py).

Row routing is the reference's, so the same rows chain on the card, in the
native small-row chain and on the host: rows of at most A_BUCKETS[0]
anchors chain natively; rows over A_BUCKETS[-1] anchors, with more than
EXC_ROWS reference deltas >= 2^16, or with query positions >= 2^16 chain on
the host; the rest go to the card in fixed CHAIN_CHUNK chunks per bucket.

Dropped with respect to the reference, which needed them only to survive
a remote TPU link: the weather router, the device-failure fallbacks, the
u16/delta packing of the chain input, and the auto-batch doubling.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from lr2rmats_tpu.align.batch import (A_BUCKETS, DEFAULT_BATCH,
                                      BatchAligner, _Row)
from lr2rmats_tpu.align.chain import backtrack, chain_anchors
from lr2rmats_tpu.align.records import RecordBatch
from lr2rmats_tpu.io.fasta import SeqSet
from lr2rmats_tpu.native import get_lib
from lr2rmats_tpu.utils import log

from ..device import resolve_device
from ..ops import _build
from ..ops.chain import chain_dp_backtrack, chain_params_for_kernel
from ..ops.splice import shift_dp
from .polish import _PLACE_G, _PLACE_M, B as POLISH_BAND, polish_batch

# Rows with more oversized (>= 2^16) reference deltas than this chain on the
# host, as in the reference, whose packed chain buffer has EXC_ROWS
# exception slots per row (lr2rmats_tpu/ops/chain_jax.py:122).  The port's
# kernel takes int32 positions and has no such limit; the routing is kept so
# that the same rows chain on the host in both.
EXC_ROWS = 8

# Environment switches of the reference that would reach its jax code.
_REFUSED_ENV = {
    "LR2RMATS_DEVICE_JUNCTIONS": (("1", "scan", "pallas"),
                                  "Device junction DP"),
    "LR2RMATS_DEVICE_SEED": (("1",), "Device seed lookup"),
}


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
    """BatchAligner whose chain DP and polish placement DP run as
    hand-written CUDA kernels (device="cuda") or as their plain PyTorch
    versions (device="cpu")."""

    def __init__(self, genome, params=None, index=None, device="cuda",
                 n_threads: Optional[int] = None):
        for var, (on_values, item) in _REFUSED_ENV.items():
            if os.environ.get(var, "") in on_values:
                raise RuntimeError(
                    f"{var}={os.environ[var]} selects a device path that "
                    "lr2rmats_tpu_torch has not ported yet (ROADMAP.md "
                    f"queue 1, '{item}'); unset it")
        self.device = resolve_device(device)
        super().__init__(genome, params, index, backend="torch",
                         n_threads=n_threads, junction_backend="host")
        self.stats = self.fresh_stats()

    @staticmethod
    def fresh_stats() -> Dict[str, float]:
        return {"device_wall_s": 0.0, "anchors": 0, "device_calls": 0,
                "chain_kernel_launches": 0, "shift_dp_kernel_launches": 0}

    @classmethod
    def from_jax_aligner(cls, al: BatchAligner, device="cuda"
                         ) -> "TorchBatchAligner":
        """A port aligner sharing `al`'s AlignParams / ChainParams and its
        MinimizerIndex object."""
        return cls(al.inner.genome, params=al.p, index=al.index,
                   device=device, n_threads=al.n_threads)

    # ------------------------------------------------------------ chaining
    def _prepare_dispatch(self, rows: List[_Row]):
        """Host side of the chain dispatch: route rows, chain the small
        bucket natively, pack the fixed device chunks.  Numpy/C only, so
        it runs on the seed worker."""
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

        def pack_chunk(A, part, B):
            qp = np.zeros((B, A), np.int32)
            gp = np.zeros((B, A), np.int32)
            nn = np.zeros(B, np.int32)
            ns = np.array([len(rows[i].qpos) for i in part], np.int64)
            nn[:len(part)] = ns
            rowrep = np.repeat(np.arange(len(part)), ns)
            offs = np.zeros(len(part) + 1, np.int64)
            np.cumsum(ns, out=offs[1:])
            col = np.arange(offs[-1]) - np.repeat(offs[:-1], ns)
            if part:
                qp[rowrep, col] = np.concatenate([rows[i].qpos for i in part])
                gp[rowrep, col] = (np.concatenate(
                    [rows[i].gpos for i in part]) -
                    np.repeat(np.array([rows[i].base for i in part],
                                       np.int64), ns))
            return qp, gp, nn

        pending = []
        lib = get_lib()
        small_max = A_BUCKETS[0]
        if lib is not None and small_max in buckets:
            part = buckets.pop(small_max)
            m = len(part)
            qp, gp, nn = pack_chunk(small_max, part, m)
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
                chunks.append((part, A, *pack_chunk(A, part, C)))
        return dict(pre=pending, chunks=chunks, host_rows=host_rows)

    def _chain_rows_async(self, rows: List[_Row], prep=None):
        """Launch the chain kernel on every device chunk; returns the
        pending list (device tensors not yet copied back)."""
        if prep is None:
            prep = self._prepare_dispatch(rows)
        pending = list(prep["pre"])
        kp = chain_params_for_kernel(self.p.chain)
        dev = self.device
        n0 = _build.LAUNCHES["chain_dp_backtrack"]
        for part, A, qp, gp, nn in prep["chunks"]:
            res = chain_dp_backtrack(
                torch.from_numpy(qp).to(dev), torch.from_numpy(gp).to(dev),
                torch.from_numpy(nn).to(dev), kp, self.p.min_score)
            pending.append(("device", part, nn, A, res))
            self.stats["device_calls"] += 1
        self.stats["chain_kernel_launches"] += (
            _build.LAUNCHES["chain_dp_backtrack"] - n0)
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
            _, part, nn, A, res = entry
            if kind == "device":
                t0 = time.perf_counter()
                res = tuple(t.cpu().numpy() for t in res)
                self.stats["device_wall_s"] += time.perf_counter() - t0
            self.stats["anchors"] += int(np.sum(nn))
            _decode(out, part, nn, A, *res)
        return out

    def warmup_chain_shapes(self) -> None:
        """Build the kernels and launch each production shape once (every
        chain bucket chunk, and the polish shift DP), so neither the nvcc
        build nor a first launch lands inside a timed region.  No-op on the
        CPU."""
        if self.device.type != "cuda":
            return
        _build.load()
        kp = chain_params_for_kernel(self.p.chain)
        dev = self.device
        for A in (A_BUCKETS[1:] if get_lib() is not None else A_BUCKETS):
            B = self._chunk(A)
            qp = torch.zeros((B, A), dtype=torch.int32, device=dev)
            qp[:, 1] = 1
            nn = torch.full((B,), 2, dtype=torch.int32, device=dev)
            chain_dp_backtrack(qp, qp.clone(), nn, kp, self.p.min_score)
        q = torch.zeros((_PLACE_M, _PLACE_G), dtype=torch.int8, device=dev)
        win = torch.zeros((_PLACE_M + POLISH_BAND, _PLACE_G),
                          dtype=torch.int8, device=dev)
        m = torch.full((_PLACE_G,), _PLACE_M, dtype=torch.int32, device=dev)
        shift_dp(q, win, m, POLISH_BAND)
        torch.cuda.synchronize(dev)

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
