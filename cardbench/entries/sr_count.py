"""Entry kind `sr_count`: short read pairs through the port's junction
counter on the device backend.

One call is `TorchJunctionCounter.count_pairs_batched` on one pooled batch
of pairs, ending in a synchronise of the card: the Hamming verify on
csrc/hamming.cu and the count scatters as torch ops, the rest on the host.
Set-up generates the deployment and the pool, builds the counter (its seed
tables and the device-resident buffer) and counts the pool's last batch
once outside the window.  The counts accumulate over every call, the
warm-up's included, which is the state the counter keeps; nothing else
carries over, so a batch counted again when the window wraps adds the same
counts again.

Once the window has closed, the counts are read from the counter, the
counter is freed, and the plain reference (ref_sjcount) counts each pooled
batch once; the expected counts are each batch's times the number of
times it was counted, and the largest overhang over the batches counted.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from .. import gen, ref_sjcount


class Entry:
    counts = "short_reads"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.dev = torch.device(device)

    def setup(self) -> None:
        from lr2rmats_tpu_torch.io.fasta import Genome, SeqSet
        from lr2rmats_tpu_torch.junctions.sjcount import (SJCountParams,
                                                          TorchJunctionCounter)
        dep = self.dep = gen.build_deployment(self.cfg, self.seed)
        self.batches = gen.short_pair_batches(dep, self.traffic, self.seed)
        self.introns = dep.introns()
        c = self.cfg["counter"]
        params = SJCountParams(**{k: c[k] for k in (
            "overhang", "min_overhang", "seed_k", "max_mm_frac",
            "seeds_per_read", "max_mates_gap")})
        it = self.introns.astype(np.int32)
        self.counter = TorchJunctionCounter(
            Genome(dep.names, dep.codes, dep.offsets), it[:, 0], it[:, 1],
            it[:, 2], np.ones(len(it), np.int32), params, device=self.dev)

        def seqset(r):
            n, L = r.shape
            return SeqSet(["p"] * n, r.reshape(-1),
                          np.arange(n + 1, dtype=np.int64) * L)

        self.pool = [(seqset(r1), seqset(r2)) for r1, r2 in self.batches]
        self.times = np.zeros(len(self.pool), np.int64)
        self.call(len(self.pool) - 1)

    def call(self, n: int) -> int:
        """The window's n-th call; returns the short reads it counted."""
        k = n % len(self.pool)
        s1, s2 = self.pool[k]
        with torch.profiler.record_function("cardbench.count_pairs_batched"):
            self.counter.count_pairs_batched(s1, s2)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.times[k] += 1
        return 2 * s1.n

    def layer_record(self) -> dict:
        return {}

    def finish(self) -> None:
        jc = self.counter
        uniq, multi, over = (jc.uniq_c.astype(np.int64),
                             jc.multi_c.astype(np.int64),
                             jc.max_over.astype(np.int64))
        if jc._dev_counts is not None:
            du, dm, do = jc._dev_counts.fetch()
            uniq, multi, over = uniq + du, multi + dm, np.maximum(over, do)
        self.served = (uniq, multi, over)
        del self.counter, jc
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def expected(self, proper_pairs: bool = True):
        """The reference's (uniq, multi, max_over) for the calls made."""
        c = self.cfg["counter"]
        ref = ref_sjcount.Reference(
            self.dep.codes, self.dep.offsets, self.introns,
            ref_sjcount.Params(**{k: c[k] for k in (
                "overhang", "min_overhang", "seed_k", "max_mm_frac",
                "seeds_per_read", "max_mates_gap", "cap_per_seed")}),
            self.dev)
        nj = len(self.introns)
        uniq, multi, over = (np.zeros(nj, np.int64) for _ in range(3))
        for k, t in enumerate(self.times):
            if t:
                u, m, o = ref.count(*self.batches[k], proper_pairs)
                uniq += t * u
                multi += t * m
                over = np.maximum(over, o)
        return uniq, multi, over

    def judge(self, limits: dict):
        """[(number, value, limit)]: the junctions whose unique count,
        multi count or largest overhang differs from the reference's."""
        want = self.expected()
        diff = np.zeros(len(self.introns), bool)
        for got, exp in zip(self.served, want):
            diff |= got != exp
        return ([("count_diffs", int(diff.sum()), limits["count_diffs"])],
                {"junctions": len(diff), "batches_counted":
                 self.times.tolist(), "uniq_total": int(want[0].sum()),
                 "multi_total": int(want[1].sum())})
