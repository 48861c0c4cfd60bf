"""Entry kind `align`: long reads through the port's batched aligner.

One call is `TorchBatchAligner.align_seqset_packed` on one pooled read set
followed by `RecordBatch.emit_sam`, as the pipeline's alignment stage runs
them.  Set-up generates the deployment and the pool of calls, builds the
aligner (its minimizer index), warms the kernels up
(`warmup_chain_shapes`) and makes one whole call on the pool's last read
set outside the window, since a first call is the slow one.  The aligner
keeps no state between calls but its counters (`stats`, reset before the
window), so a call repeated when the window wraps round the pool does the
same work again.

The SAM text of the window's first call and of its last call is kept and
judged once the window has closed and the aligner is freed
(ref_align.judge): every read of both against its planted gene and
introns, and a sample of SCORED reads, drawn from the seed, against its
best alignment to its transcript.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import gen, ref_align

# reads of the judged calls whose score deficit the reference takes
SCORED = 8192


class Entry:
    counts = "long_reads"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.dev = torch.device(device)
        self.emit_s = 0.0
        self.judged = {}

    def setup(self) -> None:
        from lr2rmats_tpu_torch.align.batch import TorchBatchAligner
        from lr2rmats_tpu_torch.io.fasta import Genome, SeqSet
        cfg = self.cfg
        self.generate()
        self.pool = [SeqSet(self.names, codes, offs)
                     for _, codes, offs, _ in self.calls]
        dep = self.dep
        al = cfg["aligner"]
        self.aligner = TorchBatchAligner(
            Genome(dep.names, dep.codes, dep.offsets), device=self.dev,
            junction_backend=al["junction_backend"],
            seed_lookup=al["seed_lookup"], backend=al["backend"])
        self.aligner.warmup_chain_shapes()
        self._align(len(self.pool) - 1)
        self.aligner.stats = self.aligner.fresh_stats()
        self.emit_s = 0.0

    def generate(self) -> None:
        """The deployment and the pool of calls, from the seed."""
        per = int(self.cfg["reads_per_call"])
        self.dep = gen.build_deployment(self.cfg, self.seed)
        self.calls = gen.long_read_calls(self.dep, per, self.cfg["profile"],
                                         self.traffic, self.seed)
        self.names = [f"r{i}" for i in range(per)]

    def _align(self, k: int) -> bytes:
        with torch.profiler.record_function("cardbench.align_seqset_packed"):
            rb = self.aligner.align_seqset_packed(self.pool[k],
                                                  self.cfg["aligner"]["batch"])
        t0 = time.perf_counter()
        with torch.profiler.record_function("cardbench.emit_sam"):
            sam = rb.emit_sam(self.aligner.refs)
        self.emit_s += time.perf_counter() - t0
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return sam

    def call(self, n: int) -> int:
        """The window's n-th call; returns the reads it aligned."""
        k = n % len(self.pool)
        sam = self._align(k)
        if n == 0:
            self.judged["first"] = (k, sam)
        self.judged["last"] = (k, sam)
        return self.pool[k].n

    def layer_record(self) -> dict:
        return {"align_stats": dict(self.aligner.stats),
                "emit_s": self.emit_s}

    def finish(self) -> None:
        self.aligner.close()
        del self.aligner
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def judged_calls(self, ks) -> list:
        """ref_align.Judged of pool calls `ks`, with the SAM text given."""
        names = [n.encode() for n in self.names]
        out = []
        for k, sam in ks:
            gene_ids, codes, offs, rc = self.calls[k]
            out.append(ref_align.Judged(
                sam, names, [codes[offs[i]: offs[i + 1]]
                             for i in range(len(offs) - 1)],
                rc, [self.dep.genes[int(g)] for g in gene_ids]))
        return out

    def judge(self, limits: dict):
        """[(number, value, limit)] of the judged calls, and what they were
        computed from."""
        # pool index -> SAM: a read set met twice is judged once
        judged = dict([self.judged["first"], self.judged["last"]])
        ks = sorted(judged)
        calls = self.judged_calls([(k, judged[k]) for k in ks])
        sample = score_sample([len(c.names) for c in calls], self.seed)
        res = ref_align.judge(calls, self.dep, sample, self.dev)
        return ref_align.numbers(res, limits), {
            "judged_calls": ks,
            **{k: res[k] for k in ("reads_judged", "reads_repeated",
                                   "introns_judged",
                                   "introns_moved_same_splice",
                                   "reads_scored", "unaligned")}}


def score_sample(sizes, seed: int, n: int = SCORED):
    """The (call, read) pairs of the judged calls whose score deficit is
    taken: `n` of them, drawn from the seed, in order."""
    total = sum(sizes)
    pick = np.sort(gen.rng_of(seed, 3).choice(total, min(n, total),
                                              replace=False))
    starts = np.cumsum([0] + list(sizes))
    k = np.searchsorted(starts, pick, side="right") - 1
    return [(int(a), int(b)) for a, b in zip(k, pick - starts[k])]
