"""A seed-selection batch of the whole-genome shape, for the seed_select
kernel's card test (tests/test_torch_kernels.py) and chip_smoke.py.

`grch38_like(seed)` draws, from the seed, what `TorchSeedLookup.select`
hands the kernel for one 1536-read batch of Iso-Seq reads on GRCh38
(~2600 bases a read, ~870 queries and ~4400 hits a read, ~6.7 M hits):
reads of 600-12000 bases, one query every 3 bases, 1-50 hits a query
(geometric, mean ~5), the first hit of most queries on the read's own
chain (400-base exons joined by introns of 0.2-20 kb, a strand a read)
and the rest
anywhere in a 3.09 Gbp genome of 24 chromosomes, some in pairs nearby
(groups of two, ties in the ranking).  A read in 50 lies across a
chromosome boundary.  Each query's range lies at a random place of the
table, as a hash's places lie in the index.

`args(batch, device)` gives `seed_select`'s tensors; `select_bytes` the
bytes the selection needs (the bound in chip_smoke.py).
"""

from __future__ import annotations

import numpy as np

GENOME_BP = 3_088_269_832
K = 15


def grch38_like(seed: int, reads: int = 1536) -> dict:
    rng = np.random.default_rng(seed)
    offsets = np.linspace(0, GENOME_BP, 25).astype(np.int64)
    lens = np.clip(rng.lognormal(np.log(2400), 0.45, reads), 600,
                   12_000).astype(np.int64)
    nq = lens // 3
    qoff = np.zeros(reads + 1, np.int64)
    np.cumsum(nq, out=qoff[1:])
    total_q = int(qoff[-1])
    rid = np.repeat(np.arange(reads), nq)
    within = np.arange(total_q) - qoff[rid]
    # query positions: one every ~3 bases, increasing, inside L - K
    qp = np.minimum(within * 3 + rng.integers(0, 3, total_q),
                    lens[rid] - K)
    qs = rng.integers(0, 2, total_q)
    cnt = np.minimum(rng.geometric(0.2, total_q), 50)
    cnt[rng.random(total_q) < 0.05] = 0
    # each read's chain: a start, a strand, an intron of 0.2-20 kb after
    # every 400 bases of the read
    st = rng.integers(0, 2, reads)
    ilen = rng.integers(200, 20_000, reads)
    g0 = rng.integers(offsets[0] + 10**6, offsets[-1] - 10**6, reads)
    edge = rng.random(reads) < 0.02
    cut = offsets[rng.integers(1, 24, reads)]
    g0[edge] = cut[edge] - lens[edge] // 2
    qf = np.where(st[rid] == 1, lens[rid] - K - qp, qp)
    true_g = g0[rid] + qf + (qf // 400) * ilen[rid]
    total = int(cnt.sum())
    cs = np.cumsum(cnt)
    first = cs - cnt
    hq = np.repeat(np.arange(total_q), cnt)
    pos = rng.integers(0, GENOME_BP, total)
    strand = rng.integers(0, 2, total)
    # pairs: every tenth spurious hit lands near the one before it
    near = rng.random(total) < 0.1
    near[0] = False
    pos[near] = np.minimum(pos[np.nonzero(near)[0] - 1] +
                           rng.integers(1, 5_000, int(near.sum())),
                           GENOME_BP - 1)
    lead = cnt > 0
    on_chain = lead & (rng.random(total_q) < 0.8)
    pos[first[on_chain]] = true_g[on_chain]
    strand[first[on_chain]] = qs[on_chain] ^ st[rid[on_chain]]
    # lay the queries' ranges out at random places of the table
    perm = rng.permutation(total_q)
    place = np.zeros(total_q, np.int64)
    place[perm] = np.cumsum(cnt[perm]) - cnt[perm]
    table = np.empty(max(total, 1), np.int64)
    table[place[hq] + (np.arange(total) - first[hq])] = (pos << 1) | strand
    return {"table": table, "chrom_off": offsets,
            "lo": place.astype(np.int32), "cs": cs.astype(np.int64),
            "hoff": np.concatenate([[0], cs])[qoff].astype(np.int64),
            "qoff": qoff.astype(np.int32),
            "qpack": ((qp << 1) | qs).astype(np.int32),
            "read_len": lens.astype(np.int32), "hits": cnt}


def args(batch: dict, device):
    """seed_select's eight tensors, in order, on `device`."""
    import torch
    return tuple(torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
                 for k in ("table", "chrom_off", "lo", "cs", "hoff", "qoff",
                           "qpack", "read_len"))


def select_bytes(batch: dict, kept: int) -> int:
    """Bytes the selection needs: the 32-byte table sectors its hits fall
    in, each query's lo, cs and qpack (16 bytes), each read's bounds, and
    the kept anchors and row descriptions written once.  The keys stay in
    shared memory and are not counted."""
    cnt = batch["hits"]
    hq = np.repeat(np.arange(len(cnt)), cnt)
    ent = batch["lo"][hq].astype(np.int64) + (np.arange(len(hq)) -
                                              (batch["cs"] - cnt)[hq])
    sectors = len(np.unique(ent * 8 // 32))
    B = len(batch["read_len"])
    return (32 * sectors + 16 * len(cnt) + (8 + 4 + 4) * (B + 1)
            + 8 * kept + 8 * 33 * B)
