"""The terminal-exon rescue as one native pass over a batch (csrc
rescue_terminal_batch_c through `BatchAligner._rescue_terminal`), held to
the host version `SpliceAligner._rescue_terminal_exons` record for record:

  * hand-made records on a three-chromosome genome, one case a kind of
    clip: small leading and trailing exons, both, junk, a noisy lead
    rejected while the trail is placed, a noisy trail, exons at a
    chromosome's first and last bases, seeds of more than 16 places, a
    tie of diagonal counts, a strand-1 candidate, zero-length runs, a
    refused candidate, and ops that outgrow their stride;
  * the same on a hash-range-sharded index, in one process and as one
    process of three;
  * `_build_packed`'s records and SAM bytes against the per-read path
    (`_build_records` without the native library) on small copies of the
    benchmark's `chr21_ont_deep` and `grch38_isoseq_genome` cells, with
    the counter `lr2rmats.align.rescue_clips` equal to the clips the host
    version seeds.
"""

import numpy as np
import pytest

from cardbench import gen
from cardbench.tests.small import small_cell
from lr2rmats_tpu_torch.align import aligner as port_aligner
from lr2rmats_tpu_torch.align import batch as port_batch
from lr2rmats_tpu_torch.align.batch import BatchAligner, TorchBatchAligner
from lr2rmats_tpu_torch.align.records import RecordBatch
from lr2rmats_tpu_torch.io.fasta import Genome, revcomp
from lr2rmats_tpu_torch.io.sam import OP_I, OP_M, OP_S
from lr2rmats_tpu_torch.native import get_lib
from lr2rmats_tpu_torch.utils.log import counter_totals, reset_spans, tracing
from tests.test_torch_chain import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="needs the native library")

CHROM = 150_000
# exons [start, end) of each case, global on the concatenated genome
# (chrA [0, 150000), chrB [150000, 300000), chrC [300000, 450000))
LEAD = (10_000, 10_040)
BODY = 500


def _genome():
    """Three random chromosomes with each case's exons, copies and
    GT..AG motifs planted."""
    rng = np.random.default_rng(2024)
    codes = rng.integers(0, 4, 3 * CHROM).astype(np.uint8)

    def copy(src, dst, n):
        codes[dst: dst + n] = codes[src: src + n]

    # exons at chrB's first base and at its last, each with a copy just
    # over the chromosome edge, on the diagonal the clamp must exclude
    copy(CHROM, CHROM - 40, 40)
    copy(2 * CHROM - 40, 2 * CHROM, 40)
    # a 40-base exon in 21 places (dropped) and one in 16 (kept)
    for j in range(20):
        copy(72_000, 3_000 + 300 * j, 40)
    for j in range(15):
        copy(82_000, 100_000 + 300 * j, 40)
    # the same exon twice in the window: a tie of diagonal counts
    copy(110_000, 111_000, 40)
    for donor_end, acceptor in (
            (10_040, 10_840), (20_500, 21_300), (30_040, 30_840),
            (31_340, 32_140), (50_060, 50_860), (51_360, 52_160),
            (60_040, 60_840), (61_340, 62_140), (72_040, 72_840),
            (82_040, 82_840), (110_040, 112_000), (111_040, 112_000),
            (120_040, 120_840), (CHROM + 40, CHROM + 840),
            (2 * CHROM - 840, 2 * CHROM - 40)):
        codes[donor_end: donor_end + 2] = (2, 3)          # GT
        codes[acceptor - 2: acceptor] = (0, 2)            # AG
    return Genome(["chrA", "chrB", "chrC"], codes,
                  np.array([0, CHROM, 2 * CHROM, 3 * CHROM], np.int64))


@pytest.fixture(scope="module")
def host():
    genome = _genome()
    al = BatchAligner(genome, n_threads=3)
    yield al
    al.close()


def _junk(n, seed):
    return np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)


def _cases(g):
    """name -> (reads, strands, records, rcs, stride or None, the flags
    each record should get or None)."""
    def seg(a, b):
        return g[a:b].copy()

    def rec(pos, *ops):
        return (pos, list(ops), 3, sum(l for o, l in ops if o == OP_M), 1)

    lead_read = np.concatenate([seg(*LEAD), seg(10_840, 10_840 + BODY)])
    lead = rec(10_840, (OP_S, 40), (OP_M, BODY))
    both_read = np.concatenate([seg(30_000, 30_040), seg(30_840, 31_340),
                                seg(32_140, 32_180)])
    both = rec(30_840, (OP_S, 40), (OP_M, BODY), (OP_S, 40))
    noisy_lead = np.concatenate([_junk(30, 1), seg(50_030, 50_060),
                                 seg(50_860, 51_360), seg(52_160, 52_200)])
    noisy_trail = np.concatenate([seg(60_000, 60_040), seg(60_840, 61_340),
                                  seg(62_140, 62_170), _junk(30, 2)])
    first = np.concatenate([seg(CHROM, CHROM + 40),
                            seg(CHROM + 840, CHROM + 840 + BODY)])
    last = np.concatenate([seg(2 * CHROM - 840 - BODY, 2 * CHROM - 840),
                           seg(2 * CHROM - 40, 2 * CHROM)])
    return {
        "small_leading_exon": ([lead_read], [0], [lead], None, None,
                               [1 | 1 << 2]),
        "small_trailing_exon": (
            [np.concatenate([seg(20_000, 20_500), seg(21_300, 21_340)])],
            [0], [rec(20_000, (OP_M, BODY), (OP_S, 40))], None, None,
            [1 | 1 << 2]),
        "both_exons": ([both_read], [0], [both], None, None, [2 | 2 << 2]),
        "junk_clip": ([np.concatenate([_junk(60, 3),
                                       seg(40_000, 40_000 + BODY)])],
                      [0], [rec(40_000, (OP_S, 60), (OP_M, BODY))], None,
                      None, [1]),
        "noisy_lead_then_trail": (
            [noisy_lead], [0],
            [rec(50_860, (OP_S, 60), (OP_M, BODY), (OP_S, 40))], None,
            None, [2 | 1 << 2]),
        "noisy_trail": (
            [noisy_trail], [0],
            [rec(60_840, (OP_S, 40), (OP_M, BODY), (OP_S, 60))], None,
            None, [2 | 1 << 2]),
        "chromosome_edges": (
            [first, last], [0, 0],
            [rec(CHROM + 840, (OP_S, 40), (OP_M, BODY)),
             rec(2 * CHROM - 840 - BODY, (OP_M, BODY), (OP_S, 40))],
            None, None, [1 | 1 << 2, 1 | 1 << 2]),
        "seeds_over_16_places": (
            [np.concatenate([seg(72_000, 72_040), seg(72_840, 73_340)]),
             np.concatenate([seg(82_000, 82_040), seg(82_840, 83_340)])],
            [0, 0],
            [rec(72_840, (OP_S, 40), (OP_M, BODY)),
             rec(82_840, (OP_S, 40), (OP_M, BODY))],
            None, None, [1, 1 | 1 << 2]),
        "tie_of_diagonals": (
            [np.concatenate([seg(110_000, 110_040),
                             seg(112_000, 112_000 + BODY)])],
            [0], [rec(112_000, (OP_S, 40), (OP_M, BODY))], None, None,
            [1 | 1 << 2]),
        "strand_1": (
            [revcomp(np.concatenate([seg(120_000, 120_040),
                                     seg(120_840, 121_340)]))],
            [1], [rec(120_840, (OP_S, 40), (OP_M, BODY))], None, None,
            [1 | 1 << 2]),
        "zero_length_runs": (
            [both_read], [0],
            [rec(30_840, (OP_S, 40), (OP_M, 0), (OP_M, 300), (OP_I, 0),
                 (OP_M, 200), (OP_S, 40))], None, None, [2 | 2 << 2]),
        "refused_candidate": ([lead_read], [0], [lead], [1], None, [0]),
        "ops_outgrow_stride": ([both_read], [0], [both], None, 4,
                               [2 | 2 << 2 | 16]),
    }


def _native(al, reads, strands, recs, rcs=None, stride=None):
    """The native pass on one candidate a read; the records it leaves and
    its flags."""
    n = len(recs)
    read_offs = np.zeros(n + 1, np.int64)
    np.cumsum([len(r) for r in reads], out=read_offs[1:])
    reads_concat = np.ascontiguousarray(np.concatenate(reads), np.uint8)
    stride = stride or max(len(r) for r in reads) + 80
    ops_out = np.full(n * 2 * stride, -7, np.int32)
    for i, (_, ops, *_r) in enumerate(recs):
        flat = np.array(ops, np.int32).reshape(-1)
        ops_out[2 * i * stride: 2 * i * stride + len(flat)] = flat
    ext = (stride, np.array([r[0] for r in recs], np.int64), ops_out,
           np.array([len(r[1]) for r in recs], np.int32),
           np.array([r[2] for r in recs], np.int64),
           np.array([r[3] for r in recs], np.int64),
           np.array([r[4] for r in recs], np.int32),
           np.array(rcs or [0] * n, np.int32))
    flags = al._rescue_terminal(get_lib(), reads_concat, read_offs,
                                np.arange(n, dtype=np.int32),
                                np.array(strands, np.int8), ext)
    _, pos, ops_out, n_ops, ed, nm, vote, _ = ext
    out = []
    for i in range(n):
        o = ops_out[2 * i * stride: 2 * i * stride + 2 * n_ops[i]]
        out.append((int(pos[i]), [tuple(x) for x in o.reshape(-1, 2).tolist()],
                    int(ed[i]), int(nm[i]), int(vote[i])))
    return out, flags.tolist()


def _count_seeded(monkeypatch):
    """Counts the host version's seeded clips (one minimizer extraction
    a `_seed_clip`)."""
    seen = [0]
    real = port_aligner.extract_minimizers

    def counted(*a, **k):
        seen[0] += 1
        return real(*a, **k)
    monkeypatch.setattr(port_aligner, "extract_minimizers", counted)
    return seen


@pytest.mark.parametrize("case", sorted(_cases(np.zeros(3 * CHROM,
                                                         np.uint8))))
def test_native_rescue_equals_host(host, case, monkeypatch):
    reads, strands, recs, rcs, stride, want_flags = _cases(
        host.inner.genome.codes)[case]
    got, flags = _native(host, reads, strands, recs, rcs, stride)
    seen = _count_seeded(monkeypatch)
    for i, (read, s, r) in enumerate(zip(reads, strands, recs)):
        seen[0] = 0
        refused = bool(rcs and rcs[i])
        want = r if refused else host.inner._rescue_terminal_exons(
            revcomp(read) if s else read, (r[0], list(r[1])) + r[2:])
        placed = (flags[i] >> 2) & 3
        if flags[i] & 16:
            # outgrew the stride: nothing written, the host version redoes it
            assert got[i] == (r[0], [tuple(o) for o in r[1]]) + r[2:]
            assert want != r
        else:
            assert got[i] == want, case
            assert (got[i] != r) == bool(placed)
        if not refused:
            assert flags[i] & 3 == seen[0]
    assert flags == want_flags
    if case == "tie_of_diagonals":
        assert got[0][0] == 110_000             # the smaller diagonal wins
    if case == "chromosome_edges":
        assert got[0][0] == CHROM and got[1][0] + sum(
            l for o, l in got[1][1] if o in (0, 2, 3)) == 2 * CHROM


def test_many_candidates_over_eight_threads(host):
    """Every case's records, 24 times over in one batch, split over eight
    threads: each record as the host version leaves it."""
    cases = _cases(host.inner.genome.codes)
    reads, strands, recs = [], [], []
    for name in sorted(cases):
        r, s, c, rcs, stride, _ = cases[name]
        if rcs is None and stride is None:
            reads += r
            strands += s
            recs += c
    reads, strands, recs = reads * 24, strands * 24, recs * 24
    al = BatchAligner(host.inner.genome, index=host.index, n_threads=8)
    got, flags = _native(al, reads, strands, recs)
    al.close()
    want = [host.inner._rescue_terminal_exons(revcomp(r) if s else r,
                                              (c[0], list(c[1])) + c[2:])
            for r, s, c in zip(reads, strands, recs)]
    assert got == want
    assert flags == flags[:len(flags) // 24] * 24


@pytest.mark.parametrize("local_shard", [None, 0, 1, 2])
def test_sharded_index_rescue_equals_host(host, local_shard):
    """On a hash-range-sharded index, in one process (every shard) and as
    one process of three (its own shard alone, as its `lookup` answers),
    the pass equals the host version on the same index."""
    from lr2rmats_tpu_torch.parallel.shard_index import ShardedMinimizerIndex
    genome = host.inner.genome
    index = ShardedMinimizerIndex.build(genome, 3, local_shard=local_shard)
    al = BatchAligner(genome, index=index, n_threads=2)
    cases = _cases(genome.codes)
    reads, strands, recs = [], [], []
    for name in ("small_leading_exon", "both_exons", "tie_of_diagonals",
                 "strand_1", "noisy_lead_then_trail"):
        reads += cases[name][0]
        strands += cases[name][1]
        recs += cases[name][2]
    got, flags = _native(al, reads, strands, recs)
    want = [al.inner._rescue_terminal_exons(revcomp(r) if s else r,
                                            (c[0], list(c[1])) + c[2:])
            for r, s, c in zip(reads, strands, recs)]
    al.close()
    assert got == want
    assert all(f & 3 for f in flags)
    if local_shard is None:                 # every shard: each clip placed
        assert sum((f >> 2) & 3 for f in flags) == 6


def _cell(name):
    """The benchmark cell at a CPU size: small.py's, GRCh38's at 1/500 of
    each chromosome (two whole chromosomes would be 491 Mb)."""
    if name != "grch38_isoseq_genome":
        return small_cell(name)
    from cardbench import run
    spec = run.load_cell(name)
    cfg = spec["config"]
    for c in cfg["chromosomes"]:
        c["length"] = int(c["length"]) // 500
    cfg["profile"]["repeats"] = max(1, cfg["profile"]["repeats"] // 500)
    cfg["reads_per_call"] = 96
    return spec


@pytest.mark.parametrize("cell", ["chr21_ont_deep", "grch38_isoseq_genome"])
def test_build_packed_equals_per_read_path(cell, monkeypatch):
    spec = _cell(cell)
    cfg, seed = spec["config"], 2**31 + 21
    dep = gen.build_deployment(cfg, seed)
    ((_, codes, offs, _), *_) = gen.long_read_calls(
        dep, int(cfg["reads_per_call"]), cfg["profile"], spec["traffic"],
        seed)
    reads = [codes[offs[i]: offs[i + 1]] for i in range(len(offs) - 1)]
    names = [f"r{i}" for i in range(len(reads))]
    al = TorchBatchAligner(
        Genome(dep.names, dep.codes, dep.offsets), device="cpu",
        junction_backend=cfg["aligner"]["junction_backend"],
        seed_lookup=cfg["aligner"]["seed_lookup"])
    rows = al._batch_anchors(reads)
    chained = al._chain_rows(rows)
    reset_spans()
    with tracing():
        rb = al._build_packed(names, reads, rows, chained)
    clips = counter_totals()["lr2rmats.align.rescue_clips"]
    reset_spans()
    seen = _count_seeded(monkeypatch)
    monkeypatch.setattr(port_batch, "get_lib", lambda: None)
    want = al._build_records(names, reads, rows, chained)
    al.close()
    got = rb.to_alnrecs()
    assert len(got) == len(want) > len(reads) // 2
    for a, b in zip(got, want):
        assert (a.qname, a.flag, a.tid, a.pos, a.mapq, a.seq, a.tags) == \
            (b.qname, b.flag, b.tid, b.pos, b.mapq, b.seq, b.tags)
        np.testing.assert_array_equal(a.cigar, b.cigar)
    assert rb.emit_sam(al.refs) == \
        RecordBatch.from_alnrecs(want).emit_sam(al.refs)
    assert clips == seen[0] > 0
