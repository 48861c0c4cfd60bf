"""The plain references against the program's plain path (the CPU) on
small inputs, and against brute force."""

import numpy as np
import pytest
import torch

from cardbench import gen, ref_align
from cardbench.entries import sr_count

from .small import small_cell


def _sw_brute(a, b):
    """Local alignment, +2 / -4 / -4 linear, by the textbook loop."""
    H = np.zeros((len(a) + 1, len(b) + 1), np.int64)
    for i in range(1, len(a) + 1):
        for j in range(1, len(b) + 1):
            s = ref_align.MATCH if a[i - 1] == b[j - 1] else \
                ref_align.MISMATCH
            H[i, j] = max(0, H[i - 1, j - 1] + s, H[i - 1, j] +
                          ref_align.GAP, H[i, j - 1] + ref_align.GAP)
    return int(H.max())


def test_sw_best_against_brute_force():
    rng = np.random.default_rng(4)
    reads, txs = [], []
    for _ in range(12):
        t = rng.integers(0, 4, int(rng.integers(30, 70))).astype(np.uint8)
        r = t[int(rng.integers(0, 10)):].copy()
        m = rng.random(len(r)) < 0.1
        r[m] = (r[m] + 1) % 4
        r = np.delete(r, rng.integers(0, len(r), 2))
        reads.append(r)
        txs.append(t)
    want = [_sw_brute(r, t) for r, t in zip(reads, txs)]
    assert ref_align.sw_best(reads, txs, "cpu", block=5).tolist() == want
    # the traceback in int32 finds an alignment of that score; in
    # bfloat16 the same reads score no better
    tb = ref_align.sw_align(reads, txs, "cpu", torch.int32, block=5)
    assert [_path_score(r, t, a) for r, t, a in zip(reads, txs, tb)] == want
    bf = ref_align.sw_align(reads, txs, "cpu", torch.bfloat16, block=5)
    assert all(_path_score(r, t, a) <= w
               for r, t, a, w in zip(reads, txs, bf, want))


def _path_score(r, t, aln):
    """The exact score of one of sw_align's alignments, walked over the
    read and the transcript."""
    r0, r1, t0, t1, runs = aln
    i, j, s = r0, t0, 0
    for op, n in runs:
        for _ in range(n):
            if op == b"M":
                s += ref_align.MATCH if r[i] == t[j] else ref_align.MISMATCH
                i, j = i + 1, j + 1
            else:
                s += ref_align.GAP
                i, j = (i + 1, j) if op == b"I" else (i, j + 1)
    assert (i, j) == (r1, t1)
    return s


def _one_gene():
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, 1000).astype(np.uint8)
    g = gen.Gene(0, [(50, 110), (200, 260), (300, 330)])
    dep = gen.Deployment(["c"], codes, np.array([0, 1000]), [g],
                         np.zeros((0, 3), np.int64))
    return dep, g


def _rec(name, cigar, pos, read, flag=0, chrom=b"c"):
    seq = gen.COMP[read[::-1]] if flag & 16 else read
    return b"\t".join([name, str(flag).encode(), chrom, str(pos).encode(),
                       b"60", cigar, b"*", b"0", b"0",
                       bytes(b"ACGT"[x] for x in seq), b"*"])


def test_judge_holds_records_to_the_planted_truth():
    """A record on its gene with both introns exact; one with an intron a
    base off; one on the gene's chromosome away from it; none; a
    record that covers under half of its read."""
    dep, g = _one_gene()
    tx = dep.transcript(g)
    reads = [tx.copy() for _ in range(5)]
    names = [b"a", b"b", b"c", b"d", b"e"]
    sam = b"\n".join([
        _rec(b"a", b"60M90N60M40N30M", 51, tx),
        _rec(b"b", b"61M90N59M40N30M", 51, tx),
        _rec(b"c", b"150M", 501, tx),
        _rec(b"e", b"60M90N10M80S", 51, tx)]) + b"\n"
    calls = [ref_align.Judged(sam, names, reads, np.zeros(5, bool),
                              [g] * 5)]
    res = ref_align.judge(calls, dep, [(0, 0), (0, 1), (0, 3)], "cpu")
    assert res["bad_records"] == 0
    assert res["misplaced_pct"] == 100.0 * 3 / 5          # c, d, e
    # a: none missed; b: the first; c, d: both; e: the second
    assert res["introns_missed_pct"] == 100.0 * 6 / 10
    # a scores its best, b nearly, d nothing
    assert 30.0 < res["score_deficit_pct"] < 40.0


def test_same_splice():
    g = np.array([0, 1, 2, 3, 0, 1, 2, 2, 3, 0, 1, 1], np.uint8)
    # intron [2, 6): moving it by 1 to [3, 7) moves over g[2] and g[6],
    # both 2; by 2 over g[2:4] and g[6:8], (2, 3) against (2, 2)
    assert ref_align.same_splice(g, (2, 6), (3, 7))
    assert not ref_align.same_splice(g, (2, 6), (4, 8))
    assert not ref_align.same_splice(g, (2, 6), (3, 8))     # length
    # to the left by 1: g[1] against g[5], both 1
    assert ref_align.same_splice(g, (2, 6), (1, 5))
    assert not ref_align.same_splice(g, (2, 6), (2, 6))


def test_control_sam_puts_introns_on_the_genome():
    """sw_align's alignment of a transcript's read in int32, written on
    the genome, reports the gene's introns exactly, on either strand."""
    dep, g = _one_gene()
    tx = dep.transcript(g)
    read = np.delete(tx, [5, 70])                 # two deletions
    for flip in (False, True):
        r = gen.COMP[read[::-1]] if flip else read
        aln = ref_align.sw_align([read], [tx], "cpu", torch.int32)
        sam = ref_align.control_sam([b"x"], [r], np.array([flip]), [g], dep,
                                    aln)
        res = ref_align.judge([ref_align.Judged(sam, [b"x"], [r],
                                                np.array([flip]), [g])],
                              dep, [(0, 0)], "cpu")
        assert res["bad_records"] == 0 and res["misplaced_pct"] == 0.0
        assert res["introns_missed_pct"] == 0.0
        assert res["score_deficit_pct"] == 0.0


def _served_score(rec, read, chrom):
    w = ref_align.walk(rec, read, chrom, score=True)
    return w.ok, w.score


def test_served_score():
    g = np.array([0, 1, 2, 3] * 10, np.uint8)
    chrom = {b"c": g}
    read = np.concatenate([g[2:10], g[20:28]]).copy()
    read[3] = (read[3] + 1) % 4
    seq = "".join("ACGT"[x] for x in read).encode()
    ok, s = _served_score([0, b"c", 3, b"8M10N8M", seq], read,
                                   chrom)
    assert ok and s == 2 * 15 - 4 * 1
    ok, s = _served_score([0, b"c", 3, b"2S6M1D10N8M", seq], read,
                                   chrom)
    assert ok
    # a CIGAR that does not walk the read, or a SEQ that is not the read
    assert not _served_score([0, b"c", 3, b"8M10N7M", seq], read,
                                      chrom)[0]
    assert not _served_score([0, b"c", 3, b"8M10N8M",
                                       seq[::-1]], read, chrom)[0]
    assert not _served_score([0, b"x", 3, b"8M10N8M", seq], read,
                                      chrom)[0]
    assert not _served_score([0, b"c", 30, b"8M10N8M", seq], read,
                                      chrom)[0]
    rc = gen.COMP[read[::-1]]
    ok, s = _served_score([16, b"c", 3, b"8M10N8M", seq], rc,
                                   chrom)
    assert ok and s == 26


def test_parse_primaries():
    sam = (b"a\t0\tc\t3\t60\t4M\t*\t0\t0\tACGT\t*\tNM:i:0\n"
           b"a\t256\tc\t9\t0\t4M\t*\t0\t0\tACGT\t*\tNM:i:0\n"
           b"b\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\t*\n"
           b"c\t16\tc\t1\t60\t4M\t*\t0\t0\tACGT\t*\n"
           b"c\t0\tc\t5\t60\t4M\t*\t0\t0\tACGT\t*\n")
    prim, doubled = ref_align.parse_primaries(sam)
    assert sorted(prim) == [b"a", b"c"] and doubled == 1
    assert prim[b"a"][:4] == [0, b"c", 3, b"4M"]


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_sjcount_reference_equals_the_program(seed):
    """The reference's counts equal the program's device counter (its
    plain versions on the CPU) over two batches, one counted twice."""
    spec = small_cell("chr21_sr_count")
    e = sr_count.Entry(spec["config"], spec["traffic"], seed, "cpu")
    e.setup()                       # counts the last batch once
    e.call(0)
    e.call(1)
    e.finish()
    assert e.times.tolist() == [1, 2]
    want = e.expected()
    for got, exp in zip(e.served, want):
        assert np.array_equal(got, exp)
    assert want[0].sum() > 100 and want[1].sum() > 0
    # the control: without the proper-pair guarantee the counts differ
    bad = e.expected(proper_pairs=False)
    assert any((a != b).any() for a, b in zip(bad, want))
