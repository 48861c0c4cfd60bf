"""The generators give the same bytes for a seed, other bytes for another
seed, and the same gene layout for every seed."""

import numpy as np
import pytest

from cardbench import gen, run

from .small import small_cell


def _long(name, seed):
    spec = small_cell(name)
    cfg = spec["config"]
    dep = gen.build_deployment(cfg, seed)
    calls = gen.long_read_calls(dep, cfg["reads_per_call"], cfg["profile"],
                                spec["traffic"], seed)
    return dep, calls


@pytest.mark.parametrize("name", ["chr21_ont_deep", "yeast_ont_align"])
def test_long_reads_repeat_per_seed(name):
    (d1, c1), (d2, c2) = _long(name, 2**31 + 11), _long(name, 2**31 + 11)
    assert d1.codes.tobytes() == d2.codes.tobytes()
    for a, b in zip(c1, c2):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    d3, c3 = _long(name, 5)
    assert d3.codes.tobytes() != d1.codes.tobytes()
    assert c3[0][1].tobytes() != c1[0][1].tobytes()
    # the layout is the configuration's, not the seed's
    assert [g.exons for g in d3.genes] == [g.exons for g in d1.genes]


def test_short_pairs_repeat_per_seed():
    spec = small_cell("chr21_sr_count")
    dep = gen.build_deployment(spec["config"], 77)
    a = gen.short_pair_batches(dep, spec["traffic"], 77)
    b = gen.short_pair_batches(dep, spec["traffic"], 77)
    c = gen.short_pair_batches(dep, spec["traffic"], 78)
    for (x1, x2), (y1, y2) in zip(a, b):
        assert x1.tobytes() == y1.tobytes() and x2.tobytes() == y2.tobytes()
    assert a[0][0].tobytes() != c[0][0].tobytes()
    r1, r2 = a[0]
    assert r1.shape == (1500, 100) and r1.dtype == np.uint8
    assert r1.max() < 4 and r2.max() < 4


def test_reads_are_their_transcripts_with_errors():
    spec = small_cell("chr21_ont_deep")
    cfg = spec["config"]
    cfg["profile"] = {**cfg["profile"], "sub": 0.0, "del": 0.0, "ins": 0.0}
    dep = gen.build_deployment(cfg, 3)
    gene_ids, codes, offs, rc = gen.long_read_calls(
        dep, 24, cfg["profile"], spec["traffic"], 3)[0]
    for i in range(len(gene_ids)):
        tx = dep.transcript(dep.genes[int(gene_ids[i])])
        r = codes[offs[i]: offs[i + 1]]
        assert np.array_equal(gen.COMP[r[::-1]] if rc[i] else r, tx)
    # deep traffic: 6 genes a call, each 24 / 6 times
    assert sorted(np.bincount(gene_ids)[gene_ids].tolist()) == [4] * 24


def test_layouts_of_the_configurations():
    spec = small_cell("yeast_ont_align")
    full = [c["length"] for c in
            run.load_cell("yeast_ont_align")["config"]["chromosomes"]]
    assert sum(full) == 12_071_326 and len(full) == 16
    genes, motifs = gen.plan_genes(full, spec["config"]["gene_model"],
                                   spec["config"]["layout_seed"])
    single = np.mean([len(g.exons) == 1 for g in genes])
    assert 0.9 < single < 0.99
    assert 5000 < len(genes) < 7000             # about one gene per 2 kb
    assert len(motifs) == sum(len(g.exons) - 1 for g in genes)
    chr21 = run.load_cell("chr21_ont_deep")
    genes, _ = gen.plan_genes([46_709_983], chr21["config"]["gene_model"],
                              chr21["config"]["layout_seed"])
    assert 1200 < len(genes) < 1600            # about 1400 genes fit
    assert all(2 <= len(g.exons) <= 6 for g in genes)


def test_motifs_are_written():
    spec = small_cell("chr21_ont_deep")
    dep = gen.build_deployment(spec["config"], 9)
    codes = dep.codes
    for c, d, a in dep.introns()[:50]:
        o = int(dep.offsets[c])
        don = tuple(codes[o + d - 1: o + d + 1])
        acc = tuple(codes[o + a - 2: o + a])
        assert (don, acc) in gen.MOTIFS
