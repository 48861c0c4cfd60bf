"""Seeding on a saturated multi-chromosome index, the regime of a whole
human genome (GRCh38 at k = 15: every query hash hits about 2.9 places),
at a CPU size: 24 chromosomes of 150-300 kb at k = 11.

  * the port's index and its device seed lookup (TorchSeedLookup, plain
    torch on the CPU) against the plain reference cardbench/ref_seed.py;
  * the port with seed_lookup=True against its host backend and the JAX
    package's aligner: the same SAM bytes;
  * the span `lr2rmats.align.seed_lookup` and the counters
    `lr2rmats.align.{lookup_queries,hits,rows,anchors,anchors_host}`:
    recorded only under tracing, and each equal to what it counts;
  * the seed key packing (`gp << 19`) at global positions past 2^31, on
    a stubbed position array instead of a 3 Gbp genome.
"""

import numpy as np
import pytest

from cardbench import gen, ref_seed
from lr2rmats_tpu.align.aligner import AlignParams as JaxParams
from lr2rmats_tpu.align.batch import BatchAligner as JaxBatchAligner
from lr2rmats_tpu.io.fasta import Genome as JaxGenome
from lr2rmats_tpu_torch.align import batch as port_batch
from lr2rmats_tpu_torch.align.aligner import AlignParams
from lr2rmats_tpu_torch.align.batch import BatchAligner, TorchBatchAligner
from lr2rmats_tpu_torch.index.minimizer import MinimizerIndex
from lr2rmats_tpu_torch.index.seed_device import TorchSeedLookup
from lr2rmats_tpu_torch.io.fasta import Genome, SeqSet
from lr2rmats_tpu_torch.utils.log import (counter_totals, reset_spans,
                                          span_records, tracing)
from tests.test_torch_chain import one_torch_thread  # noqa: F401 (autouse)

K, W = 11, 5
READS = 160
BATCH = 64                         # three batches
# GRCh38's whole length: a stubbed index ends here
GRCH38_BP = 3_088_269_832
COUNTERS = ("lookup_queries", "hits", "rows", "anchors", "anchors_host")


def _config(seed):
    lengths = np.random.default_rng(seed).integers(150_000, 300_001, 24)
    return {
        "chromosomes": [{"name": f"chr{i + 1}", "length": int(n)}
                        for i, n in enumerate(lengths)],
        "layout_seed": seed,
        "gene_model": {"start": 1000, "gap": [5000, 20000], "exons": [2, 7],
                       "single_exon_share": 0.0, "exon_len": [150, 600],
                       "intron_len": [200, 5000], "end_pad": 6000,
                       "minor_motif_share": 0.04},
        "profile": {"name": "isoseq", "sub": 0.005, "del": 0.0025,
                    "ins": 0.0025, "repeats": 24, "repeat_len": [1000, 4000]}}


@pytest.fixture(scope="module")
def deployment():
    cfg = _config(38)
    dep = gen.build_deployment(cfg, 2**31 + 38)
    ((gene_ids, codes, offs, _),) = gen.long_read_calls(
        dep, READS, cfg["profile"], {"pool_calls": 1}, 2**31 + 38)
    reads = SeqSet([f"r{i}" for i in range(READS)], codes, offs)
    genome = Genome(dep.names, dep.codes, dep.offsets)
    index = MinimizerIndex.build(genome, K, W)
    return dep, genome, index, reads


def _chroms(dep):
    return [dep.codes[dep.offsets[i]: dep.offsets[i + 1]]
            for i in range(len(dep.names))]


def _read_hashes(reads):
    return np.concatenate([ref_seed.minimizers(reads.get(i), K, W)[0]
                           for i in range(reads.n)])


def _aligner(deployment, seed_lookup):
    _, genome, index, _ = deployment
    return TorchBatchAligner(genome, AlignParams(k=K, w=W), index=index,
                             device="cpu", junction_backend="host",
                             seed_lookup=seed_lookup)


def test_index_equals_reference_and_is_saturated(deployment):
    dep, _, index, reads = deployment
    h, p, s = ref_seed.build_table(_chroms(dep), K, W)
    np.testing.assert_array_equal(index.hashes, h)
    np.testing.assert_array_equal(index.pos, p)
    np.testing.assert_array_equal(index.strand, s)
    lo, hi = ref_seed.lookup(h, _read_hashes(reads))
    # each query hash hits at least 1.5 places, as on GRCh38
    assert (hi - lo).mean() >= 1.5


@pytest.mark.parametrize("nq", [0, 1, 4097, None])
def test_device_lookup_equals_reference(deployment, nq):
    """Read minimizers (all of them: None), absent hashes and the padding
    edges; (lo, hi) exact."""
    _, _, index, reads = deployment
    q = _read_hashes(reads)
    if nq is not None:
        rng = np.random.default_rng(nq)
        absent = rng.integers(0, 1 << (2 * K), nq // 2).astype(np.uint64)
        q = np.concatenate([rng.choice(q, nq - len(absent)), absent])
    look = TorchSeedLookup(index, "cpu")
    lo, hi = look.lookup(q)
    want = ref_seed.lookup(index.hashes, q)
    np.testing.assert_array_equal(lo, want[0])
    np.testing.assert_array_equal(hi, want[1])
    assert look.calls == (1 if len(q) else 0)


def test_sam_equals_host_backend_and_jax(deployment):
    dep, genome, index, reads = deployment
    port = _aligner(deployment, True)
    assert port._seed_lookup is not None
    got = port.align_seqset_packed(reads, BATCH).emit_sam(port.refs)
    assert port.stats["seed_lookup_calls"] == 3
    host = BatchAligner(genome, AlignParams(k=K, w=W), index=index)
    want_host = host.align_seqset_packed(reads, BATCH).emit_sam(host.refs)
    jax_al = JaxBatchAligner(JaxGenome(dep.names, dep.codes, dep.offsets),
                             JaxParams(k=K, w=W), backend="jax",
                             junction_backend="host")
    want_jax = jax_al.align_seqset_packed(reads, BATCH).emit_sam(
        jax_al.refs)
    assert got.count(b"\n") > READS
    assert got == want_host == want_jax
    port.close()
    host.close()


def test_spans_and_counters(deployment, monkeypatch):
    """Off: nothing recorded.  On: one seed_lookup span a lookup and one
    seed_select span a selection, under the seed span on the seed worker;
    hits the sum of the lookups' hi - lo, all of them selected on the
    device (hits_card); anchors equal to stats["anchors"]; the SAM
    unchanged."""
    _, _, _, reads = deployment
    port = _aligner(deployment, True)
    seen = []
    orig = port._seed_lookup._ranges

    def ranges(q):
        lo, hi = orig(q)
        seen.append((len(q), int((hi - lo).sum())))
        return lo, hi

    monkeypatch.setattr(port._seed_lookup, "_ranges", ranges)
    monkeypatch.setenv("LR2RMATS_SEED_WORKERS", "1")
    reset_spans()
    try:
        off = port.align_seqset_packed(reads, BATCH).emit_sam(port.refs)
        assert span_records() == [] and counter_totals() == {}
        seen.clear()
        port.stats = port.fresh_stats()
        with tracing():
            on = port.align_seqset_packed(reads, BATCH).emit_sam(port.refs)
        assert on == off
        ctr = {k: counter_totals()["lr2rmats.align." + k]
               for k in COUNTERS + ("hits_card", "seed_host_reads")}
        recs = {r["id"]: r for r in span_records()}
        looks = [r for r in recs.values()
                 if r["name"] == "lr2rmats.align.seed_lookup"]
        selects = [r for r in recs.values()
                   if r["name"] == "lr2rmats.align.seed_select"]
    finally:
        reset_spans()
        port.close()
    assert len(looks) == len(selects) == len(seen) == 3
    for r in looks + selects:
        assert recs[r["parent"]]["name"] == "lr2rmats.align.seed"
        assert r["call"] == recs[r["parent"]]["call"]
    assert ctr["hits_card"] == ctr["hits"] and ctr["seed_host_reads"] == 0
    assert ctr["lookup_queries"] == sum(n for n, _ in seen)
    assert ctr["hits"] == sum(h for _, h in seen) > ctr["lookup_queries"]
    assert ctr["anchors"] == port.stats["anchors"] > 0
    assert 0 < ctr["rows"] <= ctr["anchors"]
    assert 0 <= ctr["anchors_host"] <= ctr["anchors"]


def test_counts_host_routed_anchors(deployment):
    """anchors_host counts the anchors of the rows _prepare_dispatch sends
    to the host chain, and nothing else."""
    _, _, _, reads = deployment
    port = _aligner(deployment, False)
    rows = port._batch_anchors([reads.get(i) for i in range(BATCH)])
    # one row made long enough for the host chain
    big = rows[0]
    n = port_batch.A_BUCKETS[-1] + 1
    rows[0] = port_batch._Row(big.read_i, big.strand,
                              np.arange(n, dtype=np.int64) * 8,
                              big.base + np.arange(n, dtype=np.int64) * 8,
                              big.base, 0, 8 * (n - 1))
    reset_spans()
    try:
        with tracing():
            prep = port._prepare_dispatch(rows)
        ctr = counter_totals()
    finally:
        reset_spans()
        port.close()
    want = sum(len(rows[i].qpos) for i in prep["host_rows"])
    assert 0 in prep["host_rows"]
    assert ctr["lr2rmats.align.anchors_host"] == want >= n
    assert ctr["lr2rmats.align.rows"] == len(rows)
    assert ctr["lr2rmats.align.anchors"] == sum(len(r.qpos) for r in rows)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("seed_lookup", [False, True])
def test_key_packing_past_2_31(deployment, monkeypatch, native,
                               seed_lookup):
    """The same index with every position moved up by S, so that the
    genome ends at GRCh38's 3,088,269,832 bp and the seeds lie past 2^31
    (an empty first chromosome of S bases in front): the rows are the
    unmoved index's, moved by S, through the radix key path."""
    _, genome, index, reads = deployment
    if native and port_batch.get_lib() is None:
        pytest.skip("the native library is unavailable")
    if not native:
        monkeypatch.setattr(port_batch, "get_lib", lambda: None)
    shift = GRCH38_BP - int(index.chrom_offsets[-1])
    assert shift > 2**31
    moved = MinimizerIndex(
        K, W, index.hashes, index.pos + shift, index.strand,
        np.concatenate([[0], index.chrom_offsets + shift]),
        ["pad"] + list(index.names), index.max_occ)
    assert int(moved.chrom_offsets[-1]) == GRCH38_BP < 2**32
    codes = [reads.get(i) for i in range(BATCH)]
    base = TorchBatchAligner(genome, AlignParams(k=K, w=W), index=index,
                             device="cpu", seed_lookup=seed_lookup)
    high = TorchBatchAligner(genome, AlignParams(k=K, w=W), index=moved,
                             device="cpu", seed_lookup=seed_lookup)
    want, got = base._batch_anchors(codes), high._batch_anchors(codes)
    base.close()
    high.close()
    assert len(got) == len(want) > BATCH
    assert max(int(r.gpos.max()) for r in got) > 2**31
    for a, b in zip(want, got):
        assert (a.read_i, a.strand, a.n_big, a.q_max) == \
            (b.read_i, b.strand, b.n_big, b.q_max)
        assert b.base == a.base + shift
        np.testing.assert_array_equal(a.qpos, b.qpos)
        np.testing.assert_array_equal(a.gpos + shift, b.gpos)
