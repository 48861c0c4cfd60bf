"""Port aligner (lr2rmats_tpu_torch/align/batch.py) against the JAX
reference: TorchBatchAligner on the CPU (the kernels' plain versions) must
emit the same SAM bytes as BatchAligner(backend="jax") on the
tests/test_batch_aligner.py genes and on a small bench.py workload; the
slice must run with jax blocked; device="cuda" must raise without a card;
the device switches select the port's device paths, which raise instead
of falling back.
"""

import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import bench
from lr2rmats_tpu.align.batch import BatchAligner
from lr2rmats_tpu.io.fasta import Genome
from lr2rmats_tpu_torch import resolve_device
from lr2rmats_tpu_torch.align.aligner import AlignParams
from lr2rmats_tpu_torch.align.batch import TorchBatchAligner
from lr2rmats_tpu_torch.align.chain import ChainParams
from lr2rmats_tpu_torch.index.minimizer import MinimizerIndex
from lr2rmats_tpu_torch.io.fasta import Genome as PortGenome
from tests.test_aligner import plant_motifs, random_genome, splice_read
from tests.test_torch_chain import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def sim_seqset():
    g = random_genome(200_000, seed=21)
    exon_sets = [
        [(10_000, 10_400), (14_000, 14_300), (21_000, 21_500)],
        [(50_000, 50_250), (58_000, 58_200)],
        [(90_000, 90_800)],
        [(120_000, 120_300), (125_000, 125_200), (131_000, 131_250),
         (140_000, 140_400)],
    ]
    for es in exon_sets:
        plant_motifs(g, es)
    reads, names = [], []
    for i, es in enumerate(exon_sets):
        for strand in "+-":
            for err, seed in ((0.0, 1), (0.02, 2)):
                reads.append(splice_read(g, es, strand, err=err,
                                         seed=seed + i))
                names.append(f"r{i}{strand}{seed}")
    return g, bench._pack(reads, names)


@pytest.fixture(scope="module")
def bench_small():
    rng = np.random.default_rng(123)
    g = bench.build_genome(2_000_000, rng)
    reads, truths = bench.simulate_reads(g, 512, rng, profile="ont")
    names = [f"read{i}" for i in range(len(reads))]
    return g, bench._pack(reads, names), names, truths


def _primary(rb):
    return {r.qname: r for r in rb.to_alnrecs() if not (r.flag & 0x100)}


def test_sam_matches_jax_sim(sim_seqset):
    g, seqset = sim_seqset
    ref = BatchAligner(g, backend="jax")
    port = TorchBatchAligner.from_jax_aligner(ref, device="cpu")
    want = ref.align_seqset_packed(seqset).emit_sam(ref.refs)
    got = port.align_seqset_packed(seqset).emit_sam(port.refs)
    assert got and got == want


def test_sam_matches_jax_bench_small(bench_small):
    g, seqset, names, truths = bench_small
    ref = BatchAligner(g, backend="jax")
    port = TorchBatchAligner.from_jax_aligner(ref, device="cpu")
    rb_ref = ref.align_seqset_packed(seqset)
    rb_port = port.align_seqset_packed(seqset)
    assert rb_port.emit_sam(port.refs) == rb_ref.emit_sam(ref.refs)
    acc_ref = bench.accuracy_vs_truth(truths, names, _primary(rb_ref))
    acc_port = bench.accuracy_vs_truth(truths, names, _primary(rb_port))
    assert acc_port == acc_ref and acc_port[0] > 0.9 * len(names)
    st = port.stats
    assert st["device_calls"] > 0 and st["anchors"] > 0
    # the CPU runs the plain versions: no kernel was launched
    assert st["chain_kernel_launches"] == 0
    assert st["shift_dp_kernel_launches"] == 0


def test_align_batch_matches_jax_bench_small(bench_small, monkeypatch):
    """The list API in one process (`align_batch`) with the native
    library: its records, built by the packed builder the cells measure,
    equal the reference's align_batch record for record."""
    from tests.test_torch_host import reference_native_library
    reference_native_library(monkeypatch)       # both take the native path
    g, seqset, names, _ = bench_small
    ref = BatchAligner(g, backend="jax")
    port = TorchBatchAligner.from_jax_aligner(ref, device="cpu")
    reads = [seqset.get(i) for i in range(seqset.n)]
    want = ref.align_batch(names, reads)
    got = port.align_batch(names, reads)
    assert len(got) == len(want) > len(names) // 2
    for a, b in zip(got, want):
        assert (a.qname, a.flag, a.tid, a.pos, a.mapq, a.seq, a.qual,
                a.tags) == (b.qname, b.flag, b.tid, b.pos, b.mapq, b.seq,
                            b.qual, b.tags)
        np.testing.assert_array_equal(a.cigar, b.cigar)


def test_chain_routing_matches_reference(bench_small, monkeypatch):
    """The port routes every row as the reference does: same small-row
    set, same host rows, same bucket members (in fixed-size chunks).

    Routing depends on whether the native library loaded, so both sides
    load it first: the reference's loader races under parallel test
    workers (ROADMAP §3) and can leave one worker without the library."""
    from tests.test_torch_host import reference_native_library
    reference_native_library(monkeypatch)
    g, seqset, _, _ = bench_small
    ref = BatchAligner(g, backend="jax")
    port = TorchBatchAligner.from_jax_aligner(ref, device="cpu")
    reads = [seqset.get(i) for i in range(seqset.n)]
    rows = port._batch_anchors(reads)
    prep = port._prepare_dispatch(rows)
    jprep = ref._prepare_dispatch(rows)
    assert prep["host_rows"] == jprep["host_rows"]
    assert [e[1] for e in prep["pre"]] == [e[1] for e in jprep["pre"]]
    jparts = [p for p, _ in jprep["multi_parts"]] + [s[0] for s in
                                                     jprep["spills"]]
    assert sorted(sum((c[0] for c in prep["chunks"]), [])) == \
        sorted(sum(jparts, []))
    for part, A, qp, gp, nn in prep["chunks"]:
        assert qp.shape == (port._chunk(A), A) and qp.dtype == np.int32


def test_slice_runs_with_jax_blocked(tmp_path):
    """The whole slice, polish included, imports neither jax nor the
    reference package."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["lr2rmats_tpu"] = None
        import numpy as np
        from lr2rmats_tpu_torch import synth
        from lr2rmats_tpu_torch.align.batch import TorchBatchAligner
        rng = np.random.default_rng(7)
        g = synth.build_genome(400_000, rng)
        reads, _ = synth.simulate_reads(g, 64, rng, profile="ont")
        ss = synth.pack_seqset(reads, [f"r{i}" for i in range(len(reads))])
        al = TorchBatchAligner(g, device="cpu")
        sam = al.align_seqset_packed(ss).emit_sam(al.refs)
        assert sam.count(b"\\n") >= 60, sam[:200]
        assert not [m for m in sys.modules
                    if (m.startswith("jax") or m.split(".")[0] ==
                        "lr2rmats_tpu") and sys.modules[m] is not None]
        print("OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")


def test_cuda_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    g = Genome(["c"], np.zeros(1000, np.uint8), np.array([0, 1000]))
    with pytest.raises(RuntimeError):
        TorchBatchAligner(g)                    # default device is cuda
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("var,value", [
    ("LR2RMATS_DEVICE_JUNCTIONS", "1"),
    ("LR2RMATS_DEVICE_JUNCTIONS", "pallas"),
    ("LR2RMATS_DEVICE_SEED", "1"),
])
def test_refuses_unported_device_switches(monkeypatch, sim_seqset, var,
                                          value):
    """The device switches the port once refused now select its device
    paths: the junction DP or the seed lookup runs (its stats count up)
    and the SAM equals the host paths'."""
    g, seqset = sim_seqset
    for v in ("LR2RMATS_DEVICE_JUNCTIONS", "LR2RMATS_DEVICE_SEED"):
        monkeypatch.delenv(v, raising=False)
    host = TorchBatchAligner(g, device="cpu")
    assert host.junction_backend == "host" and host._seed_lookup is None
    want = host.align_seqset_packed(seqset).emit_sam(host.refs)
    monkeypatch.setenv(var, value)
    port = TorchBatchAligner(g, index=host.index, device="cpu")
    got = port.align_seqset_packed(seqset).emit_sam(port.refs)
    st = port.stats
    if var == "LR2RMATS_DEVICE_JUNCTIONS":
        assert port.junction_backend == "device"
        assert st["junction_calls"] > 0 and st["junction_gaps"] > 0
        assert host.stats["junction_calls"] == 0
    else:
        assert port._seed_lookup is not None
        assert st["seed_lookup_calls"] == port._seed_lookup.calls > 0
    assert got == want


def test_failing_seed_lookup_raises(monkeypatch, sim_seqset):
    """A failing device seed lookup raises; the reference would log it and
    ride its host paths for the rest of the run."""
    g, seqset = sim_seqset
    monkeypatch.setenv("LR2RMATS_DEVICE_SEED", "1")
    port = TorchBatchAligner(g, device="cpu", junction_backend="device")

    def boom(h):
        raise RuntimeError("seed lookup failed on the card")

    # both the lookup and the selection on the card search through it
    monkeypatch.setattr(port._seed_lookup, "_ranges", boom)
    with pytest.raises(RuntimeError, match="failed on the card"):
        port.align_seqset_packed(seqset)
    assert port._seed_lookup is not None
    assert port.junction_backend == "device"
    assert not hasattr(port, "_device_fallback")   # no fallback path


def test_from_jax_aligner_shares_state(sim_seqset):
    g, _ = sim_seqset
    ref = BatchAligner(g, backend="host")
    port = TorchBatchAligner.from_jax_aligner(ref, device="cpu")
    # the port's own objects, made from the reference's fields and sharing
    # its numpy arrays
    assert type(port.index) is MinimizerIndex and port.index is not ref.index
    for f in ("hashes", "pos", "strand", "chrom_offsets"):
        assert getattr(port.index, f) is getattr(ref.index, f)
    assert port.index.names == ref.index.names
    assert type(port.p) is AlignParams and type(port.p.chain) is ChainParams
    assert vars(port.p.chain) == vars(ref.p.chain)
    assert {k: v for k, v in vars(port.p).items() if k != "chain"} == \
        {k: v for k, v in vars(ref.p).items() if k != "chain"}
    assert type(port.inner.genome) is PortGenome
    assert port.inner.genome.codes is ref.inner.genome.codes
    assert port.device == torch.device("cpu")
    assert port.junction_backend == "host" and port._seed_lookup is None
    ref_dev = BatchAligner(g, backend="host", junction_backend="device",
                           index=ref.index)
    ref_dev._seed_lookup = object()          # the reference's choice only
    port = TorchBatchAligner.from_jax_aligner(ref_dev, device="cpu")
    assert port.junction_backend == "device"
    assert port._seed_lookup is not None and port._seed_lookup is not \
        ref_dev._seed_lookup
