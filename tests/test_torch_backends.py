"""TorchBatchAligner's one chain dispatch and its row split over devices,
against the JAX reference, on the CPU (the kernels' plain versions).

The workload is tests/test_batch_aligner.py's test_pallas_backend_matches
plus one 165 kb unspliced read whose anchor row is wider than the fused
kernel's 512 anchors: it chains on the host, the other rows in the bucket
chunks.  Primaries' cigar and position and the SAM bytes must equal
BatchAligner(backend="jax") exactly, and every reference chain backend,
"pallas" included, maps to the port's one dispatch.  devices=[cpu, cpu]
splits every chain launch into two row blocks and must give the SAM of
devices=[cpu], and, through run_pipeline, the reference host pipeline's
files.
"""

import numpy as np
import pytest
import torch

import bench
from lr2rmats_tpu.align.batch import BatchAligner
from lr2rmats_tpu.pipeline.stages import run_pipeline as ref_pipeline
from lr2rmats_tpu_torch.align.batch import TorchBatchAligner
from lr2rmats_tpu_torch.ops.chain import K_MAX_A
from lr2rmats_tpu_torch.pipeline.stages import run_pipeline
from tests.test_aligner import plant_motifs, random_genome, splice_read
from tests.test_torch_batch import bench_small  # noqa: F401 (fixture)
from tests.test_torch_chain import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_kernels import (pipeline_config, pipeline_outputs,
                                      sim_dataset)

WIDE_EXON = (20_000, 185_000)


@pytest.fixture(scope="module")
def workload():
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
    reads = [splice_read(g, es, "+", err=0.01, seed=5) for es in exon_sets]
    names = [f"p{i}" for i in range(len(reads))]
    reads.append(splice_read(g, [WIDE_EXON], "+", err=0.01, seed=9))
    names.append("wide")
    ref = BatchAligner(g, backend="jax")
    return g, ref, reads, names


def _primaries(recs):
    return {r.qname: r for r in recs if not (r.flag & 0x100)}


def test_default_routing_covers_every_width(workload):
    """The one chain dispatch routes every row once: the wide read's rows,
    the widest over the fused kernel's cap, to the host chain; the others
    to the native small-row chain or the bucket chunks."""
    g, ref, reads, _ = workload
    port = TorchBatchAligner(g, index=ref.index, device="cpu")
    rows = port._batch_anchors(reads)
    widths = [len(r.qpos) for r in rows]
    assert max(widths) > K_MAX_A
    prep = port._prepare_dispatch(rows)
    host, wide = prep["host_rows"], len(reads) - 1
    assert {rows[i].read_i for i in host} == {wide}
    assert widths.index(max(widths)) in host
    chunked = sorted(sum((c[0] for c in prep["chunks"]), []))
    assert sorted(chunked + sum((e[1] for e in prep["pre"]), []) +
                  host) == list(range(len(rows)))
    assert chunked
    for part, A, qp, gp, nn in prep["chunks"]:
        assert qp.shape == gp.shape == (port._chunk(A), A)
        assert nn[:len(part)].tolist() == [widths[i] for i in part]


def test_align_batch_matches_jax_on_a_wide_read(workload):
    """align_batch's primaries equal the reference's; the reads twice
    over, so that the batch has more than 8 reads and the records come
    from the native builder."""
    g, ref, reads, names = workload
    port = TorchBatchAligner(g, index=ref.index, device="cpu")
    names = names + [f"{n}.2" for n in names]
    reads = reads + reads
    want = _primaries(ref.align_batch(names, reads))
    got = _primaries(port.align_batch(names, reads))
    assert set(got) == set(want) and {"wide", "wide.2"} <= set(got)
    for k in want:
        np.testing.assert_array_equal(got[k].cigar, want[k].cigar)
        assert got[k].pos == want[k].pos
    assert got["wide"].pos == got["wide.2"].pos == WIDE_EXON[0]


def test_default_sam_matches_jax(workload):
    g, ref, reads, names = workload
    seqset = bench._pack(reads, names)
    want = ref.align_seqset_packed(seqset).emit_sam(ref.refs)
    fused = TorchBatchAligner(g, index=ref.index, device="cpu")
    assert fused.align_seqset_packed(seqset).emit_sam(fused.refs) == want
    assert fused.stats["anchors"] > K_MAX_A


def test_from_jax_aligner_carries_backend(workload):
    """Every reference chain backend takes the port's one chain dispatch;
    backend="torch" (as cardbench passes it) is the only value taken."""
    g, ref, _, _ = workload
    assert TorchBatchAligner.from_jax_aligner(ref, "cpu").backend == "torch"
    pal = BatchAligner(g, index=ref.index, backend="pallas")
    port = TorchBatchAligner.from_jax_aligner(pal, "cpu",
                                              devices=["cpu", "cpu"])
    assert port.backend == "torch"
    assert port.devices == [torch.device("cpu")] * 2
    assert TorchBatchAligner(g, index=ref.index, device="cpu",
                             backend="torch").backend == "torch"
    for bad in ("pallas", "jax"):
        with pytest.raises(ValueError, match=f"backend must be 'torch', "
                                             f"got '{bad}'"):
            TorchBatchAligner(g, index=ref.index, device="cpu", backend=bad)
    with pytest.raises(ValueError, match="devices"):
        TorchBatchAligner(g, index=ref.index, device="cpu", devices=[])


@pytest.mark.parametrize("backend", ["torch"])
def test_split_over_two_devices_matches_one(bench_small, backend):
    """devices=[cpu, cpu]: every chain launch is split in two row blocks
    (the 1664- and 320-row chunks), and the SAM equals devices=[cpu]."""
    g, seqset, _, _ = bench_small
    one = TorchBatchAligner(g, device="cpu", backend=backend)
    two = TorchBatchAligner(g, index=one.index, device="cpu",
                            backend=backend, devices=["cpu", "cpu"])
    rows = two._batch_anchors([seqset.get(i) for i in range(seqset.n)])
    pending = two._chain_rows_async(rows)
    blocks = [(len(e[2]), len(e[-1])) for e in pending if e[0] == "device"]
    assert blocks
    for n_rows, n_blocks in blocks:   # split_rows' rule, min_rows 8
        assert n_blocks == (2 if n_rows % 2 == 0 else 1)
    assert blocks[0][1] == 2
    want = one.align_seqset_packed(seqset).emit_sam(one.refs)
    assert two.align_seqset_packed(seqset).emit_sam(two.refs) == want


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Simulated data and the reference host pipeline's outputs."""
    root = tmp_path_factory.mktemp("devices")
    data = sim_dataset(root / "data")
    ref_pipeline(pipeline_config(data, root / "ref"), use_tpu=False)
    return root, data, pipeline_outputs(root / "ref")


def test_pipeline_on_two_devices_matches_reference(dataset):
    """run_pipeline(devices=[cpu, cpu]): the align stage's chain launches
    split in two row blocks give the reference host pipeline's 11 files."""
    root, data, want = dataset
    out = root / "port2"
    run_pipeline(pipeline_config(data, out), device="cpu",
                 devices=["cpu", "cpu"])
    assert pipeline_outputs(out) == want
    log = (out / "logs" / "pipeline.log").read_text()
    assert "split over cpu, cpu" in log


def test_devices_are_refused_under_a_group(monkeypatch, dataset):
    from lr2rmats_tpu_torch.pipeline import stages
    root, data, _ = dataset
    monkeypatch.setattr(stages, "multihost_info", lambda: (0, 2))
    with pytest.raises(ValueError, match="one-process run"):
        run_pipeline(pipeline_config(data, root / "grp"), device="cpu",
                     devices=["cpu", "cpu"])
