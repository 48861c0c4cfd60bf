"""The port's own copies of the reference's host modules give the
reference's results: the same seeded inputs go through lr2rmats_tpu and
lr2rmats_tpu_torch, and the outputs must be equal, bytes for the files.

Covered: FASTA / FASTQ, GTF and SAM / BAM read and write; the minimizer
index arrays and lookups; the host chain and backtrack; the SAM of the
host aligner backend, and its per-record and split-phase entry points
(`align_seqset`, `finish_batch_packed`); the AlnRec-list polish bridges
(`collect_junction_support`, `polish_records`) and `have_native`; every
CLI subcommand; `run --cpu`; and synth.py against bench.py and
scripts/simulate.py.
"""

import gzip
import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import bench
from lr2rmats_tpu.align import chain as ref_chain
from lr2rmats_tpu.align.batch import BatchAligner as RefBatchAligner
from lr2rmats_tpu.index.minimizer import MinimizerIndex as RefIndex
from lr2rmats_tpu.io import fasta as ref_fasta
from lr2rmats_tpu.io import gtf as ref_gtf
from lr2rmats_tpu.io import sam as ref_sam
from lr2rmats_tpu.pipeline.cli import main as ref_main
from lr2rmats_tpu_torch import synth
from lr2rmats_tpu_torch.align import chain as port_chain
from lr2rmats_tpu_torch.align.batch import BatchAligner
from lr2rmats_tpu_torch.index.minimizer import MinimizerIndex
from lr2rmats_tpu_torch.io import fasta as port_fasta
from lr2rmats_tpu_torch.io import gtf as port_gtf
from lr2rmats_tpu_torch.io import sam as port_sam
from lr2rmats_tpu_torch.pipeline.cli import main as port_main
from tests.test_torch_chain import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
SIM = dict(genome_mb=0.5, genes=10, long_reads=300, short_pairs=1200)


def _files(root):
    """Bytes of every file under root, by relative path (sidecars, logs
    and timings excluded)."""
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()
            and not p.name.endswith(".inputs.json")
            and p.parent.name not in ("logs", "benchmark")
            and p.name != "config.yaml"}


def reference_native_library(mp):
    """Make the reference's own loader load the native library, with its
    own ctypes bindings.  That loader races under parallel test workers
    (every process compiles to one temporary name, ROADMAP §3), and a
    worker that lost the race keeps None for its life and takes the numpy
    paths while the port takes the native ones.  So put the port's build
    of the same csrc/lrio.cpp (same compiler and flags) where the
    reference looks, by an atomic rename, and let a loader that gave up
    try again."""
    import shutil
    import lr2rmats_tpu.native.lib as ref_lib
    from lr2rmats_tpu_torch.native import lib as port_lib
    assert port_lib.get_lib() is not None
    if port_lib._stale(ref_lib._SO, ref_lib._SRC):
        os.makedirs(os.path.dirname(ref_lib._SO), exist_ok=True)
        tmp = f"{ref_lib._SO}.{os.getpid()}.tmp"
        shutil.copyfile(port_lib._SO, tmp)
        os.replace(tmp, ref_lib._SO)
    if ref_lib._lib is None:
        mp.setattr(ref_lib, "_tried", False)
    assert ref_lib.get_lib() is not None


@pytest.fixture(scope="module", autouse=True)
def both_native_libraries():
    """Both packages run their native paths, each through its own loader."""
    with pytest.MonkeyPatch.context() as mp:
        reference_native_library(mp)
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A small scripts/simulate.py dataset (synth.py) through the
    reference's `run --cpu` and the port's: (data, ref_out, port_out)."""
    root = tmp_path_factory.mktemp("host")
    data = root / "data"
    synth.simulate_dataset(str(data), **SIM)
    outs = {}
    for tag, main in (("ref", ref_main), ("port", port_main)):
        outs[tag] = root / tag
        rc = main(["run", "--cpu", "--genome", f"{data}/genome.fa",
                   "--gtf", f"{data}/anno.gtf",
                   "--long-read", f"{data}/long.fa",
                   "--short-read-1", f"{data}/short_1.fa",
                   "--short-read-2", f"{data}/short_2.fa",
                   "--out-dir", str(outs[tag])])
        assert rc == 0
    return data, outs["ref"], outs["port"]


# ------------------------------------------------------------------- I/O
def _seqsets_equal(a, b):
    assert list(a.names) == list(b.names)
    assert np.array_equal(a.codes, b.codes)
    assert np.array_equal(a.offsets, b.offsets)


@pytest.mark.parametrize("kind", ["fasta", "fastq", "fasta.gz"])
def test_read_fastx_matches_reference(tmp_path, kind):
    rng = np.random.default_rng(11)
    recs = [(f"r{i} extra", rng.integers(0, 4, int(rng.integers(1, 400))))
            for i in range(60)]
    text = ""
    for name, codes in recs:
        seq = ref_fasta.decode_seq(codes.astype(np.uint8))
        if kind == "fastq":
            text += f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n"
        else:
            text += f">{name}\n" + "".join(
                seq[i: i + 61] + "\n" for i in range(0, len(seq), 61))
    path = tmp_path / f"reads.{kind}"
    if kind.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    _seqsets_equal(port_fasta.read_fasta(str(path)),
                   ref_fasta.read_fasta(str(path)))
    assert list(port_fasta.iter_fastx(str(path))) == \
        list(ref_fasta.iter_fastx(str(path)))
    g = port_fasta.Genome.load(str(path))
    _seqsets_equal(g, ref_fasta.Genome.load(str(path)))
    assert np.array_equal(g.slice(3, 5, 40),
                          ref_fasta.Genome.load(str(path)).slice(3, 5, 40))


@pytest.mark.parametrize("reader", ["read_gtf_trans", "read_anno_trans"])
def test_gtf_read_write_matches_reference(runs, reader):
    data, ref_out, _ = runs
    for path in (f"{data}/anno.gtf", f"{ref_out}/output/updated.gtf",
                 f"{ref_out}/gtf/samp1_gtf_novel.gtf"):
        texts = []
        for mod in (ref_gtf, port_gtf):
            cname = mod.ChrNames(["chrSim"])
            T = getattr(mod, reader)(path, cname)
            buf = io.StringIO()
            mod.write_read_trans(T, cname, "src", buf)
            texts.append((T.n, buf.getvalue()))
        assert texts[0] == texts[1] and texts[0][0] > 0


def test_sam_bam_read_write_matches_reference(runs, tmp_path):
    _, ref_out, _ = runs
    sam = f"{ref_out}/alignment/samp1.minimap.sam"
    outs = []
    for tag, mod in (("ref", ref_sam), ("port", port_sam)):
        refs, header, records = mod.open_alignments(sam)
        records = list(records)
        buf = io.StringIO()
        w = mod.SamWriter(buf, refs, header or None)
        for r in records:
            w.write(r)
        bam = tmp_path / f"{tag}.bam"
        mod.write_bam(str(bam), refs, header or None, records)
        back = list(mod.open_alignments(str(bam))[2])
        outs.append((refs, buf.getvalue(), bam.read_bytes(),
                     [(r.qname, r.flag, r.pos, r.cigar.tolist()) for r in back]))
    assert outs[0] == outs[1]
    assert outs[0][1] == open(sam).read()


# ------------------------------------------------------- index and chain
def test_minimizer_index_matches_reference():
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, 400_000).astype(np.uint8)
    codes[200_000: 230_000] = codes[10_000: 40_000]      # repeats
    offs = np.array([0, 150_000, 400_000], np.int64)
    port = MinimizerIndex.build(port_fasta.Genome(["a", "b"], codes, offs))
    ref = RefIndex.build(ref_fasta.Genome(["a", "b"], codes, offs))
    for f in ("hashes", "pos", "strand", "chrom_offsets"):
        assert np.array_equal(getattr(port, f), getattr(ref, f)), f
    assert (port.k, port.w, port.max_occ, port.names) == \
        (ref.k, ref.w, ref.max_occ, ref.names)
    q = np.concatenate([rng.choice(ref.hashes, 3000),
                        rng.integers(0, 1 << 30, 1000).astype(np.uint64)])
    for a, b in zip(port.lookup(q), ref.lookup(q)):
        assert np.array_equal(a, b)
    gp = rng.integers(0, 400_000, 500)
    for a, b in zip(port.global_to_chrom(gp), ref.global_to_chrom(gp)):
        assert np.array_equal(a, b)


def test_from_jax_aligner_converts_a_sharded_index():
    """A reference aligner over an in-process sharded index crosses to the
    port's own ShardedMinimizerIndex, sharing the shard arrays, and the
    lookups agree."""
    from lr2rmats_tpu.parallel.shard_index import ShardedMinimizerIndex as R
    from lr2rmats_tpu_torch.align.batch import TorchBatchAligner
    from lr2rmats_tpu_torch.parallel.shard_index import ShardedMinimizerIndex
    rng = np.random.default_rng(4)
    g = bench.build_genome(300_000, rng)
    ref = RefBatchAligner(g, index=R.build(g, 3), backend="host")
    port = TorchBatchAligner.from_jax_aligner(ref, device="cpu")
    assert type(port.index) is ShardedMinimizerIndex
    assert all(a.hashes is b.hashes for a, b in
               zip(port.index.shards, ref.index.shards))
    q = rng.choice(ref.index.shards[0].hashes, 500)
    for a, b in zip(port.index.lookup_collective(q),
                    ref.index.lookup_collective(q)):
        assert np.array_equal(a, b)


def test_host_chain_and_backtrack_match_reference():
    from tests.test_chain_jax import random_anchor_rows
    qp, rp, ns = random_anchor_rows(np.random.default_rng(31), 48, 128)
    pc, rc = port_chain.ChainParams(), ref_chain.ChainParams()
    assert vars(pc) == vars(rc)
    n_chains = 0
    for b in range(len(ns)):
        q, r = qp[b, :ns[b]], rp[b, :ns[b]]
        f, parent = port_chain.chain_anchors(q, r, pc)
        rf, rparent = ref_chain.chain_anchors(q, r, rc)
        assert np.array_equal(f, rf) and np.array_equal(parent, rparent)
        got = port_chain.backtrack(f, parent, 20.0)
        want = ref_chain.backtrack(rf, rparent, 20.0)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
        assert np.array_equal(got[2], want[2]) and got[3] == want[3]
        n_chains += len(got[0]) > 0
    assert n_chains > 10


def test_host_backend_sam_matches_reference():
    """emit_sam of the port's BatchAligner (host only) equals the
    reference's BatchAligner(backend="host") on a bench.py workload."""
    out = []
    for gen, make, gmod in (
            (bench, lambda g: RefBatchAligner(g, backend="host"), ref_fasta),
            (synth, BatchAligner, port_fasta)):
        rng = np.random.default_rng(123)
        g = gen.build_genome(1_500_000, rng)
        reads, _ = gen.simulate_reads(g, 400, rng, profile="ont")
        names = [f"read{i}" for i in range(len(reads))]
        seqset = gmod.SeqSet(names, np.concatenate(reads), np.concatenate(
            [[0], np.cumsum([len(r) for r in reads])]).astype(np.int64))
        al = make(g)
        out.append(al.align_seqset_packed(seqset, batch_size=128)
                   .emit_sam(al.refs))
    assert out[0] == out[1] and out[0].count(b"\n") >= 400


def _rec_key(r):
    """Every field of an AlnRec, arrays as lists."""
    return tuple(v.tolist() if isinstance(v, np.ndarray) else v
                 for v in vars(r).values())


@pytest.fixture(scope="module")
def ont_pair():
    """A bench.py ONT workload (1.5 Mb, 400 reads, seed 123) with the
    reference's host aligner and the port's: (ref, port, names, reads,
    seqset), the seqset in each package's own SeqSet."""
    rng = np.random.default_rng(123)
    g = synth.build_genome(1_500_000, rng)
    reads, _ = synth.simulate_reads(g, 400, rng, profile="ont")
    names = [f"read{i}" for i in range(len(reads))]
    seqset = synth.pack_seqset(reads, names)
    ref_seqset = ref_fasta.SeqSet(names, seqset.codes, seqset.offsets)
    ref = RefBatchAligner(ref_fasta.Genome(g.names, g.codes, g.offsets),
                          backend="host")
    port = BatchAligner(g, index=None)
    return ref, port, names, reads, (ref_seqset, seqset)


@pytest.mark.parametrize("polish", [False, True])
def test_align_seqset_matches_reference(ont_pair, polish):
    """The per-record generator gives the reference's records, field for
    field, with and without the junction polish."""
    ref, port, _, _, (ref_set, port_set) = ont_pair
    want = [_rec_key(r) for r in ref.align_seqset(ref_set, batch_size=128,
                                                  polish=polish)]
    got = [_rec_key(r) for r in port.align_seqset(port_set, batch_size=128,
                                                  polish=polish)]
    assert got == want and len(want) >= 400


def test_finish_batch_packed_matches_reference(ont_pair):
    """dispatch_batch then finish_batch_packed: the RecordBatch of one
    batch emits the reference's SAM bytes."""
    ref, port, names, reads, _ = ont_pair
    out = [al.finish_batch_packed(al.dispatch_batch(names[:160], reads[:160]))
           .emit_sam(al.refs) for al in (ref, port)]
    assert out[0] == out[1] and out[0].count(b"\n") >= 160
    assert port.stats["build_s"] > 0


@pytest.fixture(scope="module")
def unpolished(ont_pair):
    """The workload's records before the polish, from each package, and
    the (genome codes, chrom offsets) each aligner's polish takes."""
    ref, port, _, _, (ref_set, port_set) = ont_pair
    return (list(ref.align_seqset(ref_set, batch_size=128, polish=False)),
            list(port.align_seqset(port_set, batch_size=128, polish=False)),
            (ref.inner.genome.codes, ref.index.chrom_offsets),
            (port.inner.genome.codes, port.index.chrom_offsets))


def test_collect_junction_support_matches_reference(unpolished):
    from lr2rmats_tpu.align.polish import collect_junction_support as ref_f
    from lr2rmats_tpu_torch.align.polish import collect_junction_support
    ref_recs, port_recs, rg, pg = unpolished
    want = ref_f(ref_recs, *rg)
    assert collect_junction_support(port_recs, *pg) == want
    assert len(want) > 20


def test_polish_records_matches_reference(unpolished):
    """polish_records re-places the same junctions and rewrites the same
    CIGAR, NM and AS on the AlnRec lists in place."""
    import copy
    from lr2rmats_tpu.align.polish import polish_records as ref_f
    from lr2rmats_tpu_torch.align.polish import polish_records
    ref_recs, port_recs, rg, pg = (copy.deepcopy(x) for x in unpolished)
    n_ref = ref_f(ref_recs, *rg)
    assert polish_records(port_recs, *pg) == n_ref
    assert [_rec_key(r) for r in port_recs] == \
        [_rec_key(r) for r in ref_recs]
    assert n_ref > 0


def test_have_native_matches_reference():
    from lr2rmats_tpu.native import have_native as ref_have
    from lr2rmats_tpu_torch.native import have_native
    assert have_native() is ref_have() is True


def test_host_backend_is_the_only_base_backend():
    """The base class has no backend to choose: it runs on the host."""
    g = synth.build_genome(100_000, np.random.default_rng(0))
    assert BatchAligner(g).backend == "host"
    with pytest.raises(TypeError, match="backend"):
        BatchAligner(g, backend="jax")


# ------------------------------------------------------------ pipeline
def test_run_cpu_matches_reference(runs):
    """`run --cpu` of the port and of the reference: all 11 output files
    (output/*, the SAM, BED and junction table), and every other artifact
    (filtered SAM, GTFs), byte for byte."""
    _, ref_out, port_out = runs
    from tests.test_torch_kernels import pipeline_outputs
    got, want = pipeline_outputs(port_out), pipeline_outputs(ref_out)
    assert len(want) == 11 and got == want
    assert _files(port_out) == _files(ref_out)


def _cli_cases(data, ref_out):
    aln = f"{ref_out}/alignment"
    gtfd = f"{ref_out}/gtf"
    sam = f"{aln}/samp1.minimap.sam"
    filt = f"{aln}/samp1.filtered.sam"
    return {
        "filter-sam": (["filter", sam, "--sam", "-o", "{o}/f.sam"], None),
        "filter-bam": (["filter", sam, "-r", f"{data}/anno.gtf",
                        "-o", "{o}/f.bam"], None),
        "filter-nosort": (["filter", sam, "--sam", "--no-sort", "-v", "0.5",
                           "-o", "{o}/f.sam"], None),
        "fusion": (["fusion", sam, "--sam", "--output", "{o}/fu.sam",
                    "-f", "{o}/sites.txt", "-d", "10k"], None),
        "update-gtf": (["update-gtf", filt, f"{data}/anno.gtf", "-j",
                        f"{aln}/samp1.STARSJ.out.tab", "-s", "-o",
                        "{o}/u.gtf", "-a", "{o}/bam.gtf", "-A", "{o}/det.txt",
                        "-k", "{o}/known.gtf", "-v", "{o}/novel.gtf",
                        "-u", "{o}/unrecog.gtf", "-y", "{o}/summary.txt",
                        "-E", "{o}/exon.bed"], None),
        "update-gtf-gtf-input": (["update-gtf", "-m", "g", "-b", sam,
                                  f"{gtfd}/samp1_sam_novel.gtf",
                                  f"{data}/anno.gtf", "-o", "{o}/u.gtf"],
                                 None),
        "unique-gtf": (["unique-gtf", "-m", "g", "-b", sam,
                        f"{gtfd}/samp1_gtf_novel.gtf", "-o", "{o}/uq.gtf"],
                       None),
        "unique-gtf-intersect": (["unique-gtf", filt, "-I", "-o",
                                  "{o}/uq.gtf"], None),
        "bam2gtf": (["bam2gtf", filt, "-o", "{o}/b.gtf"], None),
        "bam2sj": (["bam2sj", filt, "-g", f"{data}/genome.fa",
                    "--no-prop-pair", "-o", "{o}/sj.tab"], None),
        "sort-gtf": (["sort-gtf", f"{gtfd}/samp1_new.gtf", "-o",
                      "{o}/s.gtf"], None),
        "sort-gtf-stdout": (["sort-gtf", f"{data}/anno.gtf"], "stdout"),
        "gtf2bed": (["gtf2bed", f"{ref_out}/output/updated.gtf", "-o",
                     "{o}/t.bed"], None),
        "bam2gtf-stdout": (["bam2gtf", sam], "stdout"),
        "version": (["version"], "stdout"),
    }


CLI_CASES = ["filter-sam", "filter-bam", "filter-nosort", "fusion",
             "update-gtf", "update-gtf-gtf-input", "unique-gtf",
             "unique-gtf-intersect", "bam2gtf", "bam2sj", "sort-gtf",
             "sort-gtf-stdout", "gtf2bed", "bam2gtf-stdout", "version"]


@pytest.mark.parametrize("case", CLI_CASES)
def test_subcommand_matches_reference(runs, tmp_path, capsys, case):
    """Each subcommand of `python -m lr2rmats_tpu_torch` writes the bytes
    of `python -m lr2rmats_tpu` (both mains run in this process)."""
    data, ref_out, _ = runs
    argv, stdout = _cli_cases(data, ref_out)[case]
    got = {}
    for tag, main in (("ref", ref_main), ("port", port_main)):
        o = tmp_path / tag
        o.mkdir()
        capsys.readouterr()
        assert main([a.replace("{o}", str(o)) for a in argv]) == 0
        printed = capsys.readouterr().out
        got[tag] = printed if stdout else _files(o)
    assert got["port"] == got["ref"]
    assert any(got["ref"].values()) if not stdout else got["ref"]


def test_module_entry_point_runs_subcommands(runs, tmp_path):
    """`python -m lr2rmats_tpu_torch <subcommand>` in a process of its own,
    with jax and the reference package blocked."""
    _, ref_out, _ = runs
    filt = f"{ref_out}/alignment/samp1.filtered.sam"
    script = ("import runpy, sys; sys.modules['jax'] = None; "
              "sys.modules['lr2rmats_tpu'] = None; "
              "sys.argv = ['lr2rmats_tpu_torch'] + sys.argv[1:]; "
              "runpy.run_module('lr2rmats_tpu_torch', run_name='__main__')")
    res = subprocess.run([sys.executable, "-c", script, "bam2gtf", filt,
                          "-o", str(tmp_path / "b.gtf")], cwd=str(REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    want = tmp_path / "want.gtf"
    assert ref_main(["bam2gtf", filt, "-o", str(want)]) == 0
    assert (tmp_path / "b.gtf").read_bytes() == want.read_bytes()


# ---------------------------------------------------------------- synth
@pytest.mark.parametrize("profile", [None, "ont"])
def test_synth_matches_bench(profile):
    out = []
    for gen in (bench, synth):
        rng = np.random.default_rng(123)
        g = gen.build_genome(600_000, rng)
        reads, truths = gen.simulate_reads(g, 150, rng, profile=profile)
        out.append((g.codes, reads, truths))
    assert np.array_equal(out[0][0], out[1][0])
    assert all(np.array_equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    assert out[0][2] == out[1][2]
    names = [f"read{i}" for i in range(len(out[0][1]))]
    _seqsets_equal(synth.pack_seqset(out[1][1], names),
                   bench._pack(out[0][1], names))


def test_synth_accuracy_matches_bench(runs):
    """accuracy_vs_truth of both over the same primary records."""
    rng = np.random.default_rng(5)
    g = synth.build_genome(800_000, rng)
    reads, truths = synth.simulate_reads(g, 120, rng, profile="ont")
    names = [f"read{i}" for i in range(len(reads))]
    al = BatchAligner(g)
    rb = al.align_seqset_packed(synth.pack_seqset(reads, names))
    prim = {r.qname: r for r in rb.to_alnrecs() if not (r.flag & 0x100)}
    got = synth.accuracy_vs_truth(truths, names, prim)
    assert got == bench.accuracy_vs_truth(truths, names, prim)
    assert got[0] > len(reads) // 2


def test_synth_dataset_matches_simulate_script(tmp_path):
    args = ["--genome-mb", "0.3", "--genes", "6", "--long-reads", "40",
            "--short-pairs", "150", "--seed", "9"]
    subprocess.run([sys.executable, str(REPO / "scripts" / "simulate.py"),
                    "--out", str(tmp_path / "ref"), *args], check=True,
                   capture_output=True)
    assert synth.main(["--out", str(tmp_path / "port"), *args]) == 0
    ref, port = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(ref) == ["anno.gtf", "genome.fa", "long.fa", "short_1.fa",
                           "short_2.fa"]
    assert port == ref
    assert os.path.getsize(tmp_path / "port" / "genome.fa") > 300_000
