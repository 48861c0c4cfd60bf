"""The port's last entry points against the repository's own, on the CPU at
small sizes: the aligner's MAPQ margin recording against the reference's
`BatchAligner(backend="jax")`, and lr2rmats_tpu_torch/scripts/
calibrate_mapq, analyze_ont_failures, bench_pass2_tail, bench_gather and
bench_scaling_throughput against scripts/ of the same names (the port with
device "cpu", the plain versions of its kernels; the reference with JAX on
the CPU).
"""

import functools
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

import bench
from lr2rmats_tpu.align.batch import BatchAligner as RefBatchAligner
from lr2rmats_tpu.index.minimizer import MinimizerIndex as RefIndex
from lr2rmats_tpu_torch import bench as port_bench
from lr2rmats_tpu_torch import synth
from lr2rmats_tpu_torch.align.batch import BatchAligner, TorchBatchAligner
from lr2rmats_tpu_torch.diag.measure import GuardError
from lr2rmats_tpu_torch.scripts import analyze_ont_failures as port_analyze
from lr2rmats_tpu_torch.scripts import bench_gather as port_gather
from lr2rmats_tpu_torch.scripts import bench_pass2_tail as port_tail
from lr2rmats_tpu_torch.scripts import bench_scaling_throughput as scaling
from lr2rmats_tpu_torch.scripts import calibrate_mapq as port_cal
from tests.test_torch_bench import _load_reference_script
from tests.test_torch_chain import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_host import reference_native_library

REPO = pathlib.Path(__file__).resolve().parents[1]
PROFILES = {"clean": (None, 5), "ont": ("ont", 6)}
RTOL = 1e-5     # the CPU log2 ulp of torch against XLA (ROADMAP §3 traps)


@pytest.fixture(scope="module", autouse=True)
def both_native_libraries():
    """Both packages run their native paths, each through its own loader."""
    with pytest.MonkeyPatch.context() as mp:
        reference_native_library(mp)
        yield


def _digest(path):
    return hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest()


# ----------------------------------------------------------------- margins
def _assert_margins_close(got, want):
    """Margins 1 - s2/s1 of chain scores that agree at RTOL: their
    complements s2/s1 agree at RTOL (a margin near 0 has no relative
    precision of its own)."""
    keys = sorted(want)
    np.testing.assert_allclose([1 - got[q] for q in keys],
                               [1 - want[q] for q in keys], rtol=RTOL)


@functools.lru_cache(maxsize=None)
def _reference_margins(profile, backend):
    """The margins, primaries' MAPQs and SAM of the reference's
    BatchAligner(backend=backend) at 256 reads on a 1 Mb genome (bench.py's
    generator, calibrate_mapq's seeds)."""
    prof, seed = PROFILES[profile]
    rng = np.random.default_rng(seed)
    genome = bench.build_genome(int(1e6), rng)
    reads, _ = bench.simulate_reads(genome, 256, rng, profile=prof)
    names = [f"r{i}" for i in range(len(reads))]
    al = RefBatchAligner(genome, index=RefIndex.build(genome),
                         backend=backend)
    al.record_margins = True
    rb = al.align_seqset_packed(bench._pack(reads, names))
    mapq = {rb.qname[t]: int(rb.mapq[t]) for t in range(rb.n)
            if not rb.flag[t] & 0x100}
    return dict(al._mapq_margins), mapq, rb.emit_sam(al.refs)


@pytest.mark.parametrize("kind", ["torch_cpu", "host"])
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_margins_match_reference(profile, kind):
    """record_margins on the port's aligners records the qnames, margins
    and MAPQs of the reference's aligner of the same precision, and leaves
    the SAM bytes the reference's: TorchBatchAligner(device="cpu") against
    backend "jax" (float32 chain scores; margins as below), the host
    BatchAligner against backend "host" (float64; margins equal).  The two
    precisions may place a near-tie differently (ont, r146)."""
    want, want_mq, want_sam = _reference_margins(
        profile, "jax" if kind == "torch_cpu" else "host")
    prof, seed = PROFILES[profile]
    genome, reads, _, _ = port_bench.workload(1.0, 256, prof, seed)
    names = [f"r{i}" for i in range(len(reads))]
    al = (TorchBatchAligner(genome, device="cpu") if kind == "torch_cpu"
          else BatchAligner(genome))
    assert al.record_margins is False and al._mapq_margins == {}
    al.record_margins = True
    rb = al.align_seqset_packed(synth.pack_seqset(reads, names))
    al.close()
    got = al._mapq_margins
    assert sorted(got) == sorted(want)
    if kind == "host":
        assert got == want
    _assert_margins_close(got, want)
    mq = {rb.qname[t]: int(rb.mapq[t]) for t in range(rb.n)
          if not rb.flag[t] & 0x100}
    assert mq == want_mq
    assert rb.emit_sam(al.refs) == want_sam


def test_margins_off_by_default_record_nothing():
    genome, reads, _, names = port_bench.workload(0.5, 64, "ont", 6)
    al = TorchBatchAligner(genome, device="cpu")
    al.align_seqset_packed(synth.pack_seqset(reads, names))
    assert al._mapq_margins == {}


# ------------------------------------------------------------- calibration
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_calibration_rows_match_reference(monkeypatch, profile):
    """run_profile at 200 reads on 2 Mb against the reference's
    run_profile with its genome cut to 2 Mb: the same rows (qname, mapq,
    nh, correct) and margins."""
    ref = _load_reference_script("calibrate_mapq")
    build = ref.bench.build_genome
    monkeypatch.setattr(ref.bench, "build_genome",
                        lambda n, rng: build(2_000_000, rng))
    prof, seed = PROFILES[profile]
    want, want_m = ref.run_profile(prof, 200, seed)
    got, got_m, detail = port_cal.run_profile(prof, 200, seed, "cpu", 2.0)
    assert got == want
    assert sorted(got_m) == sorted(want_m)
    _assert_margins_close(got_m, want_m)
    assert detail["sam_identical_to_host_backend"]
    assert detail["margins_recorded"] == len(got_m)


def _hand_rows():
    """(result rows, margins) per profile: bin edges, empty bins, a bin
    all wrong, a bin all right, unique reads, a primary without a
    margin."""
    clean = [("a", 60, 1, True), ("b", 60, 1, True), ("c", 3, 2, False),
             ("d", 3, 3, True), ("e", 10, 2, True), ("f", 0, 2, False),
             ("g", 50, 2, True), ("h", 1, 2, True)]
    clean_m = {"a": 0.9, "b": 0.3, "c": 0.0, "d": 0.01, "e": 0.6,
               "f": 0.00999, "g": 1.0}
    ont = [("o1", 60, 1, False), ("o2", 7, 2, True), ("o3", 7, 2, True),
           ("o4", 0, 4, False), ("o5", 20, 2, True)]
    ont_m = {"o1": 0.5, "o2": 0.15, "o3": 0.2499, "o4": 0.05, "o5": 0.25}
    return {None: (clean, clean_m), "ont": (ont, ont_m)}


def test_table_matches_reference_formula(monkeypatch, tmp_path):
    """table() on hand-made rows against the reference script's own
    binning: its main runs from a copy under tmp_path, with run_profile
    returning the hand-made rows, so that it writes the copy's
    MAPQ_CALIBRATION.json; the repository's file stays untouched."""
    (tmp_path / "scripts").mkdir()
    shutil.copy(REPO / "scripts" / "calibrate_mapq.py", tmp_path / "scripts")
    (tmp_path / "bench.py").symlink_to(REPO / "bench.py")
    before = _digest(REPO / "MAPQ_CALIBRATION.json")
    ref = _load_reference_script(
        "calibrate_mapq_copy", tmp_path / "scripts" / "calibrate_mapq.py")
    hand = _hand_rows()
    monkeypatch.setattr(ref, "run_profile", lambda p, n, s: hand[p])
    monkeypatch.setattr(sys, "argv", ["calibrate_mapq.py", "7"])
    ref.main()
    want = json.loads((tmp_path / "MAPQ_CALIBRATION.json").read_text())
    assert _digest(REPO / "MAPQ_CALIBRATION.json") == before
    rows = [{"profile": p or "clean", "mapq": mq, "nh": nh, "correct": ok,
             "margin": m.get(qn)}
            for p, (res, m) in hand.items() for qn, mq, nh, ok in res]
    got = port_cal.table(rows)
    assert got == {k: want[k] for k in ("unique", "margin_bins")}
    assert [b["margin_lo"] for b in got["margin_bins"]] == [
        0.0, 0.01, 0.05, 0.15, 0.25, 0.6]


def test_bin_of_and_recorded_comparison():
    assert port_cal.bin_of(0.0) == 0 and port_cal.bin_of(0.01) == 1
    assert port_cal.bin_of(1.0) == 8 and port_cal.bin_of(1.01) is None
    assert port_cal.bin_of(None) is None
    doc = json.loads((REPO / "MAPQ_CALIBRATION.json").read_text())
    rec = {k: doc[k] for k in ("unique", "margin_bins")}
    assert port_cal.recorded_diff(port_cal.EXPECT, rec, 20000, 20.0) == []
    assert port_cal.recorded_diff(port_cal.EXPECT, rec, 200, 20.0) is None
    bumped = json.loads(json.dumps(rec))
    bumped["margin_bins"][0]["n"] += 1
    assert port_cal.recorded_diff(port_cal.EXPECT, bumped, 20000,
                                  20.0) == [[0.0, 0.01]]


def test_calibration_guard_refuses_a_differing_margin():
    port_cal._guard_margins("t", {"a": 0.3}, {"a": 0.3 + 5e-7})
    with pytest.raises(GuardError, match="margin"):
        port_cal._guard_margins("t", {"a": 0.3}, {"a": 0.3 + 2e-6})
    with pytest.raises(GuardError, match="margin"):
        port_cal._guard_margins("t", {"a": 0.01 - 1e-7}, {"a": 0.01})
    with pytest.raises(GuardError, match="different reads"):
        port_cal._guard_margins("t", {"a": 0.3}, {"b": 0.3})


def test_calibrate_main_on_cpu(tmp_path, capsys):
    out = tmp_path / "cal.json"
    assert port_cal.main(["--device", "cpu", "--reads", "100",
                          "--genome-mb", "1", "--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == line
    assert line["platform"] == "cpu" and line["card"] is None
    assert [p["profile"] for p in line["profiles"]] == ["clean", "ont"]
    assert line["equals_recorded"] is None
    assert line["unique"]["n"] + sum(b["n"] for b in line["margin_bins"]) \
        <= 200


# --------------------------------------------------------- failure analysis
def test_failure_categories_match_reference(monkeypatch, capsys):
    """analyze at 300 ONT reads on 2 Mb: the text the reference's main
    prints (counts and per-read detail) equals the port's report."""
    ref = _load_reference_script("analyze_ont_failures")
    monkeypatch.setenv("BENCH_READS", "300")
    monkeypatch.setattr(ref.bench, "GENOME_MB", 2.0)
    ref.main()
    want = capsys.readouterr().out
    cats, detail = port_analyze.analyze(300, "cpu", 2.0)
    assert port_analyze.report(cats, 300) == want
    assert detail["inexact"] == sum(detail["categories"].values())
    assert detail["inexact"] > 0
    assert detail["sam_identical_to_host_backend"]


def test_failure_categories_precedence():
    """Each category on a hand-made record, in the reference's order of
    tests; a secondary record is not the read's primary."""
    from lr2rmats_tpu_torch.io.sam import AlnRec

    def rec(name, pos, *ops, flag=0):
        cig = np.array([(n << 4) | op for n, op in ops], np.uint32)
        return AlnRec(qname=name, flag=flag, tid=0, pos=pos, cigar=cig)

    M, N = 0, 3
    truth = [(100, 200), (500, 600)]
    recs = [rec("read1", 900_000, (100, M), (300, N), (100, M)),
            rec("read2", 100, (500, M)),
            rec("read3", 100, (100, M), (300, N), (50, M), (20, N),
                (30, M)),
            rec("read4", 100, (102, M), (298, N), (98, M)),
            rec("read5", 100, (92, M), (308, N), (100, M)),
            rec("read6", 100, (130, M), (270, N), (100, M)),
            rec("read7", 100, (100, M), (300, N), (100, M)),
            rec("read8", 100, (130, M), (270, N), (100, M), flag=0x100)]

    class Records:
        def to_alnrecs(self):
            return recs

    names = [f"read{i}" for i in range(9)]
    cats = port_analyze.categorize(Records(), [truth] * 9, names)
    sites = [200, 501]
    assert cats == {
        "unaligned": [(0, None), (8, None)],
        "wrong_locus": [(1, (sites, [900100, 900401]))],
        "missed_junction": [(2, (sites, []))],
        "extra_junction": [(3, (sites, [200, 501, 550, 571]))],
        "slide_le2": [(4, (sites, [202, 501]))],
        "slide_le10": [(5, (sites, [192, 501]))],
        "slide_gt10": [(6, (sites, [230, 501]))]}
    text = port_analyze.report(cats, 9)
    assert text.startswith("reads=9 inexact=8 (0.1111 exact)\n")
    assert "  read4 nexon_t=2\n    deltas [2, 0]\n" in text


# ------------------------------------------------------------ pass-2 tail
def test_pass2_tail_matches_reference(capsys):
    """The reference script (which runs at import) with N_ANNO 100 and
    N_READS 2000, against the port's generator and classify at the same
    sizes: the four output sets are equal, column by column."""
    src = (REPO / "scripts" / "bench_pass2_tail.py").read_text()
    for old, new in (("N_ANNO = 2000", "N_ANNO = 100"),
                     ("N_READS = 100_000", "N_READS = 2000")):
        assert src.count(old) == 1
        src = src.replace(old, new)
    ns = {"__name__": "reference_bench_pass2_tail"}
    exec(compile(src, "scripts/bench_pass2_tail.py", "exec"), ns)
    capsys.readouterr()
    reads, anno, sj = port_tail.make_input(100, 2000)
    assert sj.n == ns["sj"].n
    got = port_tail.classify(reads, anno, sj)[:4]
    want = [ns[k] for k in ("upd", "kn", "nv", "un")]
    for g, w in zip(got, want):
        assert g.n == w.n
        for slot in g.__slots__:
            a, b = getattr(g, slot), getattr(w, slot)
            if slot in ("_cap", "_ecap"):
                continue
            if isinstance(a, dict):
                assert sorted(a) == sorted(b)
                for k in a:
                    np.testing.assert_array_equal(a[k][:g.n], b[k][:w.n])
            elif isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a[:g.n], b[:w.n])
            else:
                assert a == b, slot
    r = port_tail.run(100, 2000)
    assert (r["known"], r["novel"], r["unrecog"], r["updated"]) == (
        ns["kn"].n, ns["nv"].n, ns["un"].n, ns["upd"].n)
    assert r["novel"] > 0 and r["updated"] > 0


def test_pass2_tail_main_names_the_host(tmp_path, capsys):
    out = tmp_path / "tail.json"
    assert port_tail.main(["--anno", "20", "--reads", "200", "--out",
                           str(out)]) == 0
    cap = capsys.readouterr()
    line = json.loads(cap.out)
    assert json.loads(out.read_text()) == line
    assert line["platform"] == "cpu" and line["cores"] == os.cpu_count()
    assert "card" in line and line["n_reads"] == 200
    assert cap.err.startswith("reads=200 anno=20 ")


# ------------------------------------------------------------------ gather
def test_gather_two_processes(tmp_path, capsys):
    """Two processes over gloo at 1 MiB: every gather returned every
    process's payload in process order (the workers' guard), with every
    timing of the reference."""
    out = tmp_path / "gather.json"
    assert port_gather.main(["--mb", "1", "--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out)
    assert json.loads(out.read_text()) == line
    assert line["gathered_lists_identical"] and line["processes"] == 2
    assert line["fixed_bytes"] == 1 << 20
    assert line["vary_bytes"] == [(1 << 20) - 8191 * i for i in range(1, 6)]
    for key in ("fixed_repeat_s", "vary_s", "small_1mb_s"):
        assert len(line[key]) == 5
    assert line["fixed_mb_s"] > 0


def test_gather_guard_refuses_a_differing_list(monkeypatch):
    """A gather that returns the payloads out of order fails the guard."""
    from lr2rmats_tpu_torch.parallel import distributed
    monkeypatch.setattr(distributed, "gather_blobs",
                        lambda blob: [blob[::-1]])
    with pytest.raises(GuardError, match="differs"):
        port_gather.worker(0, 1, "unused:0", 0.01)


# ----------------------------------------------------------------- scaling
@pytest.fixture(scope="module")
def scaling_runs(tmp_path_factory):
    """A tiny simulate.py dataset; the port's scaling script with arms 1
    and 2 on the CPU; the reference's `run --cpu` on the same lists (its
    own copy of the genome, so that the two index caches stay apart)."""
    root = tmp_path_factory.mktemp("scaling")
    sim, work = root / "sim", root / "work"
    synth.simulate_dataset(str(sim), genome_mb=0.5, genes=10,
                           long_reads=400, short_pairs=1200)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "",
           "PYTHONPATH": str(REPO), "LR2RMATS_THREADS": "2",
           "OMP_NUM_THREADS": "1"}
    before = _digest(REPO / "SCALING.json")
    port = subprocess.run(
        [sys.executable, "-m", scaling.__name__, "--device", "cpu",
         "--procs", "1,2", "--sim", str(sim), "--work", str(work), "--out",
         str(root / "scaling.json")], cwd=root, env=env,
        capture_output=True, text=True, timeout=600)
    ref_genome = root / "ref_genome"
    ref_genome.mkdir()
    for f in ("genome.fa", "anno.gtf"):
        shutil.copy(sim / f, ref_genome / f)
    ref = subprocess.run(
        [sys.executable, "-m", "lr2rmats_tpu", "run", "--genome",
         str(ref_genome / "genome.fa"), "--gtf", str(ref_genome / "anno.gtf"),
         "--long-read-list", str(work / "long.list"), "--short-read-list",
         str(work / "short.list"), "--out-dir", str(root / "ref"), "--cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    return dict(root=root, work=work, port=port, ref=ref, before=before,
                after=_digest(REPO / "SCALING.json"))


def test_scaling_arms_equal_each_other(scaling_runs):
    port = scaling_runs["port"]
    assert port.returncode == 0, port.stderr[-3000:]
    line = json.loads(port.stdout.strip().splitlines()[-1])
    assert line["outputs_identical_across_arms"]
    assert line["n_reads"] == 400 and line["n_samples"] == 4
    assert sorted(line["arms"]) == ["1", "2"]
    one, two = line["arms"]["1"], line["arms"]["2"]
    assert one["efficiency_vs_1proc"] == 1.0
    assert len(one["processes"]) == 1 and len(two["processes"]) == 2
    assert line["platform"] == "cpu" and line["setup_s"][
        "kernel_build_s"] is None
    for p in one["processes"] + two["processes"]:
        assert p["peak_rss_mb"] > 0 and p["peak_card_mb"] is None
        assert 0 < p["outside_stages_s"] < p["wall_s"]
        assert not any(p["launches"].values())
        assert p["align_launches"] == {"chain": 0, "shift_dp": 0,
                                       "junction": 0}
    # each process's stage walls: its own samples (round-robin) and index
    # file, the final merge on process 0
    assert {k for k in two["processes"][0]["stage_walls_s"]
            if k.startswith("samp")} == {
        f"samp{i}{s}" for i in (1, 3) for s in (
            ".minimap", ".novel_gtf", ".star", "_gtf_novel_gtf",
            "_new_gtf")}
    assert "update_gtf" in two["processes"][0]["stage_walls_s"]
    assert "index.p1" in two["processes"][1]["stage_walls_s"]
    assert "update_gtf" in one["processes"][0]["stage_walls_s"]


def test_scaling_outputs_equal_the_reference(scaling_runs):
    ref = scaling_runs["ref"]
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = scaling.output_files(str(scaling_runs["root"] / "ref"))
    assert len(want) == 29
    for arm in ("out_cpu_p1", "out_cpu_p2"):
        assert scaling.output_files(str(scaling_runs["work"] / arm)) == want


def test_scaling_writes_only_its_out(scaling_runs):
    """SCALING.json is untouched; the working directory holds only the
    --out file beside the directories it was given."""
    assert scaling_runs["port"].returncode == 0
    assert scaling_runs["before"] == scaling_runs["after"]
    root = scaling_runs["root"]
    doc = json.loads((root / "scaling.json").read_text())
    assert doc == json.loads(
        scaling_runs["port"].stdout.strip().splitlines()[-1])
    assert sorted(p.name for p in root.iterdir()) == [
        "ref", "ref_genome", "scaling.json", "sim", "work"]


def test_outside_stages():
    walls = {"index.p0": 0.1, "samp1.minimap": 10.0, "samp3.minimap": 12.0,
             "samp1.novel_gtf": 1.0, "samp1.star": 4.0,
             "samp3_new_gtf": 2.0, "samp3_gtf_novel_gtf": 2.5,
             "update_gtf": 0.5}
    assert scaling.outside_stages(40.0, walls) == pytest.approx(
        40.0 - 22.0 - 5.0 - 0.5)
    assert scaling.outside_stages(3.0, {}) == 3.0


def test_stage_walls_attribution(tmp_path):
    bdir = tmp_path / "benchmark"
    bdir.mkdir()
    for name, s in (("index.p0", 1.0), ("index.p2", 2.0),
                    ("samp1.minimap", 3.0), ("samp2_new_gtf", 4.0),
                    ("samp6.star", 5.0), ("update_gtf", 6.0)):
        (bdir / f"{name}.benchmark.txt").write_text(f"s\n{s}\t0:00:01\n")
    assert scaling.stage_walls(str(tmp_path), 3) == [
        {"index.p0": 1.0, "samp1.minimap": 3.0, "update_gtf": 6.0},
        {"samp2_new_gtf": 4.0},
        {"index.p2": 2.0, "samp6.star": 5.0}]


def test_log_launch_lines(tmp_path):
    """The launch counts a pipeline process logs: all of them from the
    final line, its alignment's from the last sample's line."""
    log = tmp_path / "pipeline.p0.log"
    log.write_text(
        "=== t === [align] samp1: phases seed=1.0s dispatch=0.1s build=1.0s"
        " polish=0.5s; kernel launches chain=5 shift_dp=1 junction=0; "
        "junction gaps on cuda:0: 0 (0 placed); device seed lookups: 0\n"
        "=== t === [align] samp3: phases seed=1.0s dispatch=0.1s build=1.0s"
        " polish=0.5s; kernel launches chain=9 shift_dp=2 junction=0; "
        "junction gaps on cuda:0: 0 (0 placed); device seed lookups: 0\n"
        '=== t === [pipeline] process 0/2: kernel launches {"chain_dp": 0, '
        '"chain_dp_backtrack": 12, "shift_dp": 3}\n'
        "=== t === [pipeline] process 0/2: peak card memory 18.4 MB\n")
    assert scaling.log_align_launches(str(log)) == {
        "chain": 9, "shift_dp": 2, "junction": 0}
    assert scaling.log_launches(str(log)) == {
        "chain_dp": 0, "chain_dp_backtrack": 12, "shift_dp": 3}
    assert scaling.log_peak_card_mb(str(log)) == 18.4
