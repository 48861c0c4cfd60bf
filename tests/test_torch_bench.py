"""The port's measurement entry points against the repository's own:
lr2rmats_tpu_torch.bench against bench.py, and the port's
ont_accuracy_sweep, bench_sjcount and dryrun_grch38 against scripts/ of the
same names, at small sizes on the CPU (the port with device "cpu", the
plain versions of its kernels; the reference with JAX on the CPU).

The command-line runs go through subprocesses, all started together by one
module fixture: the two sjcount benches, the two dry runs, the port's
sharded dry run, the port's sweep, and each port entry point without
`--device cpu`, which must exit non-zero and print no result line on a
machine without a card.
"""

import hashlib
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from lr2rmats_tpu.align.batch import BatchAligner as RefBatchAligner
from lr2rmats_tpu_torch import bench as port_bench
from lr2rmats_tpu_torch import synth
from lr2rmats_tpu_torch.align.batch import TorchBatchAligner
from lr2rmats_tpu_torch.scripts import ont_accuracy_sweep as port_sweep
from tests.test_torch_chain import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_host import reference_native_library

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
RECORDS = ("ONT_ACCURACY.json", "GRCH38_DRYRUN.json")
SJ_ARGS = ["--reads", "20000", "--genome-mb", "2", "--genes", "50",
           "--batch", "5000"]
DRYRUN_ENV = {"DRYRUN_CHROMS": "3", "DRYRUN_CHROM_MB": "2",
              "DRYRUN_READS": "300"}
SWEEP_ENV = {"SWEEP_READS": "300", "SWEEP_GENOME_MB": "2"}
ENTRY_POINTS = ("lr2rmats_tpu_torch.bench",
                "lr2rmats_tpu_torch.scripts.ont_accuracy_sweep",
                "lr2rmats_tpu_torch.scripts.bench_sjcount",
                "lr2rmats_tpu_torch.scripts.dryrun_grch38",
                "lr2rmats_tpu_torch.scripts.calibrate_mapq",
                "lr2rmats_tpu_torch.scripts.analyze_ont_failures",
                "lr2rmats_tpu_torch.scripts.bench_scaling_throughput")


@pytest.fixture(scope="module", autouse=True)
def both_native_libraries():
    """Both packages run their native paths, each through its own loader."""
    with pytest.MonkeyPatch.context() as mp:
        reference_native_library(mp)
        yield


def _load_reference_script(name, path=None):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", path or REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _records_state():
    out = {}
    for name in RECORDS:
        p = REPO / name
        out[name] = (p.stat().st_mtime_ns,
                     hashlib.sha256(p.read_bytes()).hexdigest())
    return out


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of this file, started together; name -> (rc,
    stdout, its working directory).  Also the state of the recorded JSON
    files before and after."""
    root = tmp_path_factory.mktemp("entry")
    base = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO),
            "LR2RMATS_THREADS": "2", "OMP_NUM_THREADS": "1"}
    py = sys.executable
    port_sj = ["-m", "lr2rmats_tpu_torch.scripts.bench_sjcount"]
    port_dry = ["-m", "lr2rmats_tpu_torch.scripts.dryrun_grch38"]
    jobs = {
        "ref_sj": ([py, str(REPO / "scripts" / "bench_sjcount.py"),
                    *SJ_ARGS], {}),
        "port_sj": ([py, *port_sj, *SJ_ARGS, "--device", "cpu", "--check"],
                    {}),
        "ref_dry": ([py, str(REPO / "scripts" / "dryrun_grch38.py")],
                    DRYRUN_ENV),
        "port_dry": ([py, *port_dry, "--device", "cpu", "--out",
                      "out/dry.json"], DRYRUN_ENV),
        "port_dry_shards": ([py, *port_dry, "--device", "cpu", "--shards",
                             "2"], DRYRUN_ENV),
        "port_sweep": ([py, "-m",
                        "lr2rmats_tpu_torch.scripts.ont_accuracy_sweep",
                        "--device", "cpu", "--out", "out/sweep.json"],
                       SWEEP_ENV),
        **{f"nocard_{m}": ([py, "-m", m], {"CUDA_VISIBLE_DEVICES": ""})
           for m in ENTRY_POINTS},
    }
    before = _records_state()
    procs = {}
    for name, (cmd, env) in jobs.items():
        cwd = root / name
        (cwd / "out").mkdir(parents=True)
        procs[name] = (subprocess.Popen(
            cmd, cwd=cwd, env={**base, **env}, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE), cwd)
    out = {}
    for name, (p, cwd) in procs.items():
        so, se = p.communicate(timeout=600)
        out[name] = (p.returncode, so, se, cwd)
    return out, before, _records_state()


def _line(runs, name):
    rc, so, se, _ = runs[0][name]
    assert rc == 0, se[-3000:]
    return _json_lines(so)[-1]


# ------------------------------------------------------------------- bench
@pytest.mark.parametrize("profile", ["ont", None], ids=["ont", "clean"])
def test_bench_measure_matches_reference(profile):
    """The port's measurement on TorchBatchAligner(device="cpu") against
    bench._measure on the reference's BatchAligner: the same SAM bytes and
    the same accuracy triple."""
    rng = np.random.default_rng(port_bench.SEED)
    genome = bench.build_genome(int(1e6), rng)
    reads, truths = bench.simulate_reads(genome, 256, rng, profile=profile)
    names = [f"read{i}" for i in range(len(reads))]
    ref = RefBatchAligner(genome)
    got = []
    inner = ref.align_seqset_packed
    ref.align_seqset_packed = lambda s: got.append(inner(s)) or got[-1]
    _, _, ref_arm = bench._measure(ref, bench._pack(reads, names), names,
                                   truths, 1, "ref")
    ref_sam = got[-1].emit_sam(ref.refs)

    pgenome, preads, ptruths, pnames = port_bench.workload(1.0, 256, profile)
    assert pnames == names
    al = TorchBatchAligner(pgenome, device="cpu")
    _, sam, acc, arm = port_bench.measure(
        al, synth.pack_seqset(preads, pnames), ptruths, 1, "port", CPU)
    assert sam == ref_sam
    for key in ("aligned_frac", "exact_exon_chain_frac",
                "splice_site_recall"):
        assert arm[key] == ref_arm[key], key
    assert acc["exact"] == round(arm["exact_exon_chain_frac"] * 256)


def test_bench_main_on_cpu(monkeypatch, capsys):
    """`main --device cpu` prints one line: the CPU metric, every pass's
    wall, the host guard passed, and the clean arm."""
    for k, v in {"BENCH_GENOME_MB": "1", "BENCH_READS": "256",
                 "BENCH_REPEATS": "2"}.items():
        monkeypatch.setenv(k, v)
    for k in ("BENCH_SKIP_CLEAN", "BENCH_PROFILE", "BENCH_ERR_PROFILE"):
        monkeypatch.delenv(k, raising=False)
    assert port_bench.main(["--device", "cpu"]) == 0
    lines = _json_lines(capsys.readouterr().out)
    assert len(lines) == 1
    line = lines[0]
    d = line["detail"]
    assert line["metric"] == "long_reads_aligned_per_sec_on_cpu"
    assert d["platform"] == "cpu" and d["card"] is None
    assert len(d["repeat_walls_s"]) == 2
    assert line["value"] == 256 / min(d["repeat_walls_s"])
    assert d["sam_identical_to_host_backend"]
    assert d["clean"]["n_reads"] == 512
    assert d["clean_exact_exon_chain_frac"] == 1.0
    assert d["idle_share"] is None and d["peak_device_mb"] is None


def test_bench_guard_refuses_a_differing_sam():
    """A card-path SAM that differs from the host backend's raises
    GuardError instead of giving a number."""
    from lr2rmats_tpu_torch.diag.measure import GuardError
    genome, reads, truths, names = port_bench.workload(0.5, 64, "ont")
    al = TorchBatchAligner(genome, device="cpu")
    seqset = synth.pack_seqset(reads, names)
    _, sam, acc, _ = port_bench.measure(al, seqset, truths, 1, "t", CPU)
    port_bench.host_guard(al, seqset, sam, acc, truths, "t")
    with pytest.raises(GuardError, match="SAM differs"):
        port_bench.host_guard(al, seqset, sam.replace(b"\t", b" ", 1), acc,
                              truths, "t")
    with pytest.raises(GuardError, match="accuracy"):
        port_bench.host_guard(al, seqset, sam, {**acc, "exact": -1}, truths,
                              "t")


# ------------------------------------------------------------------- sweep
@pytest.mark.parametrize("seed", [123, 124])
def test_sweep_one_seed_matches_reference(monkeypatch, seed):
    ref = _load_reference_script("ont_accuracy_sweep")
    monkeypatch.setattr(ref, "N_READS", 300)
    monkeypatch.setattr(ref, "GENOME_MB", 2.0)
    want = ref.one_seed(seed)
    got = port_sweep.one_seed(seed, "cpu", 300, 2.0)
    for key in ("exact_exon_chain_frac", "splice_site_recall",
                "aligned_frac"):
        assert got[key] == want[key], key
    assert got["sam_identical_to_host_backend"]


def test_sweep_compares_only_at_the_recorded_size():
    want = port_sweep.expected(port_sweep.EXPECT, 1500, 20.0)
    assert want[123] == (0.9993, 0.9998) and want[127] == (0.998, 0.9994)
    assert port_sweep.expected(port_sweep.EXPECT, 300, 2.0) is None


# ------------------------------------------------------------ command lines
def test_bench_sjcount_matches_reference(runs):
    ref, port = _line(runs, "ref_sj"), _line(runs, "port_sj")
    for key in ("junction_recall", "uniq_counts_total", "junctions"):
        assert port["detail"][key] == ref["detail"][key], key
    assert port["detail"]["backend"] == "device"
    assert port["detail"]["checked_against_host"]


def test_dryrun_matches_reference(runs):
    ref, port = _line(runs, "ref_dry"), _line(runs, "port_dry")
    for key in ("minimizers_m", "aligned_frac", "exact_exon_chain_frac",
                "n_reads"):
        assert port[key] == ref[key], key
    assert port["sam_identical_to_host_backend"]
    assert port["seed_lookup_calls"] > 0
    assert port["seed_lookup_queries_checked"] > 0


def test_dryrun_sharded_arm_equals_its_host_backend(runs):
    single, sharded = _line(runs, "port_dry"), _line(runs, "port_dry_shards")
    assert sharded["n_shards"] == 2
    assert sharded["n_reads_total"] == single["n_reads"]
    assert all(p["records_identical_to_host_backend"]
               for p in sharded["per_process"])
    assert sharded["aligned_frac"] == single["aligned_frac"]


@pytest.mark.parametrize("name,out", [("port_sweep", "sweep.json"),
                                      ("port_dry", "dry.json")])
def test_writes_only_under_out(runs, name, out):
    """The sweep and the dry run write their --out and nothing else: the
    recorded JSON files are untouched and the working directory holds only
    the --out file."""
    results, before, after = runs
    rc, so, se, cwd = results[name]
    assert rc == 0, se[-3000:]
    assert before == after
    files = sorted(str(p.relative_to(cwd)) for p in cwd.rglob("*")
                   if p.is_file())
    assert files == [f"out/{out}"]
    doc = json.loads((cwd / "out" / out).read_text())
    assert _json_lines(so) == [doc]
    assert doc["platform"] == "cpu"
    if name == "port_sweep":
        assert [r["seed"] for r in doc["per_seed"]] == list(
            port_sweep.SEEDS)
        assert doc["equal_to_recorded"] is None


@pytest.mark.parametrize("module", ENTRY_POINTS)
def test_entry_point_refuses_without_a_card(runs, module):
    """Without a card and without --device cpu: a non-zero exit and no
    result line (no fallback to the CPU)."""
    rc, so, se, _ = runs[0][f"nocard_{module}"]
    assert rc != 0
    assert _json_lines(so) == []
    assert "torch.cuda.is_available() is false" in se
