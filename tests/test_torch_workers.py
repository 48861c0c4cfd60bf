"""The port's worker pools and allocator opt-out against the reference.

`align_seqset_packed` reads LR2RMATS_SEED_WORKERS and
LR2RMATS_BUILD_WORKERS as lr2rmats_tpu/align/batch.py does (default 1
each; the device junction backend keeps one build worker), and
`_tune_allocator` reads LR2RMATS_NO_MALLOPT as lr2rmats_tpu/__init__.py
does.  On the CPU, at every (seed, build) arm, the port's SAM must equal
its default run and the reference BatchAligner(backend="jax") under the
same environment; the counters that several threads add to (launch
counts, seed lookup calls, junction stats) must stay exact; and the
`LR2RMATS_*` names the port lacks must be exactly the reference's relay
and JAX settings, so that a knob dropped later fails here.
"""

import ctypes
import json
import pathlib
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

import bench
import lr2rmats_tpu_torch
from lr2rmats_tpu.align.batch import BatchAligner
from lr2rmats_tpu_torch.align.batch import TorchBatchAligner
from lr2rmats_tpu_torch.ops import _build
from tests.test_torch_chain import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
BATCH = 96                   # 512 reads: 6 spans, more than any pool here
WORKER_VARS = ("LR2RMATS_SEED_WORKERS", "LR2RMATS_BUILD_WORKERS")
SWITCHES = ("LR2RMATS_DEVICE_JUNCTIONS", "LR2RMATS_DEVICE_SEED")
# read by the reference only: its TPU relay (init probe, weather router,
# preflip, polish canary and its debug / host-DP escapes) and the JAX
# compilation cache
SETTLED = {"LR2RMATS_INIT_PROBE_S", "LR2RMATS_NO_INIT_PROBE",
           "LR2RMATS_NO_WEATHER_ROUTE", "LR2RMATS_PREFLIP_CALL_MS",
           "LR2RMATS_PREFLIP_D2H_MB_S", "LR2RMATS_POLISH_CANARY_S",
           "LR2RMATS_POLISH_DEBUG", "LR2RMATS_POLISH_HOST_DP",
           "LR2RMATS_JAX_CACHE"}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for v in WORKER_VARS + SWITCHES:
        monkeypatch.delenv(v, raising=False)


@pytest.fixture(scope="module")
def workload():
    """tests/test_torch_batch.py's bench_small: 512 ONT reads on 2 Mb."""
    rng = np.random.default_rng(123)
    g = bench.build_genome(2_000_000, rng)
    reads, _ = bench.simulate_reads(g, 512, rng, profile="ont")
    names = [f"read{i}" for i in range(len(reads))]
    return g, bench._pack(reads, names)


@pytest.fixture(scope="module")
def ref_aligner(workload):
    return BatchAligner(workload[0], backend="jax")


@pytest.fixture(scope="module")
def default_sam(workload, ref_aligner):
    """The port's SAM with every worker variable unset."""
    with pytest.MonkeyPatch.context() as mp:
        for v in WORKER_VARS + SWITCHES:
            mp.delenv(v, raising=False)
        port = TorchBatchAligner.from_jax_aligner(ref_aligner, device="cpu")
        return _sam(port, workload[1])


def _sam(aligner, seqset) -> bytes:
    return aligner.align_seqset_packed(seqset, batch_size=BATCH).emit_sam(
        aligner.refs)


def _n_spans(seqset) -> int:
    return -(-seqset.n // BATCH)


def _threads_of(monkeypatch, aligner, method: str) -> list:
    """Wrap aligner.<method> to record the thread of every call."""
    seen = []
    inner = getattr(aligner, method)

    def wrapped(*a, **k):
        seen.append(threading.current_thread().name)
        return inner(*a, **k)

    monkeypatch.setattr(aligner, method, wrapped)
    return seen


@pytest.mark.parametrize("n_seed,n_build",
                         [(1, 1), (2, 1), (1, 2), (2, 2), (3, 2)])
def test_worker_arms_match_default_and_reference(
        monkeypatch, workload, ref_aligner, default_sam, n_seed, n_build):
    _, seqset = workload
    monkeypatch.setenv("LR2RMATS_SEED_WORKERS", str(n_seed))
    monkeypatch.setenv("LR2RMATS_BUILD_WORKERS", str(n_build))
    port = TorchBatchAligner.from_jax_aligner(ref_aligner, device="cpu")
    seeds = _threads_of(monkeypatch, port, "_batch_anchors")
    builds = _threads_of(monkeypatch, port, "_build_packed")
    got = _sam(port, seqset)
    assert got == default_sam
    assert got == _sam(ref_aligner, seqset)
    n = _n_spans(seqset)
    assert len(seeds) == len(builds) == n
    # every pool ran its batches on at most its own number of threads
    assert len(set(seeds)) <= n_seed and len(set(builds)) <= n_build
    assert port.stats["anchors"] > 0 and port.stats["device_calls"] > 0


@pytest.mark.parametrize("stage", ["_batch_anchors", "_build_packed"])
def test_batches_keep_their_order(monkeypatch, workload, ref_aligner,
                                  default_sam, stage):
    """Early spans seed (or build) slowest, so later ones finish first; the
    RecordBatch still concatenates the batches in span order."""
    _, seqset = workload
    monkeypatch.setenv("LR2RMATS_SEED_WORKERS", "3")
    monkeypatch.setenv("LR2RMATS_BUILD_WORKERS", "3")
    port = TorchBatchAligner.from_jax_aligner(ref_aligner, device="cpu")
    n = _n_spans(seqset)
    span_of = {seqset.names[k * BATCH]: k for k in range(n)}
    done = []
    inner = getattr(port, stage)

    def slow_early(*a, **k):
        if stage == "_batch_anchors":
            k_span = next(s for name, s in span_of.items()
                          if np.array_equal(a[0][0],
                                            seqset.get(s * BATCH)))
        else:
            k_span = span_of[a[0][0]]            # names[0] of the batch
        time.sleep(0.15 * (n - k_span))
        out = inner(*a, **k)
        done.append(k_span)
        return out

    monkeypatch.setattr(port, stage, slow_early)
    assert _sam(port, seqset) == default_sam
    assert sorted(done) == list(range(n))
    assert done != sorted(done), "no later span finished first"


def test_device_junctions_keep_one_build_worker(monkeypatch, capsys,
                                                workload, ref_aligner):
    _, seqset = workload
    monkeypatch.setenv("LR2RMATS_DEVICE_JUNCTIONS", "1")
    one = TorchBatchAligner(workload[0], index=_port_index(ref_aligner),
                            device="cpu")
    want = _sam(one, seqset)
    monkeypatch.setenv("LR2RMATS_BUILD_WORKERS", "2")
    port = TorchBatchAligner(workload[0], index=one.index, device="cpu")
    assert port.junction_backend == "device"
    builds = _threads_of(monkeypatch, port, "_build_packed")
    capsys.readouterr()
    assert _sam(port, seqset) == want
    assert "LR2RMATS_BUILD_WORKERS>1 ignored" in capsys.readouterr().err
    assert len(builds) == _n_spans(seqset) and len(set(builds)) == 1
    for k in ("junction_calls", "junction_gaps", "junction_found",
              "junction_kernel_launches"):
        assert port.stats[k] == one.stats[k], k
    assert port.stats["junction_gaps"] > 0


def _port_index(ref_aligner):
    return TorchBatchAligner.from_jax_aligner(ref_aligner,
                                              device="cpu").index


def test_seed_lookup_calls_exact_with_two_seed_workers(
        monkeypatch, workload, ref_aligner, default_sam):
    _, seqset = workload
    monkeypatch.setenv("LR2RMATS_DEVICE_SEED", "1")
    monkeypatch.setenv("LR2RMATS_SEED_WORKERS", "2")
    port = TorchBatchAligner(workload[0], index=_port_index(ref_aligner),
                             device="cpu")
    assert port._seed_lookup is not None
    seeds = _threads_of(monkeypatch, port, "_batch_anchors")
    assert _sam(port, seqset) == default_sam
    st = port.stats
    assert st["seed_lookup_calls"] == port._seed_lookup.calls == \
        _n_spans(seqset)
    assert st["device_calls"] >= st["seed_lookup_calls"]
    assert len(set(seeds)) == 2


def test_seed_lookup_counts_each_thread(workload, ref_aligner):
    """thread_counts() holds the calling thread's lookups only; the totals
    add up over threads."""
    from lr2rmats_tpu_torch.index.seed_device import TorchSeedLookup
    tw = TorchSeedLookup(_port_index(ref_aligner), "cpu")
    h = np.arange(1000, dtype=np.uint64)
    got = {}

    def worker(k):
        for _ in range(k):
            tw.lookup(h)
        got[k] = tw.thread_counts()

    threads = [threading.Thread(target=worker, args=(k,)) for k in (3, 5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got[3][0] == 3 and got[5][0] == 5
    assert tw.calls == 8 and tw.thread_counts() == (0, 0.0)
    assert tw.wall_s == pytest.approx(got[3][1] + got[5][1])


@pytest.mark.parametrize("value", ["0", "-3"])
def test_seed_workers_below_one_mean_one(monkeypatch, workload, ref_aligner,
                                         default_sam, value):
    _, seqset = workload
    monkeypatch.setenv("LR2RMATS_SEED_WORKERS", value)
    monkeypatch.setenv("LR2RMATS_BUILD_WORKERS", value)
    port = TorchBatchAligner.from_jax_aligner(ref_aligner, device="cpu")
    seeds = _threads_of(monkeypatch, port, "_batch_anchors")
    builds = _threads_of(monkeypatch, port, "_build_packed")
    assert _sam(port, seqset) == default_sam
    assert len(set(seeds)) == len(set(builds)) == 1


@pytest.mark.parametrize("var", WORKER_VARS)
def test_non_integer_workers_raise_as_the_reference(monkeypatch, workload,
                                                    ref_aligner, var):
    _, seqset = workload
    monkeypatch.setenv(var, "x")
    port = TorchBatchAligner.from_jax_aligner(ref_aligner, device="cpu")
    with pytest.raises(ValueError):
        port.align_seqset_packed(seqset, batch_size=BATCH)
    with pytest.raises(ValueError):
        ref_aligner.align_seqset_packed(seqset, batch_size=BATCH)


@pytest.mark.parametrize("opt_out", [False, True])
def test_allocator_opt_out(monkeypatch, opt_out):
    calls = []

    class FakeLibc:
        def mallopt(self, param, value):
            calls.append((param, value))
            return 1

    monkeypatch.setattr(ctypes, "CDLL", lambda name: FakeLibc())
    if opt_out:
        monkeypatch.setenv("LR2RMATS_NO_MALLOPT", "1")
    else:
        monkeypatch.delenv("LR2RMATS_NO_MALLOPT", raising=False)
    lr2rmats_tpu_torch._tune_allocator()
    assert calls == ([] if opt_out else [(-3, 1 << 30), (-1, 1 << 30)])


def test_launch_counts_exact_under_threads():
    """Eight threads account 10000 junction launches each on card 0: the
    shared counts read exactly 80000 and each thread its own 10000.  A
    short switch interval makes the threads interleave mid-update."""
    saved = dict(_build.LAUNCHES), dict(_build.CARD_LAUNCHES)
    interval = sys.getswitchinterval()
    dev = torch.device("cuda", 0)
    mine = []

    def worker():
        n0 = _build.thread_launches("junction")
        for _ in range(10000):
            _build.launched("junction", 0, None, dev)
        mine.append(_build.thread_launches("junction") - n0)

    _build.reset_launches()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert _build.LAUNCHES["junction"] == 80000
        assert _build.CARD_LAUNCHES == {0: 80000}
        assert mine == [10000] * 8
    finally:
        sys.setswitchinterval(interval)
        _build.LAUNCHES.update(saved[0])
        _build.CARD_LAUNCHES.clear()
        _build.CARD_LAUNCHES.update(saved[1])


def test_refused_launch_counts_nothing():
    before = dict(_build.LAUNCHES), _build.thread_launches("junction")
    with pytest.raises(RuntimeError, match="junction failed to launch"):
        _build.launched("junction", 700, None, torch.device("cuda", 0))
    assert (dict(_build.LAUNCHES), _build.thread_launches("junction")) == \
        before


def _env_names(paths) -> set:
    pat = re.compile(r"LR2RMATS_[A-Z0-9_]+")
    return {m for p in paths for m in pat.findall(p.read_text())}


def test_port_reads_every_reference_knob():
    """The LR2RMATS_* names of the reference's source that the port's
    source (package and chip_smoke.py) lacks are exactly the settled
    relay and JAX names."""
    ref = _env_names((REPO / "lr2rmats_tpu").rglob("*.py"))
    port = _env_names([*(REPO / "lr2rmats_tpu_torch").rglob("*.py"),
                       REPO / "chip_smoke.py"])
    assert ref - port == SETTLED
    for knob in ("LR2RMATS_SEED_WORKERS", "LR2RMATS_BUILD_WORKERS",
                 "LR2RMATS_NO_MALLOPT"):
        assert knob in port


def test_env_arms_sets_removes_and_fails_as_the_run(monkeypatch, capsys):
    """scripts/env_arms.py: each run gets its arm's variables (VAR= removes
    one), its fields come from its last JSON line, and a failing run ends
    the script with its exit code and no result line."""
    from lr2rmats_tpu_torch.scripts import env_arms
    monkeypatch.setenv("Y", "kept")
    monkeypatch.delenv("X", raising=False)
    show = ("import json, os; print('noise'); print(json.dumps({'x': "
            "os.environ.get('X'), 'y': os.environ.get('Y'), 'n': [1, 2]}))")
    rc = env_arms.main(["--arm", "on=X=1,Y=", "--arm", "off=",
                        "--order", "on,off,on", "--field", "x",
                        "--field", "y", "--field", "n.1", "--",
                        sys.executable, "-c", show])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["order"] == ["on", "off", "on"]
    on, off = res["arms"]["on"], res["arms"]["off"]
    assert [(r["run"], r["x"], r["y"], r["n.1"]) for r in on["runs"]] == \
        [(1, "1", None, 2), (3, "1", None, 2)]
    assert [(r["x"], r["y"]) for r in off["runs"]] == [(None, "kept")]
    assert on["summary"]["n.1"] == {"min": 2, "median": 2, "max": 2}
    rc = env_arms.main(["--arm", "a=", "--order", "a", "--", sys.executable,
                        "-c", "import sys; sys.exit(3)"])
    assert rc == 3 and capsys.readouterr().out == ""


def test_env_arms_alternates_the_bench_worker_arms(monkeypatch, capsys,
                                                   tmp_path):
    """The bench on the CPU at a small size under the one- and two-worker
    arms: each run's guard (SAM equal to the host backend) passes and the
    SAM is the same size in both arms."""
    from lr2rmats_tpu_torch.scripts import env_arms
    for k, v in {"BENCH_GENOME_MB": "1", "BENCH_READS": "256",
                 "BENCH_REPEATS": "1", "BENCH_SKIP_CLEAN": "1",
                 "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(REPO)
    out = tmp_path / "arms.json"
    rc = env_arms.main([
        "--arm", "11=LR2RMATS_SEED_WORKERS=1,LR2RMATS_BUILD_WORKERS=1",
        "--arm", "22=LR2RMATS_SEED_WORKERS=2,LR2RMATS_BUILD_WORKERS=2",
        "--order", "11,22", "--field", "value",
        "--field", "detail.sam_bytes",
        "--field", "detail.sam_identical_to_host_backend",
        "--out", str(out), "--", sys.executable, "-m",
        "lr2rmats_tpu_torch.bench", "--device", "cpu"])
    assert rc == 0
    res = json.loads(out.read_text())
    assert res == json.loads(capsys.readouterr().out.strip()
                             .splitlines()[-1])
    (a,), (b,) = (res["arms"][k]["runs"] for k in ("11", "22"))
    assert a["value"] > 0 and b["value"] > 0
    assert a["detail.sam_identical_to_host_backend"] is True
    assert b["detail.sam_identical_to_host_backend"] is True
    assert a["detail.sam_bytes"] == b["detail.sam_bytes"] > 0
