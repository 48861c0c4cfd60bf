"""Port process group (lr2rmats_tpu_torch/parallel/distributed.py) and the
multi-process pipeline against the reference.

Multi-process cases run real gloo groups of subprocesses on the CPU, each
group at a free port of its own (the suite runs files in parallel), every
process under a timeout, and the peers killed as soon as one fails, so a
hung rendezvous fails in seconds.  `run_group` is shared with
tests/test_torch_mesh.py and tests/test_torch_shard_index.py.
"""

import os
import pathlib
import socket
import subprocess
import sys
import time

import pytest

from lr2rmats_tpu.parallel import distributed as ref_dist
from lr2rmats_tpu_torch.parallel import distributed as port_dist
from tests.test_distributed import sim2  # noqa: F401 (fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def group_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # one thread each: the suite runs files in parallel, and some of its
    # tests time their batches
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", XLA_FLAGS="",
               OMP_NUM_THREADS="1", LR2RMATS_THREADS="1", **extra)
    return env


def run_group(cmds, env, timeout=240, cwd=REPO):
    """Start every command at once; wait for all under one deadline, and
    kill the rest as soon as one fails or the deadline passes.  Returns
    the (stdout, stderr) of each; raises AssertionError on any failure."""
    procs = [subprocess.Popen(c, env=env, cwd=str(cwd), text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for c in cmds]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate(timeout=30) for p in procs]
    for i, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"process {i} of {len(procs)} exited {p.returncode}:\n"
            f"{se[-3000:]}")
    return outs


@pytest.mark.parametrize("n,pid,nproc", [(5, 0, 2), (5, 1, 2), (3, 0, 1),
                                         (1, 1, 4), (0, 0, 3), (9, 2, 4)])
def test_owned_indices_match_reference(n, pid, nproc):
    assert port_dist.owned_indices(n, pid, nproc) == \
        ref_dist.owned_indices(n, pid, nproc)


def test_single_process_short_cuts():
    assert port_dist.multihost_info() == (0, 1)
    assert port_dist.owned_indices(3) == [0, 1, 2]
    assert port_dist.gather_blobs(b"abc") == [b"abc"]
    got = port_dist.gather_indexed_payloads([(3, b"x"), (0, b""),
                                             (7, b"yy")])
    assert got == {3: b"x", 0: b"", 7: b"yy"}
    port_dist.barrier("single")
    port_dist.init_multihost("127.0.0.1:1", 1, 0)   # no group for one
    port_dist.end_multihost()
    assert port_dist.multihost_info() == (0, 1)


_GATHER = r"""
import sys
from lr2rmats_tpu_torch.parallel import distributed as d
pid = int(sys.argv[1])
d.init_multihost(sys.argv[2], 2, pid)
assert d.multihost_info() == (pid, 2)
blob = [b"", b"\x07"][pid]
big = bytes(range(256)) * 20 + b"tail"          # 5124 bytes
got = d.gather_blobs(blob)
assert got == [b"", b"\x07"], got
got = d.gather_blobs([big, b""][pid])
assert got == [big, b""], [len(g) for g in got]
got = d.gather_indexed_payloads([[(0, big), (2, b"")], [(1, b"z")]][pid])
assert got == {0: big, 1: b"z", 2: b""}, sorted(got)
d.barrier("done")
d.end_multihost()
print("OK", pid)
"""


def test_two_process_gather_ragged(tmp_path):
    """Empty, one-byte and > 4096-byte payloads come back in process
    order on both processes."""
    script = tmp_path / "gather.py"
    script.write_text(_GATHER)
    coord = f"127.0.0.1:{free_port()}"
    outs = run_group([[sys.executable, str(script), str(pid), coord]
                      for pid in range(2)], group_env(), timeout=120)
    assert [so.split() for so, _ in outs] == [["OK", "0"], ["OK", "1"]]


def _run_cmd(package, sim, out_dir, extra=()):
    return [sys.executable, "-m", package, "run",
            "--genome", sim["genome"], "--gtf", sim["gtf"],
            "--long-read-list", sim["long_list"],
            "--short-read-list", sim["short_list"],
            "--out-dir", str(out_dir), "--cpu", *extra]


def test_two_process_pipeline_matches_reference(sim2, tmp_path):  # noqa: F811
    """`python -m lr2rmats_tpu_torch run --cpu` as a 2-process gloo group
    gives the reference single-process run's updated.gtf and per-sample
    outputs byte for byte; each process aligned its own sample, and both
    started with no index cache (built once under the lock)."""
    cache = pathlib.Path(sim2["genome"] + ".tmmi.npz")
    cache.unlink(missing_ok=True)
    port = tmp_path / "port"
    coord = f"127.0.0.1:{free_port()}"
    run_group([_run_cmd("lr2rmats_tpu_torch", sim2, port, (
        "--coordinator", coord, "--num-processes", "2",
        "--process-id", str(pid))) for pid in range(2)], group_env(),
        timeout=300)
    assert cache.exists()
    ref = tmp_path / "ref"
    run_group([_run_cmd("lr2rmats_tpu", sim2, ref)], group_env(),
              timeout=300)
    want = {f.name: f.read_bytes() for f in (ref / "output").iterdir()}
    got = {f.name: f.read_bytes() for f in (port / "output").iterdir()}
    assert sorted(got) == sorted(want) and len(want) == 15
    assert got == want
    assert b"\ttranscript\t" in want["updated.gtf"]
    logs = [(port / "logs" / f"pipeline.p{pid}.log").read_text()
            for pid in range(2)]
    for pid, samp in enumerate(("samp1", "samp2")):
        assert f"stage/align[{samp}]" in logs[pid]
        assert f"process {pid}/2 on cpu" in logs[pid]
        assert "gathered 2 pass-2 GTFs" in logs[pid]
        assert (port / "benchmark" / f"index.p{pid}.benchmark.txt").exists()
    assert "stage/final_merge" in logs[0]
    assert "stage/final_merge" not in logs[1]
    assert (port / "config.yaml").exists() == (ref / "config.yaml").exists()
    for samp in ("samp1", "samp2"):
        assert (port / "gtf" / f"{samp}_gtf_novel.gathered.gtf").exists()


def test_cli_needs_coordinator_and_process_id(tmp_path, capsys):
    from lr2rmats_tpu_torch.pipeline.cli import main
    rc = main(["run", "--cpu", "--num-processes", "2", "--coordinator",
               "127.0.0.1:1", "--out-dir", str(tmp_path)])
    assert rc == 1
    assert "needs --coordinator and --process-id" in capsys.readouterr().err
    assert port_dist.multihost_info() == (0, 1)

