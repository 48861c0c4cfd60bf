"""Multi-process scaling of the pipeline at 500k long reads, on the card.

The counterpart of scripts/bench_scaling_throughput.py.  Run from the
repository root:

    python -m lr2rmats_tpu_torch.scripts.bench_scaling_throughput \\
        [--sim DIR] [--work DIR] [--procs 1,2,4] [--pin-cores N] [--out F]
    python -m lr2rmats_tpu_torch.scripts.bench_scaling_throughput \\
        --device cpu --procs 1

The data is the reference's config-3 analog (scripts/simulate.py
--genome-mb 45 --genes 1500 --long-reads 500000 --short-pairs 200000,
seed 7), written by `synth.simulate_dataset` into `--sim` when that
directory holds no `long.fa`.  Its long reads are split into 4 contiguous
samples, each with all the short pairs, and the count-prefixed lists name
them (the reference's `split_samples`).  Before the first arm this process
builds the minimizer index (the cache next to the FASTA that every `run`
loads) and, on the card, the kernel library, so that neither is inside an
arm's wall; both times are reported apart.

Each arm of `--procs` runs `python -m lr2rmats_tpu_torch run` as users run
it: one process, or N processes of one process group (`--coordinator` at a
free localhost port) that share the one card, with their payloads over
gloo; `--device cpu` runs the same arms with `run --cpu`.  `--pin-cores N`
gives process p the cores pN..pN+N-1 (taskset) and LR2RMATS_THREADS=N.
Per arm: the wall, reads/s, efficiency against the smallest arm
(reads/s over its reads/s times the process ratio), and per process its
wall, its kernel launches (all of them, and its alignment's alone: the
aligner's warm-up launches every shape once) and peak card memory (from
its log), its peak host RSS (wait4), its stage walls (its files under
benchmark/) and what of its wall no stage covers (`outside_stages`).

The guard: every file of every arm's output/ must be byte-equal to the
first arm's (the file list too); a difference raises GuardError and exits
1, as does a failed process.  Prints one JSON line naming the card
(nvidia-smi's name and power limit), also to `--out` when one is given; it
never writes SCALING.json.  Without a card and without --device cpu it
exits 2 and prints no result line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
N_SAMPLES = 4
# the reference's config-3 analog (scripts/simulate.py flags)
SIM = dict(genome_mb=45.0, genes=1500, long_reads=500_000,
           short_pairs=200_000, seed=7)
ARM_TIMEOUT_S = 3600


def split_samples(sim: str, work: str):
    """Contiguous N_SAMPLES-way split of long.fa, the same short pair for
    every sample; returns (long list, short list, long reads)."""
    os.makedirs(work, exist_ok=True)
    marker = os.path.join(work, ".split_done")
    paths = [os.path.join(work, f"long_s{i}.fa") for i in range(N_SAMPLES)]
    if not os.path.exists(marker):
        n = 0
        with open(os.path.join(sim, "long.fa")) as f:
            for line in f:
                n += line.startswith(">")
        per = -(-n // N_SAMPLES)
        outs = [open(p, "w") for p in paths]
        k = -1
        with open(os.path.join(sim, "long.fa")) as f:
            for line in f:
                if line.startswith(">"):
                    k += 1
                outs[min(k // per, N_SAMPLES - 1)].write(line)
        for o in outs:
            o.close()
        with open(marker, "w") as f:
            f.write(f"{n}\n")
    with open(marker) as f:
        n_reads = int(f.read().split()[0])
    long_list = os.path.join(work, "long.list")
    short_list = os.path.join(work, "short.list")
    with open(long_list, "w") as f:
        f.write(f"{N_SAMPLES}\n")
        for p in paths:
            f.write(f"1\n{p}\n")
    with open(short_list, "w") as f:
        f.write(f"{N_SAMPLES}\n")
        for _ in paths:
            f.write(f"1\n{sim}/short_1.fa {sim}/short_2.fa\n")
    return long_list, short_list, n_reads


def log_launches(path: str) -> dict:
    """The kernel launches a pipeline process logged."""
    with open(path) as f:
        for ln in f:
            if "kernel launches {" in ln:
                return json.loads(ln[ln.index("{"):])
    raise ValueError(f"{path}: no kernel launch line")


def log_align_launches(path: str) -> dict:
    """The launches of a pipeline process's alignment alone (its
    aligner's counts after its last sample; the warm-up's launches are
    not among them)."""
    last = None
    with open(path) as f:
        for ln in f:
            if "; kernel launches chain=" in ln:
                last = ln
    if last is None:
        raise ValueError(f"{path}: no alignment line")
    words = last.split("kernel launches ")[1].split(";")[0].split()
    return {k: int(v) for k, v in (w.split("=") for w in words)}


def log_peak_card_mb(path: str) -> Optional[float]:
    """The peak card memory (MB) a pipeline process logged; None on the
    CPU."""
    with open(path) as f:
        for ln in f:
            if "peak card memory" in ln:
                return float(ln.split("peak card memory")[1].split()[0])
    return None


def stage_walls(out: str, nproc: int) -> List[Dict[str, float]]:
    """Per process, wall seconds of each of its benchmark/ files: the
    `.p{pid}` files, the files of the samples it owns (round-robin) and,
    for process 0, the final merge."""
    per: List[Dict[str, float]] = [{} for _ in range(nproc)]
    bdir = os.path.join(out, "benchmark")
    for f in sorted(os.listdir(bdir)):
        name = f.replace(".benchmark.txt", "")
        own = re.fullmatch(r".*\.p(\d+)", name)
        sample = re.match(r"samp(\d+)[._]", name)
        pid = (int(own.group(1)) if own else
               (int(sample.group(1)) - 1) % nproc if sample else 0)
        with open(os.path.join(bdir, f)) as fh:
            per[pid][name] = float(fh.read().splitlines()[1].split()[0])
    return per


def outside_stages(wall: float, walls: Dict[str, float]) -> float:
    """A process's wall less its alignments (one sample after another),
    its longest per-sample chain of later stages (the samples run side by
    side) and the final merge: its start-up, its waits on the group and
    whatever else no stage times."""
    align = sum(v for n, v in walls.items() if n.endswith(".minimap"))
    chains: Dict[str, float] = {}
    for n, v in walls.items():
        sample = re.match(r"(samp\d+)[._]", n)
        if sample and not n.endswith(".minimap"):
            chains[sample.group(1)] = chains.get(sample.group(1), 0.0) + v
    return (wall - align - max(chains.values(), default=0.0)
            - walls.get("update_gtf", 0.0))


def _wait_all(procs, deadline: float, err_dir: str):
    """wait4 each process of `procs` as it ends; returns per process (end
    time, peak RSS MB).  Kills the rest and raises GuardError when one
    fails or the deadline passes."""
    from ..diag.measure import GuardError
    done = [None] * len(procs)
    try:
        while None in done:
            if time.monotonic() > deadline:
                raise GuardError("an arm passed its time limit")
            for i, p in enumerate(procs):
                if done[i] is not None:
                    continue
                pid, status, ru = os.wait4(p.pid, os.WNOHANG)
                if pid == 0:
                    continue
                p.returncode = os.waitstatus_to_exitcode(status)
                done[i] = (time.perf_counter(), ru.ru_maxrss / 1024.0)
                if p.returncode != 0:
                    raise GuardError(
                        f"pipeline process {i} exited {p.returncode}; see "
                        f"{err_dir}/stderr.p{i}.txt")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.returncode is None:
                p.kill()
                p.wait()
    return done


def run_arm(sim: str, long_list: str, short_list: str, out_dir: str,
            nproc: int, device: str, pin: int = 0,
            timeout: float = ARM_TIMEOUT_S) -> dict:
    """One arm: `nproc` processes of `python -m lr2rmats_tpu_torch run`
    (one group when nproc > 1), all started together.  Returns the arm's
    wall and per-process detail."""
    from ..parallel.distributed import free_port
    env = {**os.environ, "PYTHONPATH": REPO}
    if pin:
        env["LR2RMATS_THREADS"] = str(pin)
    base = [sys.executable, "-m", "lr2rmats_tpu_torch", "run",
            "--genome", f"{sim}/genome.fa", "--gtf", f"{sim}/anno.gtf",
            "--long-read-list", long_list, "--short-read-list", short_list,
            "--out-dir", out_dir]
    if device == "cpu":
        base.append("--cpu")
    coord = f"127.0.0.1:{free_port()}"
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    t0 = time.perf_counter()
    for pid in range(nproc):
        cmd = list(base)
        if nproc > 1:
            cmd += ["--coordinator", coord, "--num-processes", str(nproc),
                    "--process-id", str(pid)]
        if pin:
            cores = ",".join(str(c) for c in range(pid * pin,
                                                   (pid + 1) * pin))
            cmd = ["taskset", "-c", cores] + cmd
        err = open(os.path.join(out_dir, f"stderr.p{pid}.txt"), "w")
        with err:
            procs.append(subprocess.Popen(cmd, env=env, cwd=REPO,
                                          stdout=subprocess.DEVNULL,
                                          stderr=err))
    done = _wait_all(procs, time.monotonic() + timeout, out_dir)
    wall = time.perf_counter() - t0
    logs = [os.path.join(out_dir, "logs", f"pipeline.p{pid}.log"
                         if nproc > 1 else "pipeline.log")
            for pid in range(nproc)]
    walls = stage_walls(out_dir, nproc)
    per = []
    for pid, (end, rss) in enumerate(done):
        per.append({"wall_s": end - t0,
                    "outside_stages_s": outside_stages(end - t0, walls[pid]),
                    "peak_rss_mb": rss,
                    "launches": log_launches(logs[pid]),
                    "align_launches": log_align_launches(logs[pid]),
                    "peak_card_mb": log_peak_card_mb(logs[pid]),
                    "stage_walls_s": walls[pid]})
    return {"wall_s": wall, "processes": per}


def output_files(out_dir: str) -> Dict[str, bytes]:
    d = os.path.join(out_dir, "output")
    files = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            files[f] = fh.read()
    return files


def prepare(sim: str, work: str, device: str) -> dict:
    """Generate the data when `sim` holds none, split it, build the index
    cache and (on the card) the kernel library.  Returns the lists, the
    read count and the set-up seconds."""
    from .. import synth
    from ..index.minimizer import MinimizerIndex
    from ..io.fasta import Genome
    setup = {}
    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(sim, "long.fa")):
        print("[scaling] " + synth.simulate_dataset(sim, **SIM),
              file=sys.stderr, flush=True)
    setup["dataset_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    long_list, short_list, n_reads = split_samples(sim, work)
    setup["split_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fasta = os.path.join(sim, "genome.fa")
    MinimizerIndex.build_or_load(Genome.load(fasta), fasta + ".tmmi.npz")
    setup["index_s"] = time.perf_counter() - t0
    setup["kernel_build_s"] = None
    if device == "cuda":
        from ..ops import _build
        _build.load()
        setup["kernel_build_s"] = float(_build.build_info.get("build_s",
                                                               0.0))
    return {"long_list": long_list, "short_list": short_list,
            "n_reads": n_reads, "setup_s": setup}


def run_arms(sim: str, work: str, procs: List[int], device: str = "cuda",
             pin: int = 0) -> dict:
    """Every arm in turn on the prepared data; raises GuardError unless
    every arm's output/ equals the first arm's.  Returns the result."""
    from ..diag.measure import GuardError
    prep = prepare(sim, work, device)
    n_reads = prep["n_reads"]
    print(f"[scaling] {n_reads} long reads over {N_SAMPLES} samples",
          file=sys.stderr, flush=True)
    arms, ref = {}, None
    for nproc in procs:
        out_dir = os.path.join(work, f"out_{device}_p{nproc}")
        shutil.rmtree(out_dir, ignore_errors=True)
        arm = run_arm(sim, prep["long_list"], prep["short_list"], out_dir,
                      nproc, device, pin)
        files = output_files(out_dir)
        if ref is None:
            ref = (nproc, files)
        elif files != ref[1]:
            diff = sorted(k for k in set(files) | set(ref[1])
                          if files.get(k) != ref[1].get(k))
            raise GuardError(f"{nproc}-process arm: output/ differs from "
                             f"the {ref[0]}-process arm's: {diff}")
        arm["reads_per_s"] = n_reads / arm["wall_s"]
        arms[nproc] = arm
        print(f"[scaling] {device} nproc={nproc} wall={arm['wall_s']:.1f}s "
              f"rps={arm['reads_per_s']:.0f} output/ identical",
              file=sys.stderr, flush=True)
    base = min(arms)
    for nproc, a in arms.items():
        a["efficiency_vs_1proc"] = a["reads_per_s"] / (
            arms[base]["reads_per_s"] * nproc / base)
    return {"n_reads": n_reads, "n_samples": N_SAMPLES,
            "setup_s": prep["setup_s"],
            "arms": {str(k): v for k, v in arms.items()},
            "output_files": sorted(ref[1]),
            "outputs_identical_across_arms": True}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu (every arm "
                         "runs `run --cpu`)")
    ap.add_argument("--sim", default=os.path.join(REPO, "build", "scaling",
                                                  "sim500k"),
                    help="the dataset directory (generated when it holds "
                         "no long.fa)")
    ap.add_argument("--work", default=os.path.join(REPO, "build", "scaling",
                                                   "work"),
                    help="the samples, lists and each arm's out dir")
    ap.add_argument("--procs", default="1,2,4")
    ap.add_argument("--pin-cores", type=int, default=0, metavar="N",
                    help="give every process its own N cores (taskset) "
                         "and an N-thread pool; procs x N must not exceed "
                         "the machine's cores")
    ap.add_argument("--out", help="write the result JSON here")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    from ..diag.measure import GuardError, device_detail
    from ..utils import default_threads
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench_scaling_throughput: {e}", file=sys.stderr)
        return 2
    sim, work = os.path.abspath(args.sim), os.path.abspath(args.work)
    try:
        res = run_arms(sim, work, [int(x) for x in args.procs.split(",")],
                       dev.type, args.pin_cores)
    except GuardError as e:
        print(f"bench_scaling_throughput: guard failed: {e}",
              file=sys.stderr)
        return 1
    out = {"metric": ("multiprocess_scaling_pinned" if args.pin_cores
                      else "multiprocess_scaling"), **device_detail(dev),
           "cores": os.cpu_count(), "pin_cores": args.pin_cores,
           "lr2rmats_threads": args.pin_cores or default_threads(),
           **res}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
