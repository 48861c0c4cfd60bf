"""Cost of the process group's byte-payload all-gather: host code only.

The counterpart of scripts/bench_gather.py.  Run from the repository
root:

    python -m lr2rmats_tpu_torch.scripts.bench_gather [--mb 40] [--out F]

Two processes join one gloo group (`parallel/distributed.py`
`init_multihost`, at a free localhost port) and call `gather_blobs`, the
all-gather that carries the pipeline's pass-2 GTFs, on the reference's
payloads: a tiny warm-up; a fixed width of MB (40) MiB of random bytes
(seeded by the process id), its first call and five repeats; five widths
shrinking by 8191 bytes a call; and 1 MiB five times.  The guard: every
gathered list must equal every process's payload, in process order; a
difference exits 1.

The payloads are CPU tensors over gloo in every configuration of the port
(the pipeline's collectives never touch the card), so this entry point
needs no card.  Its line names the card (nvidia-smi's name and power limit)
when the machine has one, and the host's core count.  Prints one JSON line
(process 0's timings), also to `--out` when one is given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

N_PROCS = 2
REPEATS = 5
SHRINK = 8191
TIMEOUT_S = 600
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def payload(pid: int, n_bytes: int) -> bytes:
    """Process `pid`'s fixed-width payload."""
    rng = np.random.default_rng(pid)
    return rng.integers(0, 255, n_bytes, dtype=np.uint8).tobytes()


def worker(pid: int, nproc: int, coordinator: str, mb: float) -> dict:
    """One process of the group: every gather of the run, each checked;
    raises GuardError on a differing list.  Returns the timings."""
    from ..diag.measure import GuardError
    from ..parallel.distributed import (end_multihost, gather_blobs,
                                        init_multihost)
    init_multihost(coordinator, nproc, pid)
    n_bytes = int(mb * (1 << 20))
    blobs = [payload(p, n_bytes) for p in range(nproc)]

    def gather(cut: int, tag: str) -> float:
        t0 = time.perf_counter()
        got = gather_blobs(blobs[pid][:cut])
        wall = time.perf_counter() - t0
        if got != [b[:cut] for b in blobs]:
            raise GuardError(f"process {pid}: the {tag} gather of {cut} "
                             "bytes differs from the payloads sent")
        return wall

    out = {}
    t0 = time.perf_counter()
    if gather_blobs(b"x") != [b"x"] * nproc:
        raise GuardError(f"process {pid}: the warm-up gather differs")
    out["warmup_s"] = time.perf_counter() - t0
    out["fixed_bytes"] = n_bytes
    out["fixed_first_s"] = gather(n_bytes, "first fixed")
    walls = [gather(n_bytes, "fixed") for _ in range(REPEATS)]
    out["fixed_repeat_s"] = walls
    out["fixed_mb_s"] = n_bytes / 2**20 * nproc / min(walls)
    out["vary_bytes"] = [n_bytes - SHRINK * (i + 1) for i in range(REPEATS)]
    out["vary_s"] = [gather(n, "shrinking") for n in out["vary_bytes"]]
    small = min(1 << 20, n_bytes)
    out["small_bytes"] = small
    out["small_1mb_s"] = [gather(small, "1 MiB") for _ in range(REPEATS)]
    end_multihost()
    return out


def run(mb: float = 40.0, nproc: int = N_PROCS,
        timeout: float = TIMEOUT_S) -> dict:
    """Start the group's processes at once and wait for all under one
    deadline; a failed process, or the deadline, kills the rest and
    raises GuardError.  Returns process 0's timings."""
    from ..diag.measure import GuardError
    from ..parallel.distributed import free_port
    coord = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", __spec__.name, "--worker", str(p),
         str(nproc), coord, "--mb", str(mb)],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for p in range(nproc)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1))
            if p.returncode != 0:
                raise GuardError(f"a gather process exited {p.returncode}: "
                                 + se[-3000:])
            outs.append(so)
    except subprocess.TimeoutExpired:
        raise GuardError(f"the gather processes passed {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return json.loads(outs[0].strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mb", type=float, default=40.0,
                    help="MiB of the fixed-width payload (default 40)")
    ap.add_argument("--out", help="write the result JSON here")
    ap.add_argument("--worker", nargs=3, metavar=("PID", "NPROC", "COORD"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from ..diag.measure import GuardError, host_detail
    try:
        if args.worker:
            pid, nproc, coord = args.worker
            res = worker(int(pid), int(nproc), coord, args.mb)
            print(json.dumps(res), flush=True)
            return 0
        res = run(args.mb)
    except GuardError as e:
        print(f"bench_gather: guard failed: {e}", file=sys.stderr)
        return 1
    out = {"metric": "gather_blobs_walls", **host_detail(),
           "processes": N_PROCS, "backend": "gloo", **res,
           "gathered_lists_identical": True}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
