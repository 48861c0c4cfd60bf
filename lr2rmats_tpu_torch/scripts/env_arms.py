"""Arms of environment variables, alternated over one command in one call.

Run from the repository root:

    python -m lr2rmats_tpu_torch.scripts.env_arms \\
        --arm 11=LR2RMATS_SEED_WORKERS=1,LR2RMATS_BUILD_WORKERS=1 \\
        --arm 21=LR2RMATS_SEED_WORKERS=2,LR2RMATS_BUILD_WORKERS=1 \\
        --order 11,21,21,11 --field value \\
        --field detail.host_phases_s.seed [--logs DIR] [--out F] \\
        -- python -m lr2rmats_tpu_torch.bench

Walls of one entry point move between calls with the host (PERF.md §7), so
arms are compared within one call, their runs alternated.  Each name of
`--order` runs the command once, in this process's environment plus that
arm's variables (an arm `NAME=` with nothing after the sign adds none; a
variable set to nothing, `VAR=`, is removed).  The command's last line of
standard output must be one JSON object; a run that exits non-zero ends
the script with that code and no result line (a failed guard is not a
slower number).  Each `--field` is a dotted path into that object (a
number indexes a list).

Prints one JSON line: the host (nvidia-smi's name and power limit of the
card, when there is one, and the core count), the command, the order, and
per arm its variables, each run's wall on the host clock and fields, and
per numeric field its min, median and max over the arm's runs; also to
`--out` when one is given.  `--logs DIR` keeps each run's standard error
and full standard output there.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional


class RunFailed(Exception):
    """A run exited non-zero; `rc` is its exit code."""

    def __init__(self, rc: int):
        super().__init__(f"exit code {rc}")
        self.rc = rc


def parse_arm(text: str):
    """"NAME=VAR=VAL,VAR=VAL" -> (NAME, {VAR: VAL})."""
    name, sep, rest = text.partition("=")
    if not name or not sep:
        raise ValueError(f"--arm must be NAME=VAR=VAL[,VAR=VAL], got "
                         f"{text!r}")
    env = {}
    for item in filter(None, rest.split(",")):
        var, sep, val = item.partition("=")
        if not var or not sep:
            raise ValueError(f"--arm {name}: {item!r} is not VAR=VAL")
        env[var] = val
    return name, env


def field(obj, path: str):
    """obj at a dotted path; a number indexes a list; None when absent."""
    for key in path.split("."):
        if isinstance(obj, list) and key.lstrip("-").isdigit():
            i = int(key)
            obj = obj[i] if -len(obj) <= i < len(obj) else None
        elif isinstance(obj, dict):
            obj = obj.get(key)
        else:
            return None
        if obj is None:
            return None
    return obj


def run_once(cmd: List[str], env: Dict[str, str],
             log_base: Optional[str]) -> tuple:
    """(exit code, last stdout line, host-clock wall) of one run."""
    full = dict(os.environ)
    for var, val in env.items():
        if val:
            full[var] = val
        else:
            full.pop(var, None)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, env=full, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    wall = time.perf_counter() - t0
    if log_base:
        for ext, text in (("stdout", res.stdout), ("stderr", res.stderr)):
            with open(f"{log_base}.{ext}.txt", "w") as f:
                f.write(text)
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0:
        sys.stderr.write(res.stderr[-4000:])
    return res.returncode, (lines[-1] if lines else ""), wall


def summarize(values: list) -> Optional[dict]:
    nums = [v for v in values if isinstance(v, (int, float))
            and not isinstance(v, bool)]
    if not nums or len(nums) != len(values):
        return None
    return {"min": min(nums), "median": statistics.median(nums),
            "max": max(nums)}


def run(cmd: List[str], arms: Dict[str, Dict[str, str]], order: List[str],
        fields: List[str], logs: Optional[str] = None) -> dict:
    """Every run of `order`; returns the result per arm, or raises
    RunFailed at the first run that fails."""
    if logs:
        os.makedirs(logs, exist_ok=True)
    runs: Dict[str, list] = {name: [] for name in arms}
    for k, name in enumerate(order):
        print(f"[env_arms] run {k + 1}/{len(order)}: arm {name} "
              f"{arms[name]}", file=sys.stderr, flush=True)
        base = os.path.join(logs, f"run{k + 1}_{name}") if logs else None
        rc, last, wall = run_once(cmd, arms[name], base)
        if rc != 0:
            print(f"env_arms: run {k + 1} (arm {name}) exited {rc}",
                  file=sys.stderr)
            raise RunFailed(rc)
        obj = json.loads(last)
        runs[name].append({"run": k + 1, "wall_s": wall,
                           **{f: field(obj, f) for f in fields}})
        print(f"[env_arms] run {k + 1}: {wall:.1f} s "
              f"{ {f: runs[name][-1][f] for f in fields} }",
              file=sys.stderr, flush=True)
    out = {}
    for name, rs in runs.items():
        stats = {}
        for f in ("wall_s", *fields):
            s = summarize([r[f] for r in rs])
            if s is not None:
                stats[f] = s
        out[name] = {"env": arms[name], "runs": rs, "summary": stats}
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" not in argv:
        print("env_arms: give the command after --", file=sys.stderr)
        return 2
    cut = argv.index("--")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arm", action="append", required=True,
                    help="NAME=VAR=VAL[,VAR=VAL] (repeatable)")
    ap.add_argument("--order", required=True,
                    help="comma-separated arm names, one run each")
    ap.add_argument("--field", action="append", default=[],
                    help="dotted path into each run's last JSON line "
                         "(repeatable)")
    ap.add_argument("--logs", help="keep each run's output here")
    ap.add_argument("--out", help="write the result JSON here")
    args = ap.parse_args(argv[:cut])
    cmd = argv[cut + 1:]
    if not cmd:
        print("env_arms: give the command after --", file=sys.stderr)
        return 2
    arms = dict(parse_arm(a) for a in args.arm)
    order = [n for n in args.order.split(",") if n]
    unknown = sorted(set(order) - set(arms))
    if unknown or not order:
        print(f"env_arms: --order names no arm or unknown arms {unknown}",
              file=sys.stderr)
        return 2
    from ..diag.measure import host_detail
    try:
        res = run(cmd, arms, order, args.field, args.logs)
    except RunFailed as e:
        return e.rc
    out = {"metric": "env_arms", **host_detail(), "command": cmd,
           "order": order, "arms": res}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
