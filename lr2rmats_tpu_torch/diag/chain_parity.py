"""Chain-parity diagnostic: the DP-only chain kernel against the fused one
and the plain DP, and the log probe.

Counterpart of scripts/diag_chain_pallas.py.  There, the Pallas chain DP
(`chain_pallas._kernel`) is held against the scan DP, with a linear-only
arm that takes the log out of the cost, and a Pallas log probe (`kern`)
shows how its ln(x) * log2(e) differs from XLA's log2.  Here:

  * `chain_dp` (csrc/chain_dp.cu, the counterpart of `_kernel`) against
    `chain_dp_backtrack(dp_out=True)` (csrc/chain.cu, whose f / parent are
    those of chain_jax's scan) and against the plain DP, on the
    reference's random anchor rows (seed 41, B=256, A=128) and at A=4096
    (where the fused kernel, capped at 512 anchors, sits out on the card),
    then on the linear-only arm (min_intron_gap = 1 << 30);
  * `log_probe` (csrc/log_probe.cu, the counterpart of `kern`) over the
    reference's sample of every gap the DP can see, against its plain
    version, torch.log2 (libdevice log2f on the card, the chain kernels'
    log) and numpy's float32 log2.

    python -m lr2rmats_tpu_torch.diag.chain_parity [--device cpu|cuda]

On the card every kernel must equal its plain version bit for bit; the
exit code is 1 when one does not.  On the CPU the wrappers run their plain
versions, so the comparisons there show the plain arithmetic only.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np
import torch

from ..align.chain import ChainParams
from ..device import resolve_device
from ..ops import _build
from ..ops.chain import (K_MAX_A, chain_dp, chain_dp_backtrack,
                         chain_dp_reference, chain_params_for_kernel)

LOG2E = 1.4426950408889634
RTOL = 1e-5
CHAIN_CASES = ((41, 256, 128), (42, 32, 4096))     # (seed, B, A)


# ------------------------------------------------------------- log probe


def log_probe_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: torch.log(x) * LOG2E in float32."""
    return torch.log(x) * LOG2E


def log_probe(x: torch.Tensor) -> torch.Tensor:
    """ln(x) * log2(e) elementwise over float32.  CUDA tensors launch
    csrc/log_probe.cu; CPU tensors run the plain version."""
    if x.dtype != torch.float32:
        raise TypeError(f"log_probe takes float32, got {x.dtype}")
    dev = x.device
    if dev.type == "cpu":
        return log_probe_reference(x)
    if dev.type != "cuda":
        raise ValueError(f"log_probe: unsupported device {dev}")
    lib = _build.load()
    x = x.contiguous()
    y = torch.empty_like(x)
    with torch.cuda.device(dev):
        start = _build.start_event(dev)
        rc = lib.lr2_log_probe(x.data_ptr(), y.data_ptr(), x.numel(),
                               _build.stream_handle(dev))
        _build.launched("log_probe", rc, start, dev)
    return y


def probe_sample():
    """(vals, x): every gap 1..32767 and 32768..200001 step 37 (37287
    values), and x = vals + 1 zero-padded to [292, 128] float32, as the
    reference probe lays it out."""
    vals = np.concatenate([np.arange(1, 32768, dtype=np.float32),
                           np.arange(32768, 200002, 37, dtype=np.float32)])
    S = -(-len(vals) // 128)
    x = np.zeros((S, 128), np.float32)
    x.reshape(-1)[: len(vals)] = vals + 1.0
    return vals, x


def _differ(a: np.ndarray, b: np.ndarray):
    return int((a != b).sum()), float(np.abs(a - b).max())


def log_probe_report(dev: torch.device) -> Dict[str, tuple]:
    """(count differing, largest difference) of the probe against each
    comparison over the sample; prints them."""
    vals, x = probe_sample()
    n = len(vals)
    xt = torch.from_numpy(x).to(dev)
    flat = lambda t: t.cpu().numpy().reshape(-1)[:n]    # noqa: E731
    y = flat(log_probe(xt))
    rows = {
        "plain": flat(log_probe_reference(xt)),
        "torch.log2": flat(torch.log2(xt)),
        "numpy log2 (f32)": np.log2(vals + np.float32(1.0)).astype(
            np.float32),
    }
    out = {k: _differ(y, v) for k, v in rows.items()}
    print(f"log probe ({n} values on {dev}):")
    for k, (nd, md) in out.items():
        print(f"  ln*log2e kernel vs {k:17s}: {nd}/{n} differ, "
              f"max|d|={md:.3g}")
    return out


# ----------------------------------------------------------- chain parity


def random_anchor_rows(rng, B=8, A=128):
    """tests/test_chain_jax.py:random_anchor_rows (the rows the reference
    diagnostic draws), as int32: 2-3 exon chains plus 20% noise anchors
    per row, n in [5, A), sorted by (rpos, qpos)."""
    qp = np.zeros((B, A), np.int32)
    rp = np.zeros((B, A), np.int32)
    ns = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(5, A))
        q = np.sort(rng.integers(0, 2000, n))
        r = q + 10_000
        for ia in rng.integers(0, 2000, 2):
            r = np.where(q > ia, r + int(rng.integers(50, 5000)), r)
        noise = rng.random(n) < 0.2
        r = np.where(noise, rng.integers(0, 60_000, n), r)
        order = np.lexsort((q, r))
        qp[b, :n], rp[b, :n], ns[b] = q[order], r[order], n
    return qp, rp, ns


def _mismatch(f, parent, rf, rparent, valid):
    """(f entries off by more than rtol 1e-5, parents that differ,
    largest |df|) over the valid slots."""
    df = torch.where(valid, (f - rf).abs(), 0.0)
    nf = int((df > RTOL * torch.clamp(rf.abs(), min=1.0)).sum())
    return nf, int((valid & (parent != rparent)).sum()), float(df.max())


def chain_parity(dev: torch.device, seed: int, B: int, A: int,
                 p: ChainParams) -> Dict[str, object]:
    """chain_dp against the plain DP and (A <= K_MAX_A on the card) the
    fused kernel's f / parent on random_anchor_rows(seed, B, A)."""
    qp, rp, n = random_anchor_rows(np.random.default_rng(seed), B, A)
    q, r, nt = (torch.from_numpy(a).to(dev) for a in (qp, rp, n))
    kp = chain_params_for_kernel(p)
    f, parent = chain_dp(q, r, nt, kp)
    valid = torch.arange(A, device=dev)[None, :] < nt[:, None]
    res: Dict[str, object] = {"anchors": int(valid.sum())}
    rf, rparent = chain_dp_reference(q, r, nt, kp)
    res["plain"] = _mismatch(f, parent, rf, rparent, valid)
    res["plain_exact"] = torch.equal(f, rf) and torch.equal(parent, rparent)
    if dev.type == "cpu" or A <= K_MAX_A:
        _, _, _, ff, fparent = chain_dp_backtrack(q, r, nt, kp, 20.0,
                                                  dp_out=True)
        res["fused"] = _mismatch(f, parent, ff, fparent, valid)
        res["fused_exact"] = (torch.equal(f, ff) and
                              torch.equal(parent, fparent))
    return res


def chain_parity_report(dev: torch.device) -> Dict[tuple, dict]:
    """chain_parity over CHAIN_CASES with the default ChainParams and on
    the linear-only arm; prints each."""
    out = {}
    for arm, p in (("default", ChainParams()),
                   ("linear-only", ChainParams(min_intron_gap=1 << 30))):
        for seed, B, A in CHAIN_CASES:
            res = chain_parity(dev, seed, B, A, p)
            out[(arm, A)] = res
            print(f"chain_dp, {arm} cost, seed {seed} B={B} A={A} "
                  f"({res['anchors']} anchors on {dev}):")
            for other in ("plain", "fused"):
                if other not in res:
                    print(f"  vs fused: not run (csrc/chain.cu takes at "
                          f"most {K_MAX_A} anchors a row)")
                    continue
                nf, npar, md = res[other]
                print(f"  vs {other}: f mismatches (rtol 1e-5) {nf}, max "
                      f"|df| = {md:.6g}; parent mismatches {npar}; "
                      f"bitwise equal {res[other + '_exact']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="cuda (default) launches the kernels; cpu runs "
                    "their plain versions")
    dev = resolve_device(ap.parse_args(argv).device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    else:
        print("device: cpu (plain versions)", flush=True)
    chains = chain_parity_report(dev)
    logs = log_probe_report(dev)
    if dev.type != "cuda":
        return 0
    ok = (all(r["plain_exact"] and r.get("fused_exact", True)
              for r in chains.values()) and logs["plain"][0] == 0)
    print(f"kernels equal their plain versions bit for bit: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
