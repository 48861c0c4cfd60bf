"""Colinear anchor chaining (minimap2-role chaining DP).

Splice-aware scoring: a reference gap much larger than the query gap is a
candidate intron and is charged only a logarithmic penalty (up to
max_intron); query-side gaps are charged linearly.  The DP examines a fixed
predecessor window over anchors sorted by reference position — the same
heuristic shape as minimap2's chaining, expressed as vectorizable window ops
(the batched device version lives in ops/chain.py and csrc/chain.cu and
must agree with this host implementation; see tests/test_torch_chain.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class ChainParams:
    k: int = 15
    window: int = 64          # predecessor window size
    max_intron: int = 200_000  # reference-side gap cap (STAR uses 1M; Snakefile:139)
    max_qgap: int = 500        # query-side gap cap within a chain
    gap_open: float = 2.0
    gap_scale: float = 0.5     # linear penalty per |dq-dr| base (non-intron)
    intron_scale: float = 1.0   # log2 penalty scale for intron-like ref gaps
    min_intron_gap: int = 30   # ref-gap excess beyond which a gap is intron-like
    min_chain_score: float = 20.0


def chain_anchors(qpos: np.ndarray, rpos: np.ndarray, p: ChainParams
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Score anchors of ONE read/strand.  Anchors must be sorted by
    (rpos, qpos).  Returns (f, parent) arrays."""
    n = len(qpos)
    f = np.full(n, float(p.k), np.float64)
    parent = np.full(n, -1, np.int64)
    if n == 0:
        return f, parent
    q = qpos.astype(np.int64)
    r = rpos.astype(np.int64)
    W = p.window
    for i in range(1, n):
        j0 = max(0, i - W)
        dq = q[i] - q[j0:i]
        dr = r[i] - r[j0:i]
        valid = (dq > 0) & (dr > 0) & (dq <= p.max_qgap) & (dr <= p.max_intron)
        gain = np.minimum(np.minimum(dq, dr), p.k).astype(np.float64)
        dd = dr - dq
        add = np.abs(dd).astype(np.float64)
        # intron-like: big positive ref-side excess -> log cost
        intron_like = dd > p.min_intron_gap
        lin = p.gap_open + p.gap_scale * add
        logc = p.gap_open + p.intron_scale * np.log2(add + 1.0)
        cost = np.where(intron_like, np.minimum(logc, lin), lin)
        cost = np.where(dd == 0, 0.0, cost)
        sc = np.where(valid, f[j0:i] + gain - cost, -np.inf)
        best = int(np.argmax(sc))
        if sc[best] > f[i]:
            f[i] = sc[best]
            parent[i] = j0 + best
    return f, parent


def backtrack(f: np.ndarray, parent: np.ndarray, min_score: float
              ) -> Tuple[np.ndarray, float, np.ndarray, float]:
    """Extract primary chain and the best secondary chain (disjoint anchors).

    Returns (primary_idx, primary_score, secondary_idx, secondary_score);
    secondary may be empty.  Dispatches to the native kernel when available
    (bit-equal; tests/test_native.py).
    """
    n = len(f)
    empty = np.zeros(0, np.int64)
    if n == 0:
        return empty, 0.0, empty, 0.0
    from ..native import get_lib
    lib = get_lib()
    if lib is not None:
        import ctypes
        f64 = np.ascontiguousarray(f, np.float64)
        p64 = np.ascontiguousarray(parent, np.int64)
        pri = np.empty(n, np.int64)
        sec = np.empty(n, np.int64)
        pn = ctypes.c_int64()
        sn = ctypes.c_int64()
        ps = ctypes.c_double()
        ss = ctypes.c_double()
        lib.backtrack_c(f64, p64, n, float(min_score), 48, pri,
                        ctypes.byref(pn), sec, ctypes.byref(sn),
                        ctypes.byref(ps), ctypes.byref(ss))
        return (pri[: pn.value].copy(), float(ps.value),
                sec[: sn.value].copy(), float(ss.value))
    order = np.argsort(-f, kind="stable")
    used = np.zeros(n, bool)

    def _trace(end: int):
        idx = []
        i = end
        while i != -1:
            idx.append(i)
            i = int(parent[i])
        return np.array(idx[::-1], np.int64)

    best_end = int(order[0])
    primary = _trace(best_end)
    pscore = float(f[best_end])
    if pscore < min_score:
        return empty, 0.0, empty, 0.0
    used[primary] = True
    # secondary: best end whose chain shares no anchor with primary
    # (search capped — ends beyond the first few dozen are noise)
    examined = 0
    for e in order[1:]:
        if f[e] < min_score or examined >= 48:
            break
        if used[e]:
            continue
        examined += 1
        chain = _trace(int(e))
        if not used[chain].any():
            return primary, pscore, chain, float(f[e])
    return primary, pscore, empty, 0.0
