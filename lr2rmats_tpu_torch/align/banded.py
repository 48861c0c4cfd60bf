"""Banded global alignment with traceback (host reference implementation).

Fills the gap segments between chain anchors inside an exon.  The band is
centred on the diagonal shift between query and reference segment lengths.
Unit costs (match 0 / mismatch 1 / indel 1) — we need the *path* (CIGAR ops)
and the edit count (NM), not an affine score.  In production this runs
inside the native batch extension (csrc/lrio.cpp extend_chain_batch_c);
the device twin for the junction-placement DP is ops/junction.py.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..io.sam import OP_D, OP_I, OP_M


def banded_edit_path(q: np.ndarray, r: np.ndarray, band_pad: int = 16
                     ) -> Tuple[List[Tuple[int, int]], int]:
    """Align query codes q to reference codes r end-to-end.

    Returns (cigar ops [(op, len)...] with op in {M, I, D}, edit_distance)
    where edit_distance counts mismatches + inserted + deleted bases.
    """
    m, n = len(q), len(r)
    if m == 0:
        return ([(OP_D, n)] if n else []), n
    if n == 0:
        return [(OP_I, m)], m
    band = abs(n - m) + band_pad
    INF = 1 << 30
    # dp[i, j] over query i (rows), ref j (cols), banded: j in [i-band, i+band]
    width = 2 * band + 1
    dp = np.full((m + 1, width), INF, np.int32)
    # j index mapping: col c corresponds to j = i + (c - band)

    def jcol(i: int, j: int) -> int:
        return j - i + band

    dp[0, jcol(0, 0)] = 0
    for j in range(1, min(n, band) + 1):
        dp[0, jcol(0, j)] = j
    for i in range(1, m + 1):
        jlo = max(0, i - band)
        jhi = min(n, i + band)
        cols = np.arange(jlo, jhi + 1)
        cc = cols - i + band
        # deletion (from dp[i, j-1]): shift within row
        # insertion (from dp[i-1, j]): col c maps to prev row col c+1
        # diag (from dp[i-1, j-1]): prev row col c
        prev = dp[i - 1]
        ins = np.where(cc + 1 < width, prev[np.minimum(cc + 1, width - 1)], INF) + 1
        sub = np.full(len(cols), INF, np.int32)
        pos = cols >= 1
        if pos.any():
            qs = q[i - 1]
            mism = (r[cols[pos] - 1] != qs).astype(np.int32)
            sub[pos] = prev[cc[pos]] + mism
        row = np.minimum(sub, ins)
        # deletions require a sequential scan within the row
        best = INF
        out = np.empty(len(cols), np.int32)
        for t in range(len(cols)):
            best = min(best + 1, row[t])
            out[t] = best
        dp[i, cc] = out
    # traceback
    ops: List[Tuple[int, int]] = []
    i, j = m, n
    ed = 0

    def push(op: int, l: int = 1):
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + l)
        else:
            ops.append((op, l))

    while i > 0 or j > 0:
        c = j - i + band
        cur = dp[i, c] if 0 <= c < width else INF
        if i > 0 and j > 0 and 0 <= c < width:
            mism = int(q[i - 1] != r[j - 1])
            if dp[i - 1, c] + mism == cur:
                push(OP_M)
                ed += mism
                i -= 1
                j -= 1
                continue
        if i > 0 and c + 1 < width and dp[i - 1, c + 1] + 1 == cur:
            push(OP_I)
            ed += 1
            i -= 1
            continue
        if j > 0 and c - 1 >= 0 and dp[i, c - 1] + 1 == cur:
            push(OP_D)
            ed += 1
            j -= 1
            continue
        # fallback (shouldn't happen): consume diagonally
        if i > 0 and j > 0:
            push(OP_M)
            ed += int(q[i - 1] != r[j - 1])
            i -= 1
            j -= 1
        elif i > 0:
            push(OP_I)
            ed += 1
            i -= 1
        else:
            push(OP_D)
            ed += 1
            j -= 1
    return ops[::-1], ed
