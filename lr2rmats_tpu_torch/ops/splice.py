"""Banded shift DP for one intron flank, and the polish placement's
traceback over two of them.

Counterpart of lr2rmats_tpu/ops/splice_device.py (`_dp_kernel`, the Pallas
kernel, and `_shift_dp_scan`, its XLA twin that the polish placement DP
runs).  The kernel is `csrc/shift_dp.cu` (a group of lanes per gap, one
lane per shift, the deletion scan as a max-plus prefix scan over the
lanes; templated on the band; its header says what bounds it and how the
design answers); `shift_dp_reference` is the plain PyTorch version, step
for step the reference scan.

Layout, as `_shift_dp_scan` takes it:
  q   [M, G]      query codes (int8 in the polish layout, int32 in the
                  junction layout), gaps on the last axis
  win [M+band, G] reference window codes, same dtype
  m   [G] int32   query length per gap
  out S [M+1, 2*band+1, G] float32 — integer scores, so exact in float32

Callers: the polish placement DP (align/polish.py `place_lanes`, band 8,
int8).  The device junction DP runs its two band-4 flanks inside
csrc/junction.cu; its plain version (ops/junction.py
`junction_place_reference`) calls `shift_dp_reference` for each.

`polish_trace` reads the two band-8 matrices of a polish placement (the
left flank's, and the right flank's on the reversed query and window) and
returns, per gap, the best split, both flanks' tracebacks and their match
and NM counts: align/polish.py `_finish_place`'s result.  Its kernel is
`polish_trace_kernel` in csrc/shift_dp.cu (one warp per gap; header there);
`polish_trace_reference` is the plain version, gap by gap.  Its output is
one row of `trace_width(M, band)` int32 words per gap:

  [0]  score, float32 bits (NEG where no split fits the band)
  [1]  bj, the split (-1 where none)
  [2]  match, [3] nm, over both flanks
  [4]  nl, [5] nr: the run counts of the left and right flank
  [6, 6+R)       the left flank's runs, BAM-coded (len << 4 | op, M=0 I=1
                 D=2) in the host's order, zero past nl
  [6+R, 6+2R)    the right flank's, the same way
with R = `trace_runs(M, band)` = 2M + band, the most steps a walk can take
(#diag + #ins = j <= M, #del = #ins + c - band <= M + band).  A flank
whose walk finds no predecessor (the host traceback's fallback, which a
finite cell never takes) has, from the kernel, count -1, zero runs and
zero match and nm: only a fault of the kernel gives that.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.sam import OP_D
from . import _build

MATCH = 1.0
MISMATCH = -2.0
GAP = -3.0
NEG = -1e18
PAD_CODE = 7              # splice_device.PAD_CODE
BANDS = (4, 8)
TRACE_BAND = 8            # polish_trace's band (align/polish.py B)
TRACE_HEAD = 6            # score, bj, match, nm, nl, nr


def shift_dp_reference(q: torch.Tensor, win: torch.Tensor, m: torch.Tensor,
                       band: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (splice_device._shift_dp_scan)."""
    M, G = q.shape
    W = 2 * band + 1
    dev = q.device
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    cc = torch.arange(W, dtype=torch.int32, device=dev)
    row0 = torch.where((cc >= band)[:, None],
                       GAP * (cc - band)[:, None].to(torch.float32),
                       neg).expand(W, G)
    # B+1 leading pad rows so window row j+c-band-1 sits at j-1+c
    winpad = torch.cat([torch.full((band + 1, G), PAD_CODE, dtype=win.dtype,
                                   device=dev), win], 0)
    hi = m.to(dev)[None, :] + band
    rows = [row0]
    prev = row0
    for j in range(1, M + 1):
        sub = torch.where(winpad[j: j + W] == q[j - 1][None, :], MATCH,
                          MISMATCH).to(torch.float32)
        diag = torch.where((j + cc - band >= 1)[:, None], prev + sub, neg)
        ins = torch.cat([prev[1:] + GAP, neg.expand(1, G)], 0)
        v = torch.maximum(diag, ins)
        best = neg.expand(G)
        out = []
        for c in range(W):
            best = torch.maximum(best + GAP, v[c])
            t = j + c - band
            best = torch.where((t >= 0) & (t <= hi[0]), best, neg)
            out.append(best)
        prev = torch.stack(out, 0)
        rows.append(prev)
    return torch.stack(rows, 0)


def shift_dp(q: torch.Tensor, win: torch.Tensor, m: torch.Tensor,
             band: int) -> torch.Tensor:
    """S [M+1, 2*band+1, G] float32.  CUDA tensors launch
    csrc/shift_dp.cu; CPU tensors run the plain PyTorch version."""
    if band not in BANDS:
        raise ValueError(f"band must be one of {BANDS}, got {band}")
    if q.dim() != 2:
        raise ValueError(f"q must be [M, G], got {tuple(q.shape)}")
    M, G = q.shape
    if tuple(win.shape) != (M + band, G) or tuple(m.shape) != (G,):
        raise ValueError(f"win must be [{M + band}, {G}] and m [{G}], got "
                         f"{tuple(win.shape)} / {tuple(m.shape)}")
    if q.dtype != win.dtype or q.dtype not in (torch.int8, torch.int32):
        raise TypeError(f"q/win must both be int8 or int32, got {q.dtype} / "
                        f"{win.dtype}")
    if m.dtype != torch.int32:
        raise TypeError(f"m must be int32, got {m.dtype}")
    dev = q.device
    if win.device != dev or m.device != dev:
        raise ValueError("q, win and m must be on one device")
    if dev.type == "cpu":
        return shift_dp_reference(q, win, m, band)
    if dev.type != "cuda":
        raise ValueError(f"shift_dp: unsupported device {dev}")
    lib = _build.load()
    q, win, m = q.contiguous(), win.contiguous(), m.contiguous()
    S = torch.empty((M + 1, 2 * band + 1, G), dtype=torch.float32,
                    device=dev)
    with torch.cuda.device(dev):
        start = _build.start_event(dev)
        rc = lib.lr2_shift_dp(q.data_ptr(), win.data_ptr(), m.data_ptr(),
                              S.data_ptr(), M, G, band, q.element_size(),
                              _build.stream_handle(dev))
        _build.launched("shift_dp", rc, start, dev)
    return S


def trace_runs(M: int, band: int = TRACE_BAND) -> int:
    """The most runs one flank's walk can have: its steps, 2M + band."""
    return 2 * M + band


def trace_width(M: int, band: int = TRACE_BAND) -> int:
    """int32 words of one gap's row of `polish_trace`."""
    return TRACE_HEAD + 2 * trace_runs(M, band)


def polish_trace_reference(SL, SR, q, qr, lwin, rwin, m, dl, dr,
                           band: int = TRACE_BAND) -> torch.Tensor:
    """Plain version of the kernel: align/polish.py `_finish_place` gap by
    gap over S's lanes (the reference's window is the left flank's DL bases
    and the right flank's DR, so L0 = 0 and acc = DL - 1), its result
    written as the kernel's row.  qr, the reversed query, is the kernel's
    input; `_finish_place` reverses q itself."""
    from ..align.polish import _finish_place
    SL, SR = SL.numpy(), SR.numpy()
    q, lwin, rwin = q.numpy(), lwin.numpy(), rwin.numpy()
    m, dl, dr = m.numpy(), dl.numpy(), dr.numpy()
    M1, _, G = SL.shape
    M = M1 - 1
    R = trace_runs(M, band)
    out = np.zeros((G, trace_width(M, band)), np.int32)
    out[:, 0] = np.float32(NEG).view(np.int32)
    out[:, 1] = -1
    for g in range(G):
        mg, DL, DR = int(m[g]), int(dl[g]), int(dr[g])
        if not 0 <= mg <= M:
            continue
        lw, rw = lwin[:mg + band, g], rwin[:mg + band, g]
        ref = np.concatenate([lw[:max(DL, 0)], rw[:max(DR, 0)][::-1]])
        res = _finish_place(q[:mg, g], ref, 0, DL - 1,
                            SL[:, :, g].astype(np.float64),
                            SR[:, :, g].astype(np.float64), lw, rw, mg, DL,
                            DR)
        if res is None:
            continue
        best, lops, rops, match, nm = res
        # the split bj: the query bases the left flank takes (M and I)
        bj = sum(n for op, n in lops if op != OP_D)
        out[g, :TRACE_HEAD] = (np.float32(best).view(np.int32), bj, match,
                               nm, len(lops), len(rops))
        for at, ops in ((TRACE_HEAD, lops), (TRACE_HEAD + R, rops)):
            out[g, at: at + len(ops)] = [n << 4 | op for op, n in ops]
    return torch.from_numpy(out)


def polish_trace(SL: torch.Tensor, SR: torch.Tensor, q: torch.Tensor,
                 qr: torch.Tensor, lwin: torch.Tensor, rwin: torch.Tensor,
                 m: torch.Tensor, dl: torch.Tensor, dr: torch.Tensor,
                 band: int = TRACE_BAND) -> torch.Tensor:
    """[G, trace_width(M, band)] int32 (layout in the module's docstring).
    CUDA tensors launch csrc/shift_dp.cu's polish_trace_kernel; CPU tensors
    run the plain version."""
    if band != TRACE_BAND:
        raise ValueError(f"polish_trace takes band {TRACE_BAND}, got {band}")
    if q.dim() != 2:
        raise ValueError(f"q must be [M, G], got {tuple(q.shape)}")
    M, G = q.shape
    W = 2 * band + 1
    shapes = ((SL, (M + 1, W, G)), (SR, (M + 1, W, G)), (qr, (M, G)),
              (lwin, (M + band, G)), (rwin, (M + band, G)), (m, (G,)),
              (dl, (G,)), (dr, (G,)))
    for t, want in shapes:
        if tuple(t.shape) != want:
            raise ValueError(f"polish_trace: a tensor is {tuple(t.shape)}, "
                             f"not {want}")
    if SL.dtype != torch.float32 or SR.dtype != torch.float32:
        raise TypeError("SL/SR must be float32")
    if any(t.dtype != torch.int8 for t in (q, qr, lwin, rwin)):
        raise TypeError("q/qr/lwin/rwin must be int8")
    if any(t.dtype != torch.int32 for t in (m, dl, dr)):
        raise TypeError("m/dl/dr must be int32")
    dev = q.device
    args = (SL, SR, q, qr, lwin, rwin, m, dl, dr)
    if any(t.device != dev for t in args):
        raise ValueError("polish_trace: every tensor must be on one device")
    if dev.type == "cpu":
        return polish_trace_reference(*args, band)
    if dev.type != "cuda":
        raise ValueError(f"polish_trace: unsupported device {dev}")
    lib = _build.load()
    args = [t.contiguous() for t in args]
    out = torch.empty((G, trace_width(M, band)), dtype=torch.int32,
                      device=dev)
    with torch.cuda.device(dev):
        start = _build.start_event(dev)
        rc = lib.lr2_polish_trace(*(t.data_ptr() for t in args),
                                  out.data_ptr(), M, G, band,
                                  _build.stream_handle(dev))
        _build.launched("polish_trace", rc, start, dev)
    return out
