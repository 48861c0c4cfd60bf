"""Banded shift DP for one intron flank.

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

Callers: the polish placement DP (align/polish.py `polish_best_pair`,
band 8, int8).  The device junction DP runs its two band-4 flanks inside
csrc/junction.cu; its plain version (ops/junction.py
`junction_place_reference`) calls `shift_dp_reference` for each.
"""

from __future__ import annotations

import torch

from . import _build

MATCH = 1.0
MISMATCH = -2.0
GAP = -3.0
NEG = -1e18
PAD_CODE = 7              # splice_device.PAD_CODE
BANDS = (4, 8)


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
