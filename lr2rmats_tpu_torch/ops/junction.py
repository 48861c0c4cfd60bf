"""Splice-aware banded junction DP: the aligner's device junction backend.

Counterpart of the junction half of lr2rmats_tpu/ops/splice_device.py.  For
every inter-anchor gap that looks like an intron, both query flanks run the
banded shift DP (ops/splice.shift_dp, csrc/shift_dp.cu, band 4, M = MGAP),
and `combine` scores every (query split j, left shift cl, right shift cr)
joint placement with the GT..AG / CT..AC motif bonus and the anchor-position
prior, keeping the best per gap.  `combine` launches csrc/combine.cu for
CUDA tensors; `combine_reference` is its plain PyTorch version, step for
step the reference's `_combine` (the one entry here replaces both the
reference's lax.scan and Pallas backends).  All scores are integers or
multiples of 3/8, so float32 is exact and the kernel equals the plain
version bit for bit.

The host halves are numpy copies of the reference's (its module imports
jax): `prepare_junction_batch` packs the gaps into lanes, `recover_ops`
recovers the chosen cell's ops through the native
`junction_cell_ops_batch_c`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from . import _build
from .splice import NEG, PAD_CODE, shift_dp

MGAP = 64          # max gap-query length placed by the batch (host beyond)
B_DEF = 4
W_POS = 0.375      # anchor-position prior weight (align/splice.py W_POS)
# gaps per chunk of the plain version: its [M+1, W, W, G] intermediates
# take ~21 KB a gap each at M = MGAP, B = 4
_REF_CHUNK = 512


# ---------------------------------------------------------------------------
# host-side batch preparation (splice_device.py:62-129)
# ---------------------------------------------------------------------------

def _dinuc_classes(ref, pos, table):
    """Dinucleotide class at pos (start of the pair) from table[(b0, b1)];
    -1 out of range."""
    n = len(ref)
    valid = (pos >= 0) & (pos + 1 < n)
    b0 = ref[np.clip(pos, 0, n - 1)].astype(np.int64)
    b1 = ref[np.clip(pos + 1, 0, n - 1)].astype(np.int64)
    cls = table[np.clip(b0, 0, 4) * 5 + np.clip(b1, 0, 4)]
    return np.where(valid, cls, -1).astype(np.int8)


_DTAB = np.zeros(25, np.int8)
_DTAB[2 * 5 + 3] = 1   # GT
_DTAB[1 * 5 + 3] = 2   # CT
_DTAB[2 * 5 + 1] = 3   # GC
_DTAB[0 * 5 + 3] = 4   # AT
_ATAB = np.zeros(25, np.int8)
_ATAB[0 * 5 + 2] = 1   # AG
_ATAB[0 * 5 + 1] = 2   # AC
_ATAB[2 * 5 + 1] = 3   # GC
_ATAB[0 * 5 + 3] = 4   # AT


def prepare_junction_batch(ref: np.ndarray, gaps: List[tuple],
                           B: int = B_DEF) -> Optional[dict]:
    """Pack (q, left_ref, right_ref[, el, er]) gaps into [*, G] lane arrays;
    None when there are none.  Gaps must have len(q) <= MGAP and
    right_ref - left_ref >= len(q) + B (the collect pass routes the rest to
    the host)."""
    G = len(gaps)
    if G == 0:
        return None
    n = len(ref)
    m_arr = np.array([len(g[0]) for g in gaps], np.int32)
    lr_arr = np.array([g[1] for g in gaps], np.int64)
    rr_arr = np.array([g[2] for g in gaps], np.int64)
    # anchor-position prior centres; 3-tuple gaps mean no pullback (0)
    el_arr = np.array([g[3] if len(g) > 3 else 0 for g in gaps], np.int32)
    er_arr = np.array([g[4] if len(g) > 4 else 0 for g in gaps], np.int32)
    span_arr = rr_arr - lr_arr
    q = np.full((MGAP, G), PAD_CODE, np.int32)
    qr = np.full((MGAP, G), PAD_CODE, np.int32)
    for g, gap in enumerate(gaps):
        qg = gap[0]
        m = len(qg)
        q[:m, g] = qg
        qr[:m, g] = qg[::-1]
    rows = np.arange(MGAP + B, dtype=np.int64)[:, None]
    mask_l = rows < np.minimum(m_arr + B, span_arr)[None, :]
    lidx = np.clip(lr_arr[None, :] + rows, 0, n - 1)
    lwin = np.where(mask_l, ref[lidx], PAD_CODE).astype(np.int32)
    ridx = np.clip(rr_arr[None, :] - 1 - rows, 0, n - 1)
    rwin = np.where(mask_l, ref[ridx], PAD_CODE).astype(np.int32)
    # donor / acceptor classes at candidate offsets i in [0, m+2B]
    # (0 = none, -1 = outside the reference or beyond m+2B)
    crows = np.arange(MGAP + 2 * B + 1, dtype=np.int64)[:, None]
    cmask = crows <= (m_arr + 2 * B)[None, :]
    dok = _dinuc_classes(ref, lr_arr[None, :] + crows - B, _DTAB)
    dok = np.where(cmask, dok, -1).astype(np.int8)
    apos = rr_arr[None, :] - (crows - B) - 2
    aok = _dinuc_classes(ref, apos, _ATAB)
    aok = np.where(cmask, aok, -1).astype(np.int8)
    return dict(q=q, qr=qr, lwin=lwin, rwin=rwin, m=m_arr, span=span_arr,
                dok=dok, aok=aok, el=el_arr, er=er_arr, B=B)


# ---------------------------------------------------------------------------
# combine: best (j, cl, cr) per gap (splice_device.py:136-208)
# ---------------------------------------------------------------------------

def _motif_terms(dc: torch.Tensor, ac: torch.Tensor):
    """bonus (float32) and vote (int32) of donor / acceptor classes: donor
    1=GT 2=CT 3=GC 4=AT; acceptor 1=AG 2=AC 3=GC 4=AT; -1/0 = none."""
    canon_p = (dc == 1) & (ac == 1)
    canon_m = (dc == 2) & (ac == 2)
    semi_p = ((dc == 3) & (ac == 1)) | ((dc == 4) & (ac == 2))
    semi_m = ((dc == 2) & (ac == 3)) | ((dc == 1) & (ac == 4))
    bonus = torch.where(canon_p | canon_m, 10.0,
                        torch.where(semi_p | semi_m, 8.0, 0.0))
    vote = (canon_p | semi_p).to(torch.int32) - \
        (canon_m | semi_m).to(torch.int32)
    return bonus, vote


def _combine_chunk(SL, SR, m, span, dok, aok, el, er, B: int,
                   min_intron: int):
    M1, W, G = SL.shape
    M = M1 - 1
    dev = SL.device
    i32 = torch.int32
    jj = torch.arange(M1, dtype=torch.int64, device=dev)
    cw = torch.arange(W, dtype=torch.int64, device=dev)
    m64 = m.to(torch.int64)
    # SRr[j] = SR[m - j], clipped to [0, M]
    idx = (m64[None, :] - jj[:, None]).clamp(0, M)              # [M1, G]
    SRr = SR.gather(0, idx[:, None, :].expand(M1, W, G))
    # donor class at offset j+cl; acceptor at (m-j)+cr, clipped
    doff = jj[:, None] + cw[None, :]                            # [M1, W]
    dc = dok[doff]                                              # [M1, W, G]
    roff = (m64[None, :] - jj[:, None])[:, None, :] + cw[None, :, None]
    aoff = roff.clamp(0, aok.shape[0] - 1)                      # [M1, W, G]
    ac = aok.gather(0, aoff.reshape(M1 * W, G)).reshape(M1, W, G)
    bonus, vote = _motif_terms(dc[:, :, None, :], ac[:, None, :, :])
    ilen = (span - m64 + 2 * B)[None, None, :] - \
        (cw[:, None] + cw[None, :])[:, :, None]                 # [W, W, G]
    w_pos = torch.tensor(W_POS, dtype=torch.float32, device=dev)
    pen_l = w_pos * (el.to(torch.int64)[None, None, :] -
                     (doff[:, :, None] - B)).clamp(min=0).to(torch.float32)
    pen_r = w_pos * (er.to(torch.int64)[None, None, :] -
                     (roff - B)).clamp(min=0).to(torch.float32)
    total = (SL[:, :, None, :] + SRr[:, None, :, :] + bonus
             - pen_l[:, :, None, :] - pen_r[:, None, :, :])
    ok = ((jj[:, None, None, None] <= m64[None, None, None, :])
          & (dc[:, :, None, :] >= 0) & (ac[:, None, :, :] >= 0)
          & (ilen[None] >= min_intron))
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    total = torch.where(ok, total, neg)
    # ties go to the LARGEST flat (j, cl, cr): argmax (first max) over the
    # axis-reversed cells, mapped back
    flat = total.flip(0, 1, 2).reshape(M1 * W * W, G)
    score = flat.max(0).values
    best = flat.argmax(0)
    bj = (M - torch.div(best, W * W, rounding_mode="floor")).to(i32)
    bcl = (W - 1 - torch.div(best, W, rounding_mode="floor") % W).to(i32)
    bcr = (W - 1 - best % W).to(i32)
    bvote = vote.flip(0, 1, 2).reshape(M1 * W * W, G).gather(
        0, best[None, :])[0]
    found = score > torch.tensor(NEG / 2, dtype=torch.float32, device=dev)
    return score, bj, bcl, bcr, bvote, found


def combine_reference(SL, SR, m, span, dok, aok, el, er, B: int,
                      min_intron: int):
    """Plain PyTorch version of the combine kernel (splice_device._combine):
    (score f32, j, cl, cr, vote int32, found bool), each [G].  Runs in
    chunks of gaps to bound its [M+1, W, W, G] intermediates."""
    G = SL.shape[2]
    parts = [_combine_chunk(SL[:, :, s:s + _REF_CHUNK],
                            SR[:, :, s:s + _REF_CHUNK], m[s:s + _REF_CHUNK],
                            span[s:s + _REF_CHUNK], dok[:, s:s + _REF_CHUNK],
                            aok[:, s:s + _REF_CHUNK], el[s:s + _REF_CHUNK],
                            er[s:s + _REF_CHUNK], B, min_intron)
             for s in range(0, G, _REF_CHUNK)]
    if not parts:
        parts = [_combine_chunk(SL, SR, m, span, dok, aok, el, er, B,
                                min_intron)]
    return tuple(torch.cat(cols) for cols in zip(*parts))


def combine(SL, SR, m, span, dok, aok, el, er, B: int, min_intron: int):
    """Best (j, cl, cr) per gap from the two flank DPs.

    SL, SR [M+1, 2B+1, G] float32; m, el, er [G] int32; span [G] int64;
    dok, aok [M+2B+1, G] int8.  Returns (score f32, j, cl, cr, vote int32,
    found bool), each [G].  CUDA tensors launch csrc/combine.cu; CPU
    tensors run the plain PyTorch version."""
    if B != B_DEF:
        raise ValueError(f"combine: band must be {B_DEF}, got {B}")
    if SL.dim() != 3 or SL.shape != SR.shape:
        raise ValueError(f"SL / SR must both be [M+1, W, G], got "
                         f"{tuple(SL.shape)} / {tuple(SR.shape)}")
    M1, W, G = SL.shape
    if W != 2 * B + 1:
        raise ValueError(f"SL has {W} shifts, band {B} needs {2 * B + 1}")
    want = {"m": ((G,), torch.int32), "span": ((G,), torch.int64),
            "el": ((G,), torch.int32), "er": ((G,), torch.int32),
            "dok": ((M1 + 2 * B, G), torch.int8),
            "aok": ((M1 + 2 * B, G), torch.int8)}
    got = {"m": m, "span": span, "el": el, "er": er, "dok": dok, "aok": aok}
    for name, (shape, dtype) in want.items():
        t = got[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"combine: {name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if SL.dtype != torch.float32 or SR.dtype != torch.float32:
        raise TypeError("combine: SL / SR must be float32")
    dev = SL.device
    if any(t.device != dev for t in (SR, *got.values())):
        raise ValueError("combine: all inputs must be on one device")
    if dev.type == "cpu":
        return combine_reference(SL, SR, m, span, dok, aok, el, er, B,
                                 min_intron)
    if dev.type != "cuda":
        raise ValueError(f"combine: unsupported device {dev}")
    lib = _build.load()
    SL, SR, m, span, dok, aok, el, er = (
        t.contiguous() for t in (SL, SR, m, span, dok, aok, el, er))
    score = torch.empty(G, dtype=torch.float32, device=dev)
    bj, bcl, bcr, vote = (torch.empty(G, dtype=torch.int32, device=dev)
                          for _ in range(4))
    found = torch.empty(G, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        start = _build.start_event(dev)
        rc = lib.lr2_combine(
            SL.data_ptr(), SR.data_ptr(), m.data_ptr(), span.data_ptr(),
            dok.data_ptr(), aok.data_ptr(), el.data_ptr(), er.data_ptr(),
            M1 - 1, G, B, int(min_intron), score.data_ptr(), bj.data_ptr(),
            bcl.data_ptr(), bcr.data_ptr(), vote.data_ptr(),
            found.data_ptr(), _build.stream_handle(dev))
        _build.launched("combine", rc, start, dev)
    return score, bj, bcl, bcr, vote, found


def junction_batch(batch: dict, min_intron: int, device) -> Tuple[np.ndarray,
                                                                   ...]:
    """Placements (score, j, cl, cr, vote, found) as numpy arrays for a
    `prepare_junction_batch` dict: both flank shift DPs and the combine on
    `device` (the reference's junction_batch_scan / _pallas)."""
    B = batch["B"]
    dev = torch.device(device)
    t = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(dev)
         for k in ("q", "qr", "lwin", "rwin", "m", "span", "dok", "aok",
                   "el", "er")}
    SL = shift_dp(t["q"], t["lwin"], t["m"], B)
    SR = shift_dp(t["qr"], t["rwin"], t["m"], B)
    out = combine(SL, SR, t["m"], t["span"], t["dok"], t["aok"], t["el"],
                  t["er"], B, min_intron)
    return tuple(x.cpu().numpy() for x in out)


# ---------------------------------------------------------------------------
# host op recovery for the chosen cells (splice_device.py:401-452)
# ---------------------------------------------------------------------------

def cell_ops(lib, ref: np.ndarray, gaps, sel, bj, bcl, bcr, B: int = B_DEF):
    """Native traceback (csrc junction_cell_ops_batch_c) of the chosen cells
    of gaps[sel]: (lo, ln, ro, rn), the left / right ops of selected gap t
    as ln[t] / rn[t] (op, len) int32 pairs in row t of lo / ro
    [len(sel), 2 * (MGAP + 2B + 4)]."""
    n = len(sel)
    q_offs = np.zeros(n + 1, np.int64)
    np.cumsum([len(gaps[g][0]) for g in sel], out=q_offs[1:])
    qs = (np.concatenate([np.ascontiguousarray(gaps[g][0], np.uint8)
                          for g in sel])
          if q_offs[-1] else np.zeros(0, np.uint8))
    stride = MGAP + 2 * B + 4
    lo = np.zeros((n, 2 * stride), np.int32)
    ro = np.zeros((n, 2 * stride), np.int32)
    ln = np.zeros(n, np.int32)
    rn = np.zeros(n, np.int32)
    lib.junction_cell_ops_batch_c(
        qs, q_offs, ref, len(ref),
        np.array([gaps[g][1] for g in sel], np.int64),
        np.array([gaps[g][2] for g in sel], np.int64),
        np.ascontiguousarray(bj[sel], np.int32),
        np.ascontiguousarray(bcl[sel], np.int32),
        np.ascontiguousarray(bcr[sel], np.int32),
        B, n, stride, lo.reshape(-1), ln, ro.reshape(-1), rn)
    return lo, ln, ro, rn


def recover_ops(ref: np.ndarray, gaps, placements, B: int = B_DEF):
    """(left_ops, intron_len, right_ops, vote, score) per found gap, as
    refine_splice_indel would give it, from the native cell traceback;
    None for gaps not found (reference splice_device.recover_ops)."""
    from ..native import get_lib
    score, bj, bcl, bcr, vote, found = placements
    lib = get_lib()
    results: List[Optional[tuple]] = [None] * len(gaps)
    sel = [g for g in range(len(gaps)) if found[g]]
    if not sel:
        return results
    if lib is None:
        from ..align.splice import refine_splice_indel_np
        for g in sel:
            qg, lr, rr = gaps[g][:3]
            el = gaps[g][3] if len(gaps[g]) > 3 else 0
            er = gaps[g][4] if len(gaps[g]) > 4 else 0
            results[g] = refine_splice_indel_np(qg, ref, lr, rr, B,
                                                el_exp=el, er_exp=er)
        return results
    lo, ln, ro, rn = cell_ops(lib, ref, gaps, sel, bj, bcl, bcr, B)
    for t, g in enumerate(sel):
        lops = [(int(a), int(b)) for a, b in lo[t, :2 * ln[t]].reshape(-1, 2)]
        rops = [(int(a), int(b)) for a, b in ro[t, :2 * rn[t]].reshape(-1, 2)]
        m = len(gaps[g][0])
        span = gaps[g][2] - gaps[g][1]
        ilen = int(span - m + 2 * B - (bcl[g] + bcr[g]))
        results[g] = (lops, ilen, rops, int(vote[g]), float(score[g]))
    return results
