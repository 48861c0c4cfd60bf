"""Splice-aware chaining DP: fused with the backtrack, and alone.

Counterpart of lr2rmats_tpu/ops/chain_pallas.py (`_kernel`, the DP) and
lr2rmats_tpu/ops/chain_jax.py (`_scan_core` + `_backtrack_core`, the
production fused call; `_chain_scan_T`, the DP alone).  Two kernels, one
warp per read each (their headers say what bounds them and how the design
answers), both in `csrc/chain.cu` on one step loop: the DP fused with the
backtrack for rows of up to K_MAX_A anchors (`chain_dp_backtrack`), and
the DP alone at any number of anchors (`chain_dp`,
`chain_anchors_batch`).  The plain PyTorch versions here follow chain_jax
step for step.

Contract (the reference's `unpack_chain_result`, without its 2-bit
packing):
  in : qpos, rpos int32 [B, A] cluster-relative anchors sorted by
       (rpos, qpos); n_anchor int32 [B]
  out: mask uint8 [B, A] (bit0 primary, bit1 secondary), ps float32 [B],
       ss float32 [B] (0 where the chain is absent)

The reference ships query positions and reference deltas as u16 pairs with
oversized-delta exception slots (chain_jax.pack_chain_buf) to save link
bandwidth; the port takes plain int32.  Scores are float32 as on the TPU.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..align.chain import ChainParams
from . import _build

NEG = -1e18
MAX_EXAMINE = 48          # align/chain.py:backtrack's candidate cap
K_MAX_A = 512             # anchors per row the kernel takes (chain.cu kMaxA)
# fewest rows per device for a split dispatch (the reference shards fused
# chunks at 8 lanes a device and the DP alone at 2, chain_jax.py:401, 457)
FUSED_MIN_ROWS, DP_MIN_ROWS = 8, 2


class KernelChainParams(NamedTuple):
    """ChainParams as the scalars the kernel takes (floats rounded to
    float32 once, so the kernel and the plain version see equal values)."""
    window: int
    k: int
    max_qgap: int
    max_intron: int
    min_intron_gap: int
    gap_open: float
    gap_scale: float
    intron_scale: float


def _f32(x) -> float:
    return float(np.float32(x))


def chain_params_for_kernel(p: ChainParams) -> KernelChainParams:
    return KernelChainParams(int(p.window), int(p.k), int(p.max_qgap),
                             int(p.max_intron), int(p.min_intron_gap),
                             _f32(p.gap_open), _f32(p.gap_scale),
                             _f32(p.intron_scale))


# --------------------------------------------------------------- plain


def chain_dp_reference(qpos: torch.Tensor, rpos: torch.Tensor,
                       n_anchor: torch.Tensor, p: KernelChainParams
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DP only: (f float32 [B, A], parent int32 [B, A]), NEG / -1 beyond
    n_anchor — the contract of chain_pallas.chain_anchors_batch_pallas."""
    B, A = qpos.shape
    W = p.window
    dev = qpos.device
    pad = torch.zeros((B, W), dtype=torch.int32, device=dev)
    q = torch.cat([pad, qpos.to(torch.int32)], 1)
    r = torch.cat([pad, rpos.to(torch.int32)], 1)
    n = n_anchor.to(torch.int32).to(dev)
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    f = torch.cat([neg.expand(B, W),
                   torch.full((B, A), float(p.k), dtype=torch.float32,
                              device=dev)], 1)
    parent = torch.full((B, A), -1, dtype=torch.int32, device=dev)
    slots = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    n_steps = min(A, int(n.max())) if B else 0
    for i in range(n_steps):
        fw = f[:, i: i + W]
        dq = q[:, i + W: i + W + 1] - q[:, i: i + W]
        dr = r[:, i + W: i + W + 1] - r[:, i: i + W]
        j = i - W + slots
        ok = ((j >= 0) & (j < n[:, None]) & (dq > 0) & (dr > 0)
              & (dq <= p.max_qgap) & (dr <= p.max_intron))
        gain = torch.clamp(torch.minimum(dq, dr), max=p.k).to(torch.float32)
        dd = dr - dq
        add = dd.abs().to(torch.float32)
        lin = p.gap_open + p.gap_scale * add
        logc = p.gap_open + p.intron_scale * torch.log2(add + 1.0)
        cost = torch.where(dd > p.min_intron_gap, torch.minimum(logc, lin),
                           lin)
        cost = torch.where(dd == 0, 0.0, cost)
        sc = torch.where(ok, fw + gain - cost, neg)
        best = sc.max(1).values
        # first-occurrence argmax, as jnp.argmax and the kernel
        best_w = torch.where(sc == best[:, None], slots, W).min(1).values
        cur = f[:, i + W]
        take = (i < n) & (best > cur)
        f[:, i + W] = torch.where(take, best, cur)
        parent[:, i] = torch.where(take, i - W + best_w, -1)
    valid = torch.arange(A, device=dev)[None, :] < n[:, None]
    return torch.where(valid, f[:, W:], neg), torch.where(valid, parent, -1)


def _trace(parent: torch.Tensor, end: torch.Tensor, ok: torch.Tensor
           ) -> torch.Tensor:
    """[B, A] bool: anchors on the parent path from end[b] where ok[b]."""
    B, A = parent.shape
    on = torch.zeros((B, A), dtype=torch.bool, device=parent.device)
    rows = torch.arange(B, device=parent.device)
    cur = torch.where(ok, end, -1).to(torch.int64)
    for _ in range(A):
        act = cur >= 0
        if not bool(act.any()):
            break
        on[rows[act], cur[act]] = True
        nxt = parent.gather(1, cur.clamp(min=0)[:, None])[:, 0].to(torch.int64)
        cur = torch.where(act, nxt, -1)
    return on


def _backtrack_reference(f, parent, n_anchor, min_score: float):
    """chain_jax._backtrack_core's selection over a DP result."""
    B, A = f.shape
    dev = f.device
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    ar = torch.arange(A, device=dev)[None, :]
    valid = ar < n_anchor.to(dev)[:, None]
    fm = torch.where(valid, f, neg)
    ps = fm.max(1).values
    pe = torch.where(fm == ps[:, None], ar, A).min(1).values
    p_ok = ps >= min_score
    mask1 = _trace(parent, pe, p_ok)
    # reach[a] = on_primary[a] | reach[parent[a]]; parent[a] < a
    reach = torch.zeros_like(mask1)
    for a in range(A):
        pa = parent[:, a].to(torch.int64)
        up = (pa >= 0) & reach.gather(1, pa.clamp(min=0)[:, None])[:, 0]
        reach[:, a] = mask1[:, a] | up
    scorable = valid & (fm >= min_score) & p_ok[:, None]
    disj = scorable & ~reach
    f_disj = torch.where(disj, fm, neg)
    ss = f_disj.max(1).values
    se = torch.where(f_disj == ss[:, None], ar, A).min(1).values
    any_disj = disj.any(1)
    fse = fm.gather(1, se.clamp(max=A - 1)[:, None])
    ahead = (fm > fse) | ((fm == fse) & (ar < se[:, None]))
    n_better = (scorable & reach & ~mask1 & ahead).sum(1)
    s_ok = any_disj & (n_better < MAX_EXAMINE)
    mask2 = _trace(parent, se, s_ok)
    mask = mask1.to(torch.uint8) + 2 * mask2.to(torch.uint8)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return mask, torch.where(p_ok, ps, zero), torch.where(s_ok, ss, zero)


def chain_dp_backtrack_reference(qpos, rpos, n_anchor, p: KernelChainParams,
                                 min_score: float):
    """Plain PyTorch version of the fused kernel: (mask, ps, ss)."""
    f, parent = chain_dp_reference(qpos, rpos, n_anchor, p)
    return _backtrack_reference(f, parent, n_anchor, _f32(min_score))


# -------------------------------------------------------------- wrapper


def check_anchor_width(A: int, device: torch.device) -> None:
    """Raise when rows of A anchors exceed what the kernel takes on
    `device` (K_MAX_A on CUDA; the plain version has no limit).  The
    kernel refuses such a launch itself; this lets a caller raise before
    work that must not start, such as a collective."""
    if device.type == "cuda" and A > K_MAX_A:
        raise ValueError(
            f"chain kernel: {A} anchors per row exceed csrc/chain.cu's "
            f"kMaxA = {K_MAX_A}")


def _check(qpos, rpos, n_anchor):
    if qpos.dim() != 2 or qpos.shape != rpos.shape:
        raise ValueError(f"qpos/rpos must be [B, A] alike, got "
                         f"{tuple(qpos.shape)} / {tuple(rpos.shape)}")
    if n_anchor.shape != (qpos.shape[0],):
        raise ValueError(f"n_anchor must be [B], got {tuple(n_anchor.shape)}")
    for name, t in (("qpos", qpos), ("rpos", rpos), ("n_anchor", n_anchor)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != qpos.device:
            raise ValueError(f"{name} is on {t.device}, qpos on "
                             f"{qpos.device}")


def split_rows(B: int, devices: Sequence, min_rows: int
               ) -> List[Tuple[object, int, int]]:
    """(device, lo, hi) row blocks of a B-row chain dispatch over
    `devices`: contiguous equal blocks in device order when there is more
    than one device, B % n == 0 and B >= min_rows * n (the reference's
    `_dp_shardings` rule, chain_jax.py:382), else all rows on devices[0]."""
    n = len(devices)
    if n > 1 and B % n == 0 and B >= min_rows * n:
        m = B // n
        return [(d, i * m, (i + 1) * m) for i, d in enumerate(devices)]
    return [(devices[0], 0, B)]


def launch_rows(fn, arrays: Sequence[np.ndarray], devices: Sequence,
                min_rows: int, *args) -> list:
    """fn(*blocks, *args) for each row block of split_rows over `devices`,
    the blocks being the rows lo:hi of each numpy array copied to that
    block's device.  Returns the per-block outputs (device tensors, not yet
    copied back) in device order."""
    return [fn(*(torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(d)
                 for a in arrays), *args)
            for d, lo, hi in split_rows(len(arrays[0]), devices, min_rows)]


def gather_rows(parts: list) -> Tuple[np.ndarray, ...]:
    """launch_rows' per-block outputs copied back and concatenated along
    the rows in device order, one numpy array per output."""
    return tuple(np.concatenate([blk[k].cpu().numpy() for blk in parts])
                 for k in range(len(parts[0])))


def chain_dp(qpos: torch.Tensor, rpos: torch.Tensor, n_anchor: torch.Tensor,
             p: KernelChainParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain DP alone at any number of anchors per row: (f float32
    [B, A], parent int32 [B, A]), -1e18 / -1 beyond n_anchor.  CUDA
    tensors launch csrc/chain.cu's DP-only kernel (windows up to 1024;
    a wider one is refused); CPU tensors run the plain PyTorch version."""
    _check(qpos, rpos, n_anchor)
    dev = qpos.device
    if dev.type == "cpu":
        return chain_dp_reference(qpos, rpos, n_anchor, p)
    if dev.type != "cuda":
        raise ValueError(f"chain_dp: unsupported device {dev}")
    lib = _build.load()
    B, A = qpos.shape
    qpos, rpos, n_anchor = (t.contiguous() for t in (qpos, rpos, n_anchor))
    f = torch.empty((B, A), dtype=torch.float32, device=dev)
    parent = torch.empty((B, A), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        start = _build.start_event(dev)
        rc = lib.lr2_chain_dp(
            qpos.data_ptr(), rpos.data_ptr(), n_anchor.data_ptr(), B, A,
            p.window, p.k, p.max_qgap, p.max_intron, p.min_intron_gap,
            p.gap_open, p.gap_scale, p.intron_scale, f.data_ptr(),
            parent.data_ptr(), _build.stream_handle(dev))
        _build.launched("chain_dp", rc, start, dev)
    return f, parent


def chain_anchors_batch(qpos: np.ndarray, rpos: np.ndarray,
                        n_anchor: np.ndarray, p: ChainParams,
                        devices: Sequence = ("cuda",)
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched chaining, numpy in and out: (f [B, A] float32, parent
    [B, A] int32), the contract of chain_jax.chain_anchors_batch
    (chain_jax.py:472) and chain_pallas.chain_anchors_batch_pallas.  Rows
    are split over `devices` as split_rows says with DP_MIN_ROWS (the
    reference's dp sharding over its local devices)."""
    arrays = [np.asarray(a, np.int32) for a in (qpos, rpos, n_anchor)]
    return gather_rows(launch_rows(chain_dp, arrays,
                                   [torch.device(d) for d in devices],
                                   DP_MIN_ROWS, chain_params_for_kernel(p)))


def chain_dp_backtrack(qpos: torch.Tensor, rpos: torch.Tensor,
                       n_anchor: torch.Tensor, p: KernelChainParams,
                       min_score: float, dp_out: bool = False):
    """Fused chain DP + backtrack: (mask, ps, ss), plus (f, parent) when
    dp_out.  CUDA tensors launch csrc/chain.cu; CPU tensors run the plain
    PyTorch version."""
    _check(qpos, rpos, n_anchor)
    dev = qpos.device
    if dev.type == "cpu":
        f, parent = chain_dp_reference(qpos, rpos, n_anchor, p)
        out = _backtrack_reference(f, parent, n_anchor, _f32(min_score))
        return (*out, f, parent) if dp_out else out
    if dev.type != "cuda":
        raise ValueError(f"chain_dp_backtrack: unsupported device {dev}")
    lib = _build.load()
    B, A = qpos.shape
    qpos, rpos, n_anchor = (t.contiguous() for t in (qpos, rpos, n_anchor))
    mask = torch.empty((B, A), dtype=torch.uint8, device=dev)
    ps = torch.empty(B, dtype=torch.float32, device=dev)
    ss = torch.empty(B, dtype=torch.float32, device=dev)
    f = parent = None
    if dp_out:
        f = torch.empty((B, A), dtype=torch.float32, device=dev)
        parent = torch.empty((B, A), dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        start = _build.start_event(dev)
        rc = lib.lr2_chain_dp_backtrack(
            qpos.data_ptr(), rpos.data_ptr(), n_anchor.data_ptr(), B, A,
            p.window, p.k, p.max_qgap, p.max_intron, p.min_intron_gap,
            p.gap_open, p.gap_scale, p.intron_scale,
            _f32(min_score), mask.data_ptr(), ps.data_ptr(),
            ss.data_ptr(), ptr(f), ptr(parent), _build.stream_handle(dev))
        _build.launched("chain_dp_backtrack", rc, start, dev)
    if dp_out:
        return mask, ps, ss, f, parent
    return mask, ps, ss
