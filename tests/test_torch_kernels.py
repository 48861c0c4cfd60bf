"""Hand-written CUDA kernels against their plain PyTorch versions on the
card (marker `cuda`; each test skips where torch.cuda.is_available() is
false).  This file imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py

Every comparison is exact: the chain kernel rounds each float32 add and
multiply like the plain version's elementwise ops and calls the same
log2f; the shift-DP scores are integers.
"""

import numpy as np
import pytest
import torch

from lr2rmats_tpu.align.chain import ChainParams
from lr2rmats_tpu_torch.align.polish import polish_best_pair
from lr2rmats_tpu_torch.ops import _build
from lr2rmats_tpu_torch.ops.chain import (chain_dp_backtrack,
                                          chain_dp_backtrack_reference,
                                          chain_dp_reference,
                                          chain_params_for_kernel)
from lr2rmats_tpu_torch.ops.splice import shift_dp, shift_dp_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _anchor_rows(seed, B, A):
    """2-3 exon chains plus 20% noise per row, sorted by (rpos, qpos)."""
    rng = np.random.default_rng(seed)
    qp = np.zeros((B, A), np.int32)
    rp = np.zeros((B, A), np.int32)
    ns = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(0, A + 1))
        q = np.sort(rng.integers(0, 2000, n))
        r = q + 10_000
        for ia in rng.integers(0, 2000, 2):
            r = np.where(q > ia, r + int(rng.integers(50, 40_000)), r)
        r = np.where(rng.random(n) < 0.2, rng.integers(0, 60_000, n), r)
        order = np.lexsort((q, r))
        qp[b, :n], rp[b, :n], ns[b] = q[order], r[order], n
    return qp, rp, ns


def _windows(seed, band, M, G, dtype):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 50_000).astype(dtype)
    q = np.full((M, G), -9, dtype)
    win = np.full((M + band, G), -9, dtype)
    m = np.zeros(G, np.int32)
    for g in range(G):
        mg = int(rng.integers(0, M + 1))
        L0 = int(rng.integers(0, 40_000))
        qw = ref[L0: L0 + mg].copy()
        qw[rng.random(mg) < 0.1] = 2
        q[:mg, g] = qw
        win[:mg + band, g] = ref[L0: L0 + mg + band]
        m[g] = mg
    return q, win, m


@pytest.mark.parametrize("A,B", [(128, 1664), (64, 320), (8, 37)])
def test_chain_kernel_matches_plain(dev, A, B):
    kp = chain_params_for_kernel(ChainParams())
    q, g, n = (torch.from_numpy(a).to(dev) for a in _anchor_rows(A + B, B, A))
    before = _build.LAUNCHES["chain_dp_backtrack"]
    mask, ps, ss, f, parent = chain_dp_backtrack(q, g, n, kp, 20.0,
                                                 dp_out=True)
    assert _build.LAUNCHES["chain_dp_backtrack"] == before + 1
    rf, rparent = chain_dp_reference(q, g, n, kp)
    rmask, rps, rss = chain_dp_backtrack_reference(q, g, n, kp, 20.0)
    torch.cuda.synchronize()
    assert torch.equal(parent, rparent)
    assert torch.equal(f, rf)
    assert torch.equal(mask, rmask)
    assert torch.equal(ps, rps) and torch.equal(ss, rss)
    assert bool((ps > 0).any())


@pytest.mark.parametrize("band,M,G,dtype", [(8, 192, 256, np.int8),
                                            (8, 192, 512, np.int8),
                                            (4, 64, 128, np.int32),
                                            (4, 10, 7, np.int32)])
def test_shift_dp_kernel_matches_plain(dev, band, M, G, dtype):
    q, win, m = (torch.from_numpy(a).to(dev)
                 for a in _windows(M + G, band, M, G, dtype))
    before = _build.LAUNCHES["shift_dp"]
    got = shift_dp(q, win, m, band)
    assert _build.LAUNCHES["shift_dp"] == before + 1
    want = shift_dp_reference(q, win, m, band)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_polish_best_pair_card_matches_cpu(dev):
    band, M, G = 8, 192, 256
    q, lwin, m = _windows(1, band, M, G, np.int8)
    qr, rwin, _ = _windows(2, band, M, G, np.int8)
    rng = np.random.default_rng(3)
    dl = rng.integers(-2, M + band + 2, G).astype(np.int32)
    dr = rng.integers(-2, M + band + 2, G).astype(np.int32)
    arrs = [torch.from_numpy(a) for a in (q, qr, lwin, rwin, m, dl, dr)]
    want = polish_best_pair(*arrs)
    got = polish_best_pair(*[a.to(dev) for a in arrs]).cpu()
    assert torch.equal(got, want)


def test_refused_launch_raises(dev):
    """A launch the kernel refuses (A above its shared-memory cap) raises
    instead of returning garbage or silently running the plain version."""
    kp = chain_params_for_kernel(ChainParams())
    q = torch.zeros((4, 1024), dtype=torch.int32, device=dev)
    n = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="failed to launch"):
        chain_dp_backtrack(q, q, n, kp, 20.0)


def test_slice_on_card_matches_host_backend(dev):
    import bench
    from lr2rmats_tpu.align.batch import BatchAligner
    from lr2rmats_tpu_torch.align.batch import TorchBatchAligner
    rng = np.random.default_rng(123)
    g = bench.build_genome(2_000_000, rng)
    reads, _ = bench.simulate_reads(g, 512, rng, profile="ont")
    seqset = bench._pack(reads, [f"read{i}" for i in range(len(reads))])
    ref = BatchAligner(g, backend="host")
    port = TorchBatchAligner.from_jax_aligner(ref, device="cuda")
    port.warmup_chain_shapes()
    got = port.align_seqset_packed(seqset).emit_sam(port.refs)
    assert port.stats["chain_kernel_launches"] > 0
    assert port.stats["shift_dp_kernel_launches"] > 0
    assert got == ref.align_seqset_packed(seqset).emit_sam(ref.refs)
