"""Port shift DP (lr2rmats_tpu_torch/ops/splice.py) against the JAX
reference: splice_device._shift_dp_scan (the XLA scan that polish runs) and
splice_device._junction_pallas_dp (the Pallas kernel, interpret mode), at
the junction shape (band 4, M=64, int32) and the polish shape (band 8,
M=192, int8).  The scores are integers, so every comparison is exact.
The kernel-against-plain tests are in tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lr2rmats_tpu.ops.splice_device import (MGAP, _junction_pallas_dp,
                                            _shift_dp_scan,
                                            prepare_junction_batch)
from lr2rmats_tpu_torch.ops.splice import shift_dp
from tests.test_torch_chain import one_torch_thread  # noqa: F401 (autouse)


def _junction_layout(G=128, seed=41):
    """prepare_junction_batch output (band 4, M=MGAP=64, int32)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 100_000).astype(np.uint8)
    gaps = []
    for _ in range(G):
        m = int(rng.integers(0, MGAP + 1))
        lr = int(rng.integers(100, 80_000))
        span = int(rng.integers(m + 40, m + 5000))
        q = ref[lr: lr + m].copy()
        mut = rng.random(m) < 0.15
        q[mut] = (q[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        gaps.append((q, lr, lr + span))
    b = prepare_junction_batch(ref, gaps, 4)
    return b["q"], b["qr"], b["lwin"], b["rwin"], b["m"], 4


def _polish_layout(G=256, seed=77):
    """constrained_place_many packing (band 8, M=192, int8, PAD=-9)."""
    rng = np.random.default_rng(seed)
    M, band = 192, 8
    ref = rng.integers(0, 4, 200_000).astype(np.int8)
    q = np.full((M, G), -9, np.int8)
    qr = np.full((M, G), -9, np.int8)
    lwin = np.full((M + band, G), -9, np.int8)
    rwin = np.full((M + band, G), -9, np.int8)
    m_arr = np.zeros(G, np.int32)
    for g in range(G):
        m = int(rng.integers(0, M + 1))
        L0 = int(rng.integers(0, 150_000))
        R0 = L0 + m + band + int(rng.integers(0, 4000))
        qw = ref[L0: L0 + m].copy()
        mut = rng.random(m) < 0.1
        qw[mut] = (qw[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        q[:m, g] = qw
        qr[:m, g] = qw[::-1]
        lwin[:m + band, g] = ref[L0: L0 + m + band]
        rwin[:m + band, g] = ref[R0 - m - band: R0][::-1]
        m_arr[g] = m
    return q, qr, lwin, rwin, m_arr, band


LAYOUTS = {"junction_b4_m64": _junction_layout,
           "polish_b8_m192": _polish_layout}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_matches_shift_dp_scan(layout):
    q, qr, lwin, rwin, m, band = LAYOUTS[layout]()
    for qa, wa in ((q, lwin), (qr, rwin)):
        want = np.asarray(_shift_dp_scan(jnp.asarray(qa), jnp.asarray(wa),
                                         jnp.asarray(m), band))
        got = shift_dp(torch.from_numpy(qa), torch.from_numpy(wa),
                       torch.from_numpy(m), band).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_matches_pallas_interpret(layout):
    q, qr, lwin, rwin, m, band = LAYOUTS[layout]()
    M, G = q.shape
    W = 2 * band + 1
    i32 = lambda a: jnp.asarray(a.astype(np.int32))
    SL, SR = _junction_pallas_dp(i32(q), i32(qr), i32(lwin), i32(rwin),
                                 jnp.asarray(m), band, M, interpret=True)
    for qa, wa, want in ((q, lwin, SL), (qr, rwin, SR)):
        got = shift_dp(torch.from_numpy(qa), torch.from_numpy(wa),
                       torch.from_numpy(m), band).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(want).reshape(M + 1, W, G))


def test_int8_and_int32_layouts_agree():
    q, qr, lwin, rwin, m, band = _polish_layout(G=64, seed=3)
    t = lambda a: torch.from_numpy(a)
    a = shift_dp(t(q), t(lwin), t(m), band)
    b = shift_dp(t(q.astype(np.int32)), t(lwin.astype(np.int32)), t(m), band)
    assert torch.equal(a, b)


def test_wrapper_validates_inputs():
    q = torch.zeros((16, 8), dtype=torch.int8)
    win = torch.zeros((20, 8), dtype=torch.int8)
    m = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        shift_dp(q, win, m, 5)                      # band not in (4, 8)
    with pytest.raises(ValueError):
        shift_dp(q, win[:18], m, 4)                 # win not [M+band, G]
    with pytest.raises(TypeError):
        shift_dp(q, win.to(torch.int32), m, 4)      # mixed dtypes
    with pytest.raises(TypeError):
        shift_dp(q, win, m.to(torch.int64), 4)
    assert shift_dp(q, win, m, 4).shape == (17, 9, 8)
