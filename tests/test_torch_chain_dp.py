"""The DP-only chain path of the port (ops/chain.py `chain_dp`,
`chain_anchors_batch`, `split_rows`) and the chain-parity diagnostic
(diag/chain_parity.py) against the JAX package, on the CPU.

On the CPU `chain_dp` runs its plain PyTorch version, the counterpart of
chain_pallas._kernel held to chain_jax's scan DP.  Tolerances: parents
exact; f at rtol 1e-5, since XLA's jnp.log2 and torch.log2 differ by one
ulp on some inputs (ROADMAP §3).  The log probe's plain version is held to
the Pallas `kern` of scripts/diag_chain_pallas.py in interpret mode: its ln
within one ulp, the product by log2(e) within two.  The kernel-against-plain
tests are in tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lr2rmats_tpu.align.chain import ChainParams
from lr2rmats_tpu.ops.chain_jax import chain_anchors_batch as jax_batch
from lr2rmats_tpu.ops.chain_pallas import chain_anchors_batch_pallas
from lr2rmats_tpu_torch.diag import chain_parity
from lr2rmats_tpu_torch.ops import _build
from lr2rmats_tpu_torch.ops.chain import (DP_MIN_ROWS, FUSED_MIN_ROWS,
                                          chain_anchors_batch, chain_dp,
                                          chain_dp_backtrack,
                                          chain_dp_reference,
                                          chain_params_for_kernel,
                                          gather_rows, launch_rows,
                                          split_rows)
from tests.test_chain_jax import random_anchor_rows
from tests.test_torch_chain import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-5


def _rows(seed, B, A):
    qp, rp, n = random_anchor_rows(np.random.default_rng(seed), B=B, A=A)
    return qp.astype(np.int32), rp.astype(np.int32), n.astype(np.int32)


@pytest.mark.parametrize("A,B,seed", [(128, 16, 0), (1024, 8, 1)])
@pytest.mark.parametrize("devices", [("cpu",), ("cpu", "cpu")])
def test_chain_anchors_batch_matches_jax(A, B, seed, devices):
    """The port's chain_anchors_batch (plain DP, rows split over the
    devices when there are two) == chain_jax.chain_anchors_batch."""
    qp, rp, n = _rows(seed, B, A)
    p = ChainParams()
    jf, jparent = jax_batch(qp, rp, n, p)
    f, parent = chain_anchors_batch(qp, rp, n, p, devices=devices)
    assert f.dtype == np.float32 and parent.dtype == np.int32
    assert f.shape == parent.shape == (B, A)
    np.testing.assert_array_equal(parent, jparent)
    np.testing.assert_allclose(f, jf, rtol=RTOL)
    assert int(n.max()) > A // 2 and (parent >= 0).sum() > B


@pytest.mark.parametrize("B,A,seed", [(8, 128, 2), (5, 64, 4)])
def test_chain_anchors_batch_matches_pallas_interpret(B, A, seed):
    """== chain_pallas.chain_anchors_batch_pallas (interpret mode) at the
    shapes of tests/test_pallas.py: parents exact, f at rtol 1e-5 (the
    Pallas log2 is ln(x) * log2(e))."""
    qp, rp, n = _rows(seed, B, A)
    p = ChainParams()
    pf, pparent = chain_anchors_batch_pallas(qp, rp, n, p, interpret=True)
    f, parent = chain_anchors_batch(qp, rp, n, p, devices=("cpu",))
    np.testing.assert_array_equal(parent, pparent)
    np.testing.assert_allclose(f, pf, rtol=RTOL)


def test_chain_dp_on_cpu_is_the_plain_version():
    """A CPU tensor runs the plain version, launches nothing, and agrees
    with the fused path's f / parent; padding slots are -1e18 / -1."""
    qp, rp, n = (torch.from_numpy(a) for a in _rows(3, 12, 64))
    kp = chain_params_for_kernel(ChainParams())
    before = dict(_build.LAUNCHES)
    f, parent = chain_dp(qp, rp, n, kp)
    assert _build.LAUNCHES == before
    rf, rparent = chain_dp_reference(qp, rp, n, kp)
    _, _, _, ff, fparent = chain_dp_backtrack(qp, rp, n, kp, 20.0,
                                              dp_out=True)
    for a, b in ((f, rf), (f, ff), (parent, rparent), (parent, fparent)):
        assert torch.equal(a, b)
    pad = torch.arange(64)[None, :] >= n[:, None]
    assert bool((f[pad] == -1e18).all()) and bool((parent[pad] == -1).all())
    with pytest.raises(TypeError):
        chain_dp(qp.to(torch.int64), rp, n, kp)
    with pytest.raises(ValueError):
        chain_dp(qp, rp, n[:-1], kp)


@pytest.mark.parametrize("B,n_dev,min_rows,split", [
    (16, 2, DP_MIN_ROWS, True),          # divisible and large enough
    (4, 2, DP_MIN_ROWS, True),           # exactly min_rows per device
    (15, 2, DP_MIN_ROWS, False),         # indivisible
    (2, 2, DP_MIN_ROWS, False),          # too few rows
    (16, 2, FUSED_MIN_ROWS, True),
    (8, 2, FUSED_MIN_ROWS, False),       # 8 < 8 * 2
    (1664, 4, FUSED_MIN_ROWS, True),
    (1664, 1, FUSED_MIN_ROWS, False),    # one device never splits
])
def test_split_rows_follows_dp_shardings(B, n_dev, min_rows, split):
    """split_rows is chain_jax._dp_shardings' rule: split when there is
    more than one device, B % n == 0 and B >= min_rows * n; the blocks are
    contiguous and in device order."""
    devices = [f"dev{i}" for i in range(n_dev)]
    blocks = split_rows(B, devices, min_rows)
    rule = n_dev > 1 and B % n_dev == 0 and B >= min_rows * n_dev
    assert rule == split
    if split:
        m = B // n_dev
        assert blocks == [(d, i * m, (i + 1) * m)
                          for i, d in enumerate(devices)]
    else:
        assert blocks == [("dev0", 0, B)]


def test_split_fused_launch_equals_unsplit():
    """The fused path split over two devices gives the unsplit outputs."""
    qp, rp, n = _rows(6, 16, 64)
    kp = chain_params_for_kernel(ChainParams())
    cpu = torch.device("cpu")
    one = gather_rows(launch_rows(chain_dp_backtrack, (qp, rp, n), [cpu],
                                  FUSED_MIN_ROWS, kp, 20.0))
    parts = launch_rows(chain_dp_backtrack, (qp, rp, n), [cpu, cpu],
                        FUSED_MIN_ROWS, kp, 20.0)
    assert len(parts) == 2
    for a, b in zip(one, gather_rows(parts)):
        np.testing.assert_array_equal(a, b)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) -
                  b.view(np.int32).astype(np.int64))


def test_log_probe_plain_matches_pallas_kern_interpret():
    """The probe's plain version (torch.log(x) * LOG2E in float32) against
    the diagnostic's Pallas kern in interpret mode over the reference's
    sample of 37287 gaps.  On the CPU torch.log is correctly rounded here
    while XLA's log is one ulp off on ~1% of the sample, so the ln stage
    (a Pallas kernel of the log alone) is held within one ulp and the
    product within two: a one-ulp step of ln(x) times log2(e) > 1 can
    round to two ulps of the product."""
    from jax.experimental import pallas as pl
    vals, x = chain_parity.probe_sample()
    n = len(vals)
    assert x.shape == (292, 128) and n == 37287

    def kern(x_ref, o_ref):
        o_ref[:] = jnp.log(x_ref[:]) * jnp.float32(chain_parity.LOG2E)

    def kern_ln(x_ref, o_ref):
        o_ref[:] = jnp.log(x_ref[:])

    def pallas(fn):
        return np.asarray(pl.pallas_call(
            fn, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
            interpret=True)(jnp.asarray(x))).reshape(-1)[:n]

    xt = torch.from_numpy(x)
    got = chain_parity.log_probe(xt).numpy().reshape(-1)[:n]
    ln = torch.log(xt).numpy().reshape(-1)[:n]
    for name, a, b, tol in (("ln", ln, pallas(kern_ln), 1),
                            ("ln * log2(e)", got, pallas(kern), 2)):
        u = _ulps(a, b)
        msg = (f"{name}: {int((u == 0).sum())}/{n} exact, "
               f"{int((u == 1).sum())} one ulp apart, max {u.max()} ulp")
        assert u.max() <= tol, msg
        assert (u == 0).sum() > 0.95 * n, msg


@pytest.mark.parametrize("A,B,seed", [(64, 8, 30), (128, 6, 31),
                                      (37, 5, 32)])
def test_plain_dp_takes_a_window_over_A_as_A(A, B, seed):
    """Every predecessor lies fewer than A steps back, so the plain DP at
    window 2A equals it at window A, bit for bit, and both equal
    chain_jax.chain_anchors_batch at window A (parents exact, f at rtol
    1e-5): the invariant behind the kernels' min(window, A)."""
    qp, rp, n = _rows(seed, B, A)
    q, r, nn = (torch.from_numpy(a) for a in (qp, rp, n))
    f_a, par_a = chain_dp_reference(
        q, r, nn, chain_params_for_kernel(ChainParams(window=A)))
    f_2a, par_2a = chain_dp_reference(
        q, r, nn, chain_params_for_kernel(ChainParams(window=2 * A)))
    assert torch.equal(f_a, f_2a) and torch.equal(par_a, par_2a)
    jf, jparent = jax_batch(qp, rp, n, ChainParams(window=A))
    np.testing.assert_array_equal(par_a.numpy(), jparent)
    np.testing.assert_allclose(f_a.numpy(), jf, rtol=RTOL)
    # some parent lies past the main path's 64-slot window where A > 64
    back = np.arange(A)[None, :] - par_a.numpy()
    assert back[par_a.numpy() >= 0].max() > min(A - 1, 64) // 2


def test_log_probe_plain_on_an_unaligned_view_matches_pallas_kern():
    """log_probe (its plain version on the CPU) over x[1:], a view 4 bytes
    off 16-byte alignment, against the diagnostic's Pallas kern in
    interpret mode on the same values: within the two ulps of
    test_log_probe_plain_matches_pallas_kern_interpret, and exact on 95%."""
    from jax.experimental import pallas as pl
    x = torch.from_numpy(chain_parity.probe_sample()[1]).reshape(-1)
    view = x[1:]
    assert (view.data_ptr() - x.data_ptr()) == 4 and view.is_contiguous()
    got = chain_parity.log_probe(view).numpy()
    assert np.array_equal(got, chain_parity.log_probe_reference(view).numpy(),
                          equal_nan=True)
    n = view.numel()
    padded = np.ones(-(-n // 128) * 128, np.float32)
    padded[:n] = view.numpy()

    def kern(x_ref, o_ref):
        o_ref[:] = jnp.log(x_ref[:]) * jnp.float32(chain_parity.LOG2E)

    want = np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((len(padded) // 128, 128),
                                             jnp.float32),
        interpret=True)(jnp.asarray(padded.reshape(-1, 128)))).reshape(-1)[:n]
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    u = _ulps(got[fin], want[fin])
    assert u.max() <= 2 and (u == 0).sum() > 0.95 * fin.sum()


@pytest.mark.parametrize("argv,want", [
    (["--chain-dp", "a/chain_dp.cu", "b/chain.cu"],
     {"chain_dp": ["a/chain_dp.cu", "b/chain.cu"], "log_probe": []}),
    (["--log-probe", "a/log_probe.cu", "--chain", "a/chain.cu"],
     {"log_probe": ["a/log_probe.cu"], "chain": ["a/chain.cu"]}),
    ([], {"chain": [], "chain_dp": [], "shift": [], "junction": [],
          "hamming": [], "log_probe": []}),
])
def test_kernel_variants_parser(argv, want):
    """diag/kernel_variants.py takes --chain-dp and --log-probe (parsed
    here without a card) and no longer takes --split."""
    from lr2rmats_tpu_torch.diag import kernel_variants
    args = vars(kernel_variants.build_parser().parse_args(argv))
    for key, value in want.items():
        assert args[key] == value
    with pytest.raises(SystemExit):
        kernel_variants.build_parser().parse_args(
            ["--split", "a/shift_dp.cu", "a/combine.cu"])


def test_log_probe_wrapper_on_cpu():
    x = torch.tensor([1.0, 2.0, 1024.0, 3.0], dtype=torch.float32)
    before = dict(_build.LAUNCHES)
    y = chain_parity.log_probe(x)
    assert _build.LAUNCHES == before
    assert torch.equal(y, torch.log(x) * chain_parity.LOG2E)
    with pytest.raises(TypeError):
        chain_parity.log_probe(x.double())


@pytest.mark.parametrize("arm", ["default", "linear-only"])
def test_chain_parity_on_cpu(arm):
    """The diagnostic's comparison on the CPU: chain_dp, the fused path's
    f / parent and the plain DP agree exactly on the reference's rows
    (seed 41, A=128; B cut to 32 here)."""
    p = ChainParams() if arm == "default" else \
        ChainParams(min_intron_gap=1 << 30)
    res = chain_parity.chain_parity(torch.device("cpu"), 41, 32, 128, p)
    assert res["plain"] == (0, 0, 0.0) and res["plain_exact"]
    assert res["fused"] == (0, 0, 0.0) and res["fused_exact"]
    assert res["anchors"] > 32 * 5


def test_chain_parity_main_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(chain_parity, "CHAIN_CASES", ((41, 8, 128),
                                                      (42, 2, 600)))
    assert chain_parity.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "A=600" in out and "linear-only" in out
    assert "log probe (37287 values on cpu)" in out
    assert "vs numpy log2 (f32)" in out


def test_mesh_step_past_512_anchors_matches_jax():
    """sharded_align_step at Q * H = 128 * 8 = 1024 anchors a read (past the
    fused kernel's 512) on a world-1 gloo (1, 1) mesh == the JAX step on
    make_mesh(1, 1), at rtol 1e-5.  Every read hash has 8 index entries:
    one on the read's diagonal, seven elsewhere."""
    import socket

    import torch.distributed as dist
    from lr2rmats_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from lr2rmats_tpu.parallel.mesh import sharded_align_step as jax_step
    from lr2rmats_tpu_torch.parallel.mesh import make_mesh, sharded_align_step
    rng = np.random.default_rng(23)
    G, H, B, Q = 1024, 8, 8, 128
    uh = np.sort(rng.choice(2 ** 31, G, replace=False)).astype(np.uint32)
    h = np.repeat(uh, H)
    diag = np.cumsum(rng.integers(5, 40, G))
    pos = rng.integers(0, 10 ** 6, (G, H))
    pos[:, 0] = diag
    pos = np.sort(pos, axis=1).reshape(-1).astype(np.int32)
    start = rng.integers(0, G - Q, B)
    rh = uh[start[:, None] + np.arange(Q)]
    rq = (diag[start[:, None] + np.arange(Q)] - diag[start][:, None]
          ).astype(np.int32)
    want = np.asarray(jax_step(jax_make_mesh(1, 1), ChainParams(), H)(
        h, pos, rh, rq))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        step = sharded_align_step(make_mesh(1, 1, "cpu"), ChainParams(), H)
        got = step(h, pos, rh, rq).numpy()
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert want.min() > 15.0 * 100
