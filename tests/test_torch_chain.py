"""Port chain kernel (lr2rmats_tpu_torch/ops/chain.py) against the JAX
reference.

The plain PyTorch version runs on the CPU against the reference's
production fused call (chain_jax._chain_backtrack via pack_chain_buf ->
unpack_chain_result), its Pallas kernel in interpret mode, and the host
float64 DP.  Tolerances: membership masks and parents are exact; f, ps and
ss are float32 against XLA's float32, whose jnp.log2 (log(x)/log(2))
differs from torch.log2 by one ulp on some inputs, so they are held at
rtol 1e-5.  The kernel-against-plain tests are in
tests/test_torch_kernels.py.
"""

import jax
import numpy as np
import pytest
import torch

from lr2rmats_tpu.align.chain import ChainParams, backtrack, chain_anchors
from lr2rmats_tpu.ops.chain_jax import (EXC_ROWS, chain_backtrack_batch_async,
                                        unpack_chain_result)
from lr2rmats_tpu.ops.chain_pallas import chain_anchors_batch_pallas
from lr2rmats_tpu_torch.ops import _build
from lr2rmats_tpu_torch.ops.chain import (chain_dp_backtrack,
                                          chain_dp_reference,
                                          chain_params_for_kernel)
from tests.test_chain_jax import random_anchor_rows

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions gain nothing from intra-op threads at these
    sizes; one thread keeps them off the cores of parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fused_rows(rng, B, A):
    """tests/test_chain_jax.py::test_fused_backtrack_matches_host rows."""
    q = np.zeros((B, A), np.int32)
    g = np.zeros((B, A), np.int32)
    n = np.zeros(B, np.int32)
    for b in range(B):
        na = int(rng.integers(4, A + 1))
        n[b] = na
        qq = np.sort(rng.integers(0, 2000, na))
        diag = rng.integers(0, 50000) + np.where(
            rng.random(na) < 0.3, rng.integers(0, 30000, na), 0)
        q[b, :na] = qq
        g[b, :na] = np.sort(qq + diag)
    return q, g, n


def _u16_rows(rng, B=8, A=64):
    """Query positions just under 2^16 (the reference's u16 boundary)."""
    q = np.zeros((B, A), np.int32)
    g = np.zeros((B, A), np.int32)
    n = np.zeros(B, np.int32)
    for b in range(B):
        na = int(rng.integers(8, A + 1))
        n[b] = na
        qq = np.sort(rng.integers(60_000, 65_536, na)).astype(np.int32)
        q[b, :na] = qq
        g[b, :na] = np.sort(qq + int(rng.integers(0, 40_000)))
    return q, g, n


def _large_intron_rows(rng, B=8, A=64):
    """Up to EXC_ROWS introns of 70-180 kb plus small ones (the reference's
    delta-exception case)."""
    qp = np.zeros((B, A), np.int32)
    rp = np.zeros((B, A), np.int32)
    ns = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(10, A))
        q = np.sort(rng.integers(0, 3000, n))
        r = q.copy()
        for _ in range(int(rng.integers(1, EXC_ROWS + 1))):
            at = int(rng.integers(0, 3000))
            r = np.where(q > at, r + int(rng.integers(70_000, 180_000)), r)
        for _ in range(2):
            at = int(rng.integers(0, 3000))
            r = np.where(q > at, r + int(rng.integers(100, 5000)), r)
        order = np.lexsort((q, r))
        qp[b, :n], rp[b, :n], ns[b] = q[order], r[order], n
    return qp, rp, ns


def _case(name):
    if name == "random128":
        q, g, n = random_anchor_rows(np.random.default_rng(0), B=16, A=128)
        return q.astype(np.int32), g.astype(np.int32), n, 20.0
    if name == "random64":
        q, g, n = random_anchor_rows(np.random.default_rng(5), B=24, A=64)
        return q.astype(np.int32), g.astype(np.int32), n, 20.0
    if name == "fused":
        return (*_fused_rows(np.random.default_rng(19), 48, 64), 20.0)
    if name == "u16_boundary":
        return (*_u16_rows(np.random.default_rng(7)), 10.0)
    if name == "large_intron":
        return (*_large_intron_rows(np.random.default_rng(17)), 20.0)
    raise KeyError(name)


CASES = ["random128", "random64", "fused", "u16_boundary", "large_intron"]


def _port(q, g, n, p, min_score):
    mask, ps, ss = chain_dp_backtrack(torch.from_numpy(q),
                                      torch.from_numpy(g),
                                      torch.from_numpy(n),
                                      chain_params_for_kernel(p), min_score)
    return mask.numpy(), ps.numpy(), ss.numpy()


@pytest.mark.parametrize("case", CASES)
def test_fused_matches_jax_backtrack(case):
    """Plain fused chain + backtrack == chain_jax._chain_backtrack."""
    q, g, n, min_score = _case(case)
    p = ChainParams()
    B, A = q.shape
    flat = jax.device_get(chain_backtrack_batch_async(q, g, n, p, min_score))
    jmask, jps, jss = unpack_chain_result(np.asarray(flat), A, B)
    mask, ps, ss = _port(q, g, n, p, min_score)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_allclose(ps, jps, rtol=RTOL)
    np.testing.assert_allclose(ss, jss, rtol=RTOL)
    assert (mask & 1).any() and ((ps > 0) == (jps > 0)).all()


@pytest.mark.parametrize("case", CASES)
def test_fused_matches_host_backtrack(case):
    """Membership equals the host float64 DP + backtrack row for row."""
    q, g, n, min_score = _case(case)
    p = ChainParams()
    mask, ps, ss = _port(q, g, n, p, min_score)
    for b in range(len(n)):
        na = int(n[b])
        f, parent = chain_anchors(q[b, :na].astype(np.int64),
                                  g[b, :na].astype(np.int64), p)
        pri, hps, sec, hss = backtrack(f, parent, min_score)
        np.testing.assert_array_equal(np.nonzero(mask[b, :na] & 1)[0], pri)
        np.testing.assert_array_equal(np.nonzero(mask[b, :na] & 2)[0], sec)
        assert ps[b] == pytest.approx(hps, rel=RTOL)
        assert ss[b] == pytest.approx(hss, rel=RTOL)


@pytest.mark.parametrize("B,A,seed", [(8, 128, 2), (5, 64, 4)])
def test_dp_matches_pallas_interpret(B, A, seed):
    """DP-only plain version == chain_pallas._kernel (interpret mode):
    parents exact, f at rtol 1e-5 (the Pallas log2 is ln(x)*log2(e))."""
    qp, rp, n = random_anchor_rows(np.random.default_rng(seed), B=B, A=A)
    qp, rp = qp.astype(np.int32), rp.astype(np.int32)
    p = ChainParams()
    fb, pb = chain_anchors_batch_pallas(qp, rp, n, p, interpret=True)
    f, parent = chain_dp_reference(torch.from_numpy(qp), torch.from_numpy(rp),
                                   torch.from_numpy(n),
                                   chain_params_for_kernel(p))
    np.testing.assert_array_equal(parent.numpy(), pb)
    np.testing.assert_allclose(f.numpy(), fb, rtol=RTOL)


def test_dp_matches_host_f64():
    qp, rp, n = random_anchor_rows(np.random.default_rng(11), B=12, A=128)
    p = ChainParams()
    f, parent = chain_dp_reference(
        torch.from_numpy(qp.astype(np.int32)),
        torch.from_numpy(rp.astype(np.int32)), torch.from_numpy(n),
        chain_params_for_kernel(p))
    for i in range(len(n)):
        fh, ph = chain_anchors(qp[i, : n[i]], rp[i, : n[i]], p)
        np.testing.assert_allclose(f[i, : n[i]].numpy(), fh, rtol=RTOL)
        np.testing.assert_array_equal(parent[i, : n[i]].numpy(), ph)
        assert (f[i, n[i]:] == -1e18).all() and (parent[i, n[i]:] == -1).all()


def test_empty_and_padding_rows():
    """n_anchor = 0 rows and padding give empty masks and zero scores."""
    q, g, n, _ = _case("random64")
    n = n.copy()
    n[::3] = 0
    mask, ps, ss = _port(q, g, n, ChainParams(), 20.0)
    assert not mask[::3].any() and not ps[::3].any() and not ss[::3].any()
    valid = np.arange(q.shape[1])[None, :] < n[:, None]
    assert not mask[~valid].any()


def test_wrapper_validates_inputs():
    p = chain_params_for_kernel(ChainParams())
    q = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        chain_dp_backtrack(q.to(torch.int64), q, torch.zeros(4, dtype=torch.int32),
                           p, 20.0)
    with pytest.raises(ValueError):
        chain_dp_backtrack(q, q[:, :4], torch.zeros(4, dtype=torch.int32),
                           p, 20.0)
    with pytest.raises(ValueError):
        chain_dp_backtrack(q, q, torch.zeros(3, dtype=torch.int32), p, 20.0)


def test_cpu_runs_plain_version_without_launch():
    """A CPU tensor takes the plain version: no kernel build, no count."""
    before = dict(_build.LAUNCHES)
    q, g, n, _ = _case("random64")
    _port(q, g, n, ChainParams(), 20.0)
    assert _build.LAUNCHES == before
