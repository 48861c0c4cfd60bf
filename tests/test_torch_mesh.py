"""Port mesh layer (lr2rmats_tpu_torch/parallel/mesh.py) against the JAX
reference (lr2rmats_tpu/parallel/mesh.py).

A 4-process gloo group runs the port's `sharded_align_step` on a (2, 2)
mesh and a 1-process group on a (1, 1) mesh, both on the CPU (the chain DP
is then the kernel's plain PyTorch version); the JAX step runs on
`make_mesh(2, 2)` over the suite's 8 virtual CPU devices.  Tolerances:
against JAX rtol 1e-5 (torch.log2 and XLA's log2 differ by an ulp on some
inputs, ROADMAP §3), the port's (1, 1) run exactly.  The same groups hold
the candidate all-gathers to the identity and the step's guards.
"""

import json
import sys
import types

import jax
import numpy as np
import pytest
import torch

from lr2rmats_tpu.align.chain import ChainParams
from lr2rmats_tpu.parallel.mesh import make_mesh as jax_make_mesh
from lr2rmats_tpu.parallel.mesh import sharded_align_step as jax_step
from lr2rmats_tpu_torch.ops.chain import (K_MAX_A, chain_dp_reference,
                                          chain_params_for_kernel,
                                          check_anchor_width)
from lr2rmats_tpu_torch.parallel.mesh import mesh_exchange_candidates
from tests.test_torch_distributed import free_port, group_env, run_group

RTOL = 1e-5
H = 4
WINDOWS = {"random": 64, "ties": 4, "straddle": 64}


def _cases():
    """(idx_hash, idx_pos, read_hash, read_qpos) per case, from seeds."""
    out = {}
    rng = np.random.default_rng(3)
    M, B, Q = 1024, 8, 16
    h = np.sort(rng.choice(2 ** 31, M, replace=False)).astype(np.uint32)
    h[M // 2 - 2: M // 2 + 2] = h[M // 2 - 2]      # a 4-run on the boundary
    pos = rng.integers(0, 10 ** 6, M).astype(np.int32)
    rh = rng.choice(h, (B, Q)).astype(np.uint32)
    rh[:, 0] = h[M // 2]
    rq = np.sort(rng.choice(1000, (B, Q)), axis=1).astype(np.int32)
    out["random"] = (h, pos, rh, rq)
    # equal positions under different hashes of both tp chunks, a window of
    # 4: the order of tied anchors decides which predecessors a DP step sees
    rng = np.random.default_rng(5)
    M, B, Q = 64, 4, 16
    h = np.sort(rng.choice(2 ** 32 - 1, M, replace=False)).astype(np.uint32)
    pos = (rng.integers(0, 24, M) * 40).astype(np.int32)
    rh = rng.choice(h, (B, Q)).astype(np.uint32)
    rq = (np.sort(rng.choice(400, (B, Q), replace=False), axis=1) * 3
          ).astype(np.int32)
    out["ties"] = (h, pos, rh, rq)
    # a 6-run across the chunk boundary: the sharded step takes 3 hits from
    # each chunk where one table would give the first 4, as in the reference
    rng = np.random.default_rng(7)
    M, B, Q = 256, 4, 8
    h = np.sort(rng.choice(2 ** 31, M, replace=False)).astype(np.uint32)
    h[M // 2 - 3: M // 2 + 3] = h[M // 2 - 3]
    pos = np.sort(rng.integers(0, 10 ** 5, M)).astype(np.int32)
    rh = rng.choice(h, (B, Q)).astype(np.uint32)
    rh[:, 2] = h[M // 2]
    rq = np.sort(rng.choice(600, (B, Q)), axis=1).astype(np.int32)
    out["straddle"] = (h, pos, rh, rq)
    return out


_WORKER = r"""
import json, sys, types
import numpy as np
import torch
import torch.distributed as dist
from lr2rmats_tpu.align.chain import ChainParams
from lr2rmats_tpu_torch.parallel import distributed as d
from lr2rmats_tpu_torch.parallel.mesh import (
    allgather_candidates, make_mesh, mesh_exchange_candidates,
    sharded_align_step)
torch.set_num_threads(1)
pid, nproc, coord, data, out = sys.argv[1:6]
pid, nproc = int(pid), int(nproc)
windows = json.loads(sys.argv[6])
if nproc > 1:
    d.init_multihost(coord, nproc, pid)
else:
    dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                            world_size=1, rank=0)
n_dp = n_tp = 2 if nproc == 4 else 1
mesh = make_mesh(n_dp, n_tp, "cpu")
cases = np.load(data)
res = {}
for name, window in windows.items():
    step = sharded_align_step(mesh, ChainParams(window=window), 4)
    args = [cases[f"{name}_{i}"] for i in range(4)]
    res[name] = step(*args).numpy()
info = {"coord": list(mesh.get_coordinate())}
# candidate all-gathers: 7 rows over dp (not divisible by 2)
rng = np.random.default_rng(11)
n, E = 7, 3
T = types.SimpleNamespace(
    n=n, exon_start=rng.integers(0, 1000, (n + 2, E)).astype(np.int32),
    exon_end=rng.integers(0, 1000, (n + 2, E)).astype(np.int32),
    exon_n=rng.integers(1, E + 1, n + 2).astype(np.int32),
    tid=rng.integers(0, 5, n + 2).astype(np.int32))
want = {k: getattr(T, k).copy() for k in ("exon_start", "exon_end",
                                          "exon_n", "tid")}
mesh_exchange_candidates(T, mesh)
info["exchange_identity"] = all(np.array_equal(getattr(T, k), v)
                                for k, v in want.items())
dp, rows = mesh.get_coordinate()[0], 8 // n_dp
sl = slice(dp * rows, (dp + 1) * rows)
got = allgather_candidates(mesh)(*(torch.from_numpy(want[k][:8][sl])
                                   for k in want))
info["allgather_identity"] = all(np.array_equal(g.numpy(), want[k][:8])
                                 for g, k in zip(got, want))
# guards, raised on every rank before any collective
step = sharded_align_step(mesh, None, 4)
h, pos, rh, rq = (cases[f"random_{i}"] for i in range(4))
big = pos.copy()
big[5] = 2 ** 30
for key, args in (("sentinel_error", (h, big, rh, rq)),
                  ("uneven_error", (h[:-1], pos[:-1], rh[:3], rq[:3]))):
    try:
        step(*args)
        info[key] = "none"
    except ValueError as e:
        info[key] = str(e)
try:
    make_mesh(2 * n_dp, n_tp, "cpu")
    info["mesh_error"] = "none"
except ValueError as e:
    info["mesh_error"] = str(e)
np.savez(f"{out}.{nproc}.{pid}.npz", **res)
with open(f"{out}.{nproc}.{pid}.json", "w") as f:
    json.dump(info, f)
d.end_multihost()
if dist.is_initialized():
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's steps on (2, 2) and (1, 1); per rank its scores and
    checks."""
    root = tmp_path_factory.mktemp("mesh")
    cases = _cases()
    data = root / "cases.npz"
    np.savez(data, **{f"{k}_{i}": a for k, v in cases.items()
                      for i, a in enumerate(v)})
    script = root / "worker.py"
    script.write_text(_WORKER)
    out = str(root / "res")
    win = json.dumps(WINDOWS)
    coord4, coord1 = (f"127.0.0.1:{free_port()}" for _ in range(2))
    cmds = [[sys.executable, str(script), str(pid), "4", coord4, str(data),
             out, win] for pid in range(4)]
    cmds.append([sys.executable, str(script), "0", "1", coord1, str(data),
                 out, win])
    run_group(cmds, group_env(), timeout=240)
    got = {}
    for nproc, pids in ((4, range(4)), (1, [0])):
        for pid in pids:
            with open(f"{out}.{nproc}.{pid}.json") as f:
                info = json.load(f)
            got[(nproc, pid)] = (dict(np.load(f"{out}.{nproc}.{pid}.npz")),
                                 info)
    return cases, got


@pytest.fixture(scope="module")
def jax_scores():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    mesh = jax_make_mesh(n_dp=2, n_tp=2)
    return {name: np.asarray(jax_step(mesh, ChainParams(window=w), H)(
        *_cases()[name])) for name, w in WINDOWS.items()}


@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_sharded_step_matches_jax(runs, jax_scores, name):
    """Every rank of the (2, 2) port mesh returns the JAX (2, 2) scores."""
    _, got = runs
    for pid in range(4):
        scores = got[(4, pid)][0][name]
        assert scores.dtype == np.float32 and scores.shape == \
            jax_scores[name].shape
        np.testing.assert_allclose(scores, jax_scores[name], rtol=RTOL)
    assert np.all(jax_scores[name] >= 15.0)


def test_sharded_step_matches_one_rank_exactly(runs):
    """(2, 2) == (1, 1) bit for bit where hash runs fit in H hits."""
    _, got = runs
    one = got[(1, 0)][0]["random"]
    for pid in range(4):
        np.testing.assert_array_equal(got[(4, pid)][0]["random"], one)


def test_mesh_coordinates_follow_ranks(runs):
    _, got = runs
    assert [got[(4, pid)][1]["coord"] for pid in range(4)] == \
        [[0, 0], [0, 1], [1, 0], [1, 1]]


def _anchors(case, n_tp, reverse_ties):
    """The sharded step's anchor rows in numpy, sorted by position with
    equal positions in shard-major order (reverse_ties: the opposite)."""
    h, pos, rh, rq = (np.asarray(a) for a in case)
    B, Q = rh.shape
    Ml = len(h) // n_tp
    rows = []
    for b in range(B):
        anc = []
        for s in range(n_tp):
            hs, ps = h[s * Ml: (s + 1) * Ml], pos[s * Ml: (s + 1) * Ml]
            for qi in range(Q):
                lo = int(np.searchsorted(hs, rh[b, qi]))
                for k in range(H):
                    if lo + k < Ml and hs[lo + k] == rh[b, qi]:
                        anc.append((int(ps[lo + k]), s, len(anc),
                                    int(rq[b, qi])))
        tie = (lambda a: (a[0], -a[1], a[2])) if reverse_ties else \
            (lambda a: (a[0], a[1], a[2]))
        rows.append(sorted(anc, key=tie))
    A = n_tp * Q * H
    qp = np.zeros((B, A), np.int32)
    gp = np.zeros((B, A), np.int32)
    n = np.array([len(r) for r in rows], np.int32)
    for b, r in enumerate(rows):
        gp[b, :len(r)] = [a[0] for a in r]
        qp[b, :len(r)] = [a[3] for a in r]
    return qp, gp, n


def test_tie_order_decides_the_ties_case(runs, jax_scores):
    """The stable-sort trap is live in the `ties` case: the shard-major
    order of equal positions gives the JAX scores, the reverse order does
    not."""
    cases, got = runs
    kp = chain_params_for_kernel(ChainParams(window=WINDOWS["ties"]))
    scores = {}
    for rev in (False, True):
        qp, gp, n = (torch.from_numpy(a) for a in
                     _anchors(cases["ties"], 2, rev))
        f, _ = chain_dp_reference(qp, gp, n, kp)
        valid = torch.arange(f.shape[1])[None, :] < n[:, None]
        scores[rev] = torch.where(valid, f, -1e18).max(1).values.numpy()
    np.testing.assert_allclose(scores[False], jax_scores["ties"], rtol=RTOL)
    assert not np.allclose(scores[True], jax_scores["ties"], rtol=RTOL)
    np.testing.assert_array_equal(got[(4, 0)][0]["ties"], scores[False])


def test_straddling_run_gives_hits_from_both_chunks(runs):
    """A 6-run across the chunk boundary gives 3 + 3 hits on (2, 2) where
    one table gives its first 4: the port keeps the reference's per-chunk
    hit window (its scores are those of the per-chunk anchors)."""
    cases, got = runs
    qp, gp, n2 = _anchors(cases["straddle"], 2, False)
    n1 = _anchors(cases["straddle"], 1, False)[2]
    assert np.all(n2 - n1 >= 2)
    kp = chain_params_for_kernel(ChainParams())
    f, _ = chain_dp_reference(*(torch.from_numpy(a) for a in (qp, gp, n2)),
                              kp)
    valid = torch.arange(f.shape[1])[None, :] < torch.from_numpy(n2)[:, None]
    want = torch.where(valid, f, -1e18).max(1).values.numpy()
    np.testing.assert_array_equal(got[(4, 0)][0]["straddle"], want)


def test_candidate_gathers_are_identity(runs):
    _, got = runs
    for key, (_, info) in got.items():
        assert info["exchange_identity"], key
        assert info["allgather_identity"], key


def test_step_guards(runs):
    _, got = runs
    for key, (_, info) in got.items():
        assert "idx_pos max 1073741824 >= 2**30" in info["sentinel_error"]
        assert "collide with the invalid-anchor sentinel" in \
            info["sentinel_error"]
        assert "needs 2 ranks" in info["mesh_error"] or \
            "needs 8 ranks" in info["mesh_error"]
    assert "split evenly over tp=2 and dp=2" in got[(4, 0)][1]["uneven_error"]
    assert got[(1, 0)][1]["uneven_error"] == "none"


def test_anchor_width_guard():
    """More than kMaxA anchors per row raise on CUDA, never falling back
    to the plain version; the CPU has no such limit."""
    check_anchor_width(K_MAX_A, torch.device("cuda"))
    with pytest.raises(ValueError, match="kMaxA"):
        check_anchor_width(K_MAX_A + 1, torch.device("cuda"))
    check_anchor_width(4 * K_MAX_A, torch.device("cpu"))


def test_exchange_without_mesh_is_noop():
    T = types.SimpleNamespace(n=3, exon_start=np.ones((3, 2), np.int32))
    assert mesh_exchange_candidates(T) is T
