"""Port device junction DP (lr2rmats_tpu_torch/ops/junction.py) against
the JAX reference (lr2rmats_tpu/ops/splice_device.py) on the CPU.

The batch packing and op recovery equal the reference's; the plain combine
equals JAX `_combine` on all six outputs and every lane, not-found lanes
included; `junction_place` (both flank DPs and the combine, the slice's
fused path; its plain version here) equals JAX `_junction_scan`, on the
batches of the aligner's recipe and on the junction kernel's edge
batches; the whole junction batch equals both reference backends (the
lax.scan one and the Pallas kernel in interpret mode); and the aligner with
the device junction backend emits the reference's SAM bytes.  Every
comparison is exact: the scores are integers or multiples of 3/8.  The
kernel-against-plain tests are in tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lr2rmats_tpu.align.batch import BatchAligner
from lr2rmats_tpu.ops import splice_device as sd
from lr2rmats_tpu_torch.align.batch import TorchBatchAligner
from lr2rmats_tpu_torch.ops import junction as J
from lr2rmats_tpu_torch.ops.splice import shift_dp
from tests.test_torch_chain import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_kernels import (JUNCTION_EDGES, junction_edge_batch,
                                      junction_gaps)

CASES = [("random", 300), ("ties", 120), ("m0", 30)]


def _flank_dps(batch):
    t = {k: torch.from_numpy(batch[k]) for k in ("q", "qr", "lwin", "rwin",
                                                 "m")}
    return (shift_dp(t["q"], t["lwin"], t["m"], 4),
            shift_dp(t["qr"], t["rwin"], t["m"], 4))


@pytest.mark.parametrize("kind,G", CASES)
def test_prepare_junction_batch_matches_reference(kind, G):
    ref, gaps = junction_gaps(G, G, kind)
    want = sd.prepare_junction_batch(ref, gaps)
    got = J.prepare_junction_batch(ref, gaps)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    assert J.prepare_junction_batch(ref, []) is None


@pytest.mark.parametrize("kind,G", CASES)
@pytest.mark.parametrize("min_intron", [30, 2000])
def test_combine_reference_matches_jax(kind, G, min_intron):
    ref, gaps = junction_gaps(G + 1, G, kind)
    b = J.prepare_junction_batch(ref, gaps)
    SL, SR = _flank_dps(b)
    want = sd._combine(jnp.asarray(SL.numpy()), jnp.asarray(SR.numpy()),
                       jnp.asarray(b["m"]), jnp.asarray(b["span"]),
                       jnp.asarray(b["dok"]), jnp.asarray(b["aok"]),
                       jnp.asarray(b["el"]), jnp.asarray(b["er"]), 4,
                       jnp.int64(min_intron))
    t = {k: torch.from_numpy(b[k]) for k in ("m", "span", "dok", "aok",
                                             "el", "er")}
    got = J.combine_reference(SL, SR, t["m"], t["span"], t["dok"], t["aok"],
                              t["el"], t["er"], 4, min_intron)
    for name, g, w in zip(("score", "j", "cl", "cr", "vote", "found"), got,
                          want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    found = got[5].numpy()
    if min_intron == 2000 or kind == "random":
        assert not found.all()          # not-found lanes are compared too
    if kind != "ties" and min_intron == 30:
        assert found.any()


def _jax_junction_scan(arrays, min_intron):
    return sd._junction_scan(*(jnp.asarray(a) for a in arrays), 4,
                             jnp.int64(min_intron))


def _assert_same(got, want):
    for name, g, w in zip(("score", "j", "cl", "cr", "vote", "found"), got,
                          want):
        assert g.numpy().dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("kind,G", CASES)
@pytest.mark.parametrize("min_intron", [30, 2000])
def test_junction_place_matches_jax(kind, G, min_intron):
    """junction_place on the CPU == JAX _junction_scan bit for bit on all
    six outputs, not-found lanes included."""
    ref, gaps = junction_gaps(G + 4, G, kind)
    b = J.prepare_junction_batch(ref, gaps)
    arrays = [b[k] for k in ("q", "qr", "lwin", "rwin", "m", "span", "dok",
                             "aok", "el", "er")]
    got = J.junction_place(*(torch.from_numpy(a) for a in arrays), 4,
                           min_intron)
    _assert_same(got, _jax_junction_scan(arrays, min_intron))
    if min_intron == 2000 or kind == "random":
        assert not got[5].all()
    if kind != "ties" and min_intron == 30:
        assert got[5].any()


@pytest.mark.parametrize("kind", JUNCTION_EDGES)
def test_junction_place_edges_match_jax(kind):
    """The junction kernel's edge batches (tests/test_torch_kernels.py
    junction_edge_batch) through junction_place on the CPU == JAX
    _junction_scan."""
    arrays = junction_edge_batch(kind, 37, 5, 30)
    got = J.junction_place(*(torch.from_numpy(a) for a in arrays), 4, 30)
    _assert_same(got, _jax_junction_scan(arrays, 30))


def test_combine_chunks_agree():
    """The plain version's gap chunks give the one-pass result."""
    ref, gaps = junction_gaps(9, 70, "random")
    b = J.prepare_junction_batch(ref, gaps)
    SL, SR = _flank_dps(b)
    args = [torch.from_numpy(b[k]) for k in ("m", "span", "dok", "aok",
                                             "el", "er")]
    whole = J.combine_reference(SL, SR, *args, 4, 30)
    chunk = J._REF_CHUNK
    try:
        J._REF_CHUNK = 16
        parts = J.combine_reference(SL, SR, *args, 4, 30)
    finally:
        J._REF_CHUNK = chunk
    for a, c in zip(whole, parts):
        assert torch.equal(a, c)


def test_junction_place_rejects_bad_inputs():
    ref, gaps = junction_gaps(1, 8, "random")
    b = J.prepare_junction_batch(ref, gaps)
    t = [torch.from_numpy(b[k]) for k in ("q", "qr", "lwin", "rwin", "m",
                                          "span", "dok", "aok", "el", "er")]
    with pytest.raises(ValueError, match="band"):
        J.junction_place(*t, 8, 30)
    bad = list(t)
    bad[5] = bad[5].to(torch.int32)
    with pytest.raises(ValueError, match="span"):
        J.junction_place(*bad, 4, 30)
    bad = list(t)
    bad[2] = bad[2][:-1]                            # lwin must be [M+B, G]
    with pytest.raises(ValueError, match="lwin"):
        J.junction_place(*bad, 4, 30)
    bad = list(t)
    bad[0] = bad[0].to(torch.int8)                  # q must be int32
    with pytest.raises(ValueError, match="q must"):
        J.junction_place(*bad, 4, 30)
    bad = list(t)
    bad[9] = bad[9].to("meta")
    with pytest.raises(ValueError, match="one device"):
        J.junction_place(*bad, 4, 30)


@pytest.mark.parametrize("kind,G", CASES)
def test_junction_batch_matches_scan_and_pallas(kind, G):
    ref, gaps = junction_gaps(G + 2, G, kind)
    b = J.prepare_junction_batch(ref, gaps)
    got = J.junction_batch(b, 30, "cpu")
    scan = sd.junction_batch_scan(sd.prepare_junction_batch(ref, gaps), 30)
    pallas = sd.junction_batch_pallas(sd.prepare_junction_batch(ref, gaps),
                                      30, interpret=True)
    for g, s, p in zip(got, scan, pallas):
        np.testing.assert_array_equal(g, np.asarray(s))
        np.testing.assert_array_equal(g, np.asarray(p))


@pytest.mark.parametrize("kind,G", CASES)
def test_recover_ops_matches_reference(kind, G):
    ref, gaps = junction_gaps(G + 3, G, kind)
    placements = J.junction_batch(J.prepare_junction_batch(ref, gaps), 30,
                                  "cpu")
    want = sd.recover_ops(ref, gaps, placements)
    got = J.recover_ops(ref, gaps, placements)
    assert got == want
    assert any(r is not None for r in got) or kind == "ties"


@pytest.mark.parametrize("seed_env", [None, "1"])
def test_aligner_device_junctions_sam_matches(monkeypatch, seed_env):
    """TorchBatchAligner(junction_backend="device") on the CPU, with and
    without the device seed lookup, emits the SAM bytes of the reference's
    device junction backend on JAX CPU and of its host backend."""
    import bench
    if seed_env:
        monkeypatch.setenv("LR2RMATS_DEVICE_SEED", seed_env)
    else:
        monkeypatch.delenv("LR2RMATS_DEVICE_SEED", raising=False)
    rng = np.random.default_rng(123)
    g = bench.build_genome(1_000_000, rng)
    reads, _ = bench.simulate_reads(g, 160, rng, profile="ont")
    ss = bench._pack(reads, [f"read{i}" for i in range(len(reads))])
    host = BatchAligner(g, backend="host", junction_backend="host")
    monkeypatch.delenv("LR2RMATS_DEVICE_SEED", raising=False)
    ref = BatchAligner(g, backend="jax", junction_backend="device",
                       index=host.index)
    if seed_env:
        monkeypatch.setenv("LR2RMATS_DEVICE_SEED", seed_env)
    port = TorchBatchAligner(g, index=host.index, device="cpu",
                             junction_backend="device")
    assert (port._seed_lookup is not None) == bool(seed_env)
    got = port.align_seqset_packed(ss).emit_sam(port.refs)
    assert got == ref.align_seqset_packed(ss).emit_sam(ref.refs)
    assert got == host.align_seqset_packed(ss).emit_sam(host.refs)
    st = port.stats
    assert st["junction_calls"] > 0
    assert st["junction_gaps"] >= st["junction_found"] > 0
    assert (st["seed_lookup_calls"] > 0) == bool(seed_env)
    assert st["junction_kernel_launches"] == 0      # plain versions on CPU
