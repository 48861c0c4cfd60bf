"""Port junction counting (lr2rmats_tpu_torch/junctions/) against the JAX
reference on the CPU: the Hamming verifier equals the reference verifier
on every candidate (windows past the buffer end included) and the native
hamming_pairs_c on in-range ones; TorchCounts drops the sentinel id; the
port's counter equals both reference backends, single-end and paired.  All
comparisons are integer and exact.  The kernel-against-plain test is in
tests/test_torch_kernels.py.
"""

import numpy as np
import pytest

from lr2rmats_tpu.junctions.sjcount import JunctionCounter
from lr2rmats_tpu.junctions.sjcount_device import DeviceCounts, make_verifier
from lr2rmats_tpu_torch.junctions.sjcount import (TorchJunctionCounter,
                                                  count_junction_support)
from lr2rmats_tpu_torch.junctions.sjcount_device import (TorchCounts,
                                                         TorchHammingVerifier)
from tests.test_sjcount_device import _synthetic_workload, mk_reads
from tests.test_torch_chain import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_host import reference_native_library


def _candidates(seed, n_buf=5000, n_seg=17, C=600):
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 4, n_buf).astype(np.uint8)
    segs = [rng.integers(0, 4, int(rng.integers(30, 300))).astype(np.uint8)
            for _ in range(n_seg)]
    comb = np.concatenate(segs)
    comb_off = np.zeros(n_seg + 1, np.int64)
    np.cumsum([len(s) for s in segs], out=comb_off[1:])
    rid = rng.integers(0, n_seg, C).astype(np.int32)
    lens = np.diff(comb_off)
    pos = np.array([rng.integers(0, n_buf - lens[r]) for r in rid], np.int64)
    past = rng.random(C) < 0.1                        # windows past the end
    pos[past] = n_buf - rng.integers(1, 30, int(past.sum()))
    return buf, comb, comb_off, rid, pos, past


@pytest.mark.parametrize("seed", [2, 3])
def test_verifier_equals_reference_and_native(seed, monkeypatch):
    import lr2rmats_tpu.native.lib as ref_lib
    buf, comb, comb_off, rid, pos, past = _candidates(seed)
    got = TorchHammingVerifier(buf, "cpu").verify(comb, comb_off, rid, pos)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, make_verifier(buf).verify(comb, comb_off, rid, pos))
    reference_native_library(monkeypatch)
    lib = ref_lib.get_lib()
    mm = np.empty(len(rid), np.int32)
    lib.hamming_pairs_c(buf, len(buf), comb, comb_off, rid, pos, len(rid),
                        mm)
    np.testing.assert_array_equal(got[~past], mm[~past])
    assert past.any()


def test_verifier_empty_and_chunked(monkeypatch):
    from lr2rmats_tpu_torch.junctions import sjcount_device
    buf, comb, comb_off, rid, pos, _ = _candidates(4)
    v = TorchHammingVerifier(buf, "cpu")
    whole = v.verify(comb, comb_off, rid, pos)
    monkeypatch.setattr(sjcount_device, "_REF_CHUNK", 16)
    np.testing.assert_array_equal(whole, v.verify(comb, comb_off, rid, pos))
    assert v.verify(comb, comb_off, rid[:0], pos[:0]).shape == (0,)


def test_counts_drop_sentinel_ids():
    n = 5
    cc = np.array([0, 4, 5, 5, 2, 9, 2, 4])        # 5 is the sentinel n
    u = np.array([1, 0, 1, 0, 1, 1, 0, 1], bool)
    over = np.array([3, 7, 99, 99, 1, 99, 6, 2], np.int32)
    port = TorchCounts(n, "cpu")
    ref = DeviceCounts(n)
    for c in (port, ref):
        c.add(cc, u, over)
        c.add(cc[:3], u[:3], over[:3])
        c.add(cc[:0], u[:0], over[:0])
    for a, b in zip(port.fetch(), ref.fetch()):
        np.testing.assert_array_equal(a, b)
    uniq, multi, mx = port.fetch()
    assert uniq.tolist() == [2, 0, 1, 0, 1]
    assert multi.tolist() == [0, 0, 1, 0, 2]
    assert mx.tolist() == [3, 0, 6, 0, 7]
    with pytest.raises(ValueError):
        port.add(np.array([-1]), np.array([True]), np.array([1], np.int32))


def _results(jc):
    r = jc.result()
    return r.uniq_c, r.multi_c, r.max_over


def test_counter_single_end_matches_both_backends():
    g, tid, don, acc, anno, rs = _synthetic_workload()
    port = TorchJunctionCounter(g, tid, don, acc, anno, device="cpu")
    assert port.backend == "device"
    port.count_seqset_batched(rs)
    got = _results(port)
    for backend in ("host", "device"):
        ref = JunctionCounter(g, tid, don, acc, anno, backend=backend)
        ref.count_seqset_batched(rs)
        for a, b in zip(got, _results(ref)):
            np.testing.assert_array_equal(a, b)
    assert got[0].sum() + got[1].sum() > 50


def test_counter_paired_matches_both_backends():
    from lr2rmats_tpu.io.fasta import revcomp
    g, tid, don, acc, anno, _ = _synthetic_workload(seed=9)
    rng = np.random.default_rng(10)
    m1, m2 = [], []
    for _ in range(100):
        d, a = 2001, 5000
        left = int(rng.integers(10, 80))
        m1.append(np.concatenate([g.codes[d - 1 - left: d - 1],
                                  g.codes[a: a + (101 - left)]]).copy())
        p = a + int(rng.integers(120, 220))
        m2.append(revcomp(g.codes[p: p + 101]).copy())
    r1, r2 = mk_reads(m1), mk_reads(m2)
    port = TorchJunctionCounter(g, tid, don, acc, anno, device="cpu")
    port.count_pairs_batched(r1, r2)
    got = _results(port)
    for backend in ("host", "device"):
        ref = JunctionCounter(g, tid, don, acc, anno, backend=backend)
        ref.count_pairs_batched(r1, r2)
        for a, b in zip(got, _results(ref)):
            np.testing.assert_array_equal(a, b)
    assert got[0].sum() > 0


def test_count_junction_support_switch(monkeypatch):
    """LR2RMATS_DEVICE_SJCOUNT selects the port's counter, as in the
    reference; both give the reference's table."""
    from lr2rmats_tpu.junctions.sjcount import \
        count_junction_support as ref_count
    from lr2rmats_tpu.transcript.model import Transcripts
    from lr2rmats_tpu_torch.junctions import sjcount as port_sj
    g, tid, don, acc, anno, rs = _synthetic_workload()
    T = Transcripts()
    # one two-intron transcript carrying the workload's junctions
    T.append(0, False, [1001, 5001, 44001], [2000, 30000, 45000])
    monkeypatch.delenv("LR2RMATS_DEVICE_SJCOUNT", raising=False)
    want = ref_count(g, [T], [rs])
    made = []
    real = port_sj.TorchJunctionCounter

    def spy(*a, **k):
        made.append(1)
        return real(*a, **k)

    monkeypatch.setattr(port_sj, "TorchJunctionCounter", spy)
    host = count_junction_support(g, [T], [rs], device="cpu")
    assert not made
    monkeypatch.setenv("LR2RMATS_DEVICE_SJCOUNT", "1")
    dev = count_junction_support(g, [T], [rs], device="cpu")
    assert made
    for t in (host, dev):
        for f in ("don", "acc", "uniq_c", "multi_c", "max_over"):
            np.testing.assert_array_equal(getattr(t, f), getattr(want, f))
    assert want.uniq_c.sum() > 0
