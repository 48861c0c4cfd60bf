"""Port seed lookup (lr2rmats_tpu_torch/index/seed_device.py) against the
JAX reference's DeviceSeedLookup and the host MinimizerIndex.lookup on the
CPU: (lo, hi) ranges exact on a fuzz set of present, absent and repeated
hashes and the empty query; the same supports gate; and its wiring in
TorchBatchAligner under LR2RMATS_DEVICE_SEED=1.  The card-against-CPU test
is in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest

from lr2rmats_tpu.index.minimizer import MinimizerIndex
from lr2rmats_tpu.index.seed_device import DeviceSeedLookup
from lr2rmats_tpu_torch.align.batch import TorchBatchAligner
from lr2rmats_tpu_torch.index.seed_device import TorchSeedLookup
from tests.test_seed_device import _genome
from tests.test_torch_chain import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def genome_index():
    genome, _ = _genome()
    return genome, MinimizerIndex.build(genome)


@pytest.mark.parametrize("nq", [0, 1, 7, 1000, 4096, 5000])
def test_lookup_equals_reference_and_host(genome_index, nq):
    _, idx = genome_index
    rng = np.random.default_rng(nq)
    present = rng.choice(idx.hashes, size=nq // 2) if nq else \
        np.zeros(0, np.uint64)
    absent = rng.integers(0, 1 << (2 * idx.k), size=nq - len(present)
                          ).astype(np.uint64)
    q = np.concatenate([present, absent])
    rng.shuffle(q)
    port = TorchSeedLookup(idx, "cpu")
    lo, hi = port.lookup(q)
    assert lo.dtype == hi.dtype == np.int64
    for want in (idx.lookup(q), DeviceSeedLookup(idx).lookup(q)):
        np.testing.assert_array_equal(lo, want[0])
        np.testing.assert_array_equal(hi, want[1])
    assert port.calls == (1 if nq else 0)


def test_supports_gate():
    h = np.sort(np.random.default_rng(0).integers(
        0, 1 << 30, 100).astype(np.uint64))
    args = (h, np.arange(100, dtype=np.int64), np.zeros(100, np.int8),
            np.array([0, 10**6], np.int64), ["c"], 250)
    idx15, idx16 = MinimizerIndex(15, 5, *args), MinimizerIndex(16, 5, *args)
    assert TorchSeedLookup.supports(idx15) == DeviceSeedLookup.supports(idx15)
    assert TorchSeedLookup.supports(idx15)
    assert not TorchSeedLookup.supports(idx16)
    with pytest.raises(ValueError):
        TorchSeedLookup(idx16, "cpu")


def test_aligner_installs_lookup_only_under_switch(genome_index,
                                                   monkeypatch):
    genome, idx = genome_index
    monkeypatch.delenv("LR2RMATS_DEVICE_SEED", raising=False)
    assert TorchBatchAligner(genome, index=idx,
                             device="cpu")._seed_lookup is None
    monkeypatch.setenv("LR2RMATS_DEVICE_SEED", "1")
    al = TorchBatchAligner(genome, index=idx, device="cpu")
    assert isinstance(al._seed_lookup, TorchSeedLookup)
    assert al._seed_lookup.device.type == "cpu"


def test_sharded_index_keeps_collective_path(monkeypatch):
    """A sharded index has no flat table: the switch leaves its routed
    host lookup in place."""
    from lr2rmats_tpu.parallel.shard_index import ShardedMinimizerIndex
    genome, _ = _genome(seed=11, mb=0.5, repeats=5)
    sh = ShardedMinimizerIndex.build(genome, 2)
    monkeypatch.setenv("LR2RMATS_DEVICE_SEED", "1")
    assert TorchBatchAligner(genome, index=sh,
                             device="cpu")._seed_lookup is None
