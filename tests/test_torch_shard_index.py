"""Port sharded index (lr2rmats_tpu_torch/parallel/shard_index.py): the
multi-process arm on a 2-process gloo group against the single-process
full-index run of the reference.

Each process builds only its hash range (`local_shard=pid`), with the
occurrence cap reduced over the group, and a `TorchBatchAligner(device=
"cpu")` drives its half of the reads through the collective lookup in
lockstep (`dispatch_batch` / `finish_batch`).  The primary records must
equal the reference host backend's over the full index, exactly.
"""

import json
import sys

import numpy as np
import pytest

from lr2rmats_tpu.index.minimizer import K_DEFAULT, W_DEFAULT, MinimizerIndex
from lr2rmats_tpu.io.fasta import Genome
from lr2rmats_tpu_torch.parallel.shard_index import ShardedMinimizerIndex
from tests.test_shard_index import _genome
from tests.test_torch_distributed import free_port, group_env, run_group

# a 1 Mb genome with pasted repeats where the cap at this occurrence
# fraction is 10 over the whole table but 9 over hash range 0 alone
CAP_GENOME = dict(seed=3, mb=1.0, repeats=200)
CAP_ARGS = dict(max_occ_frac=3e-4, min_max_occ=1)


def _lookup_genome():
    """The reference's tests/test_shard_index.py two-process workload."""
    import bench
    rng = np.random.default_rng(31)
    n = 2_000_000
    codes = rng.integers(0, 4, n).astype(np.uint8)
    genome = Genome(["c1"], codes, np.array([0, n], np.int64))
    reads, _ = bench.simulate_reads(genome, 64, rng, err=0.01)
    return genome, reads


def primaries(recs):
    return sorted(r.qname + " " + str(r.pos) + " " +
                  " ".join(str(c) for c in r.cigar) for r in recs
                  if not (r.flag & 0x100))


_WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
from lr2rmats_tpu_torch.parallel.distributed import (end_multihost,
                                                     init_multihost)
from tests.test_torch_shard_index import (CAP_ARGS, CAP_GENOME,
                                          _lookup_genome, primaries)
from tests.test_shard_index import _genome
from lr2rmats_tpu_torch.align.batch import TorchBatchAligner
from lr2rmats_tpu_torch.parallel.shard_index import ShardedMinimizerIndex
pid, coord, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
init_multihost(coord, 2, pid)
cap_idx = ShardedMinimizerIndex.build(_genome(**CAP_GENOME)[0], 2,
                                      local_shard=pid, **CAP_ARGS)
genome, reads = _lookup_genome()
names = [f"r{i}" for i in range(len(reads))]
idx = ShardedMinimizerIndex.build(genome, 2, local_shard=pid)
al = TorchBatchAligner(genome, index=idx, device="cpu")
try:
    al.align_seqset_packed(None)
    refused = ""
except ValueError as e:
    refused = str(e)
my_names, my_reads = names[pid::2], reads[pid::2]
recs = []
for off in range(0, len(my_reads), 16):
    h = al.dispatch_batch(my_names[off: off + 16], my_reads[off: off + 16])
    recs.extend(al.finish_batch(h))
with open(f"{out}.{pid}.json", "w") as f:
    json.dump({"primaries": primaries(recs), "cap": cap_idx.max_occ,
               "resident": idx.resident_bytes(), "refused": refused,
               "q_mb": idx.coll_stats["q_mb"],
               "a_mb": idx.coll_stats["a_mb"]}, f)
end_multihost()
"""


@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    root = tmp_path_factory.mktemp("shard")
    script = root / "worker.py"
    script.write_text(_WORKER)
    out = str(root / "res")
    coord = f"127.0.0.1:{free_port()}"
    run_group([[sys.executable, str(script), str(pid), coord, out]
               for pid in range(2)], group_env(), timeout=300)
    res = []
    for pid in range(2):
        with open(f"{out}.{pid}.json") as f:
            res.append(json.load(f))
    return res


def test_collective_lookup_matches_full_index(two_process):
    """Primaries of the lockstep 2-process run == the reference host
    backend on the full index, per process half."""
    from lr2rmats_tpu.align.batch import BatchAligner
    genome, reads = _lookup_genome()
    names = [f"r{i}" for i in range(len(reads))]
    al = BatchAligner(genome, index=MinimizerIndex.build(genome),
                      backend="host")
    for pid in range(2):
        my_names, my_reads = names[pid::2], reads[pid::2]
        recs = []
        for off in range(0, len(my_reads), 16):
            recs.extend(al.align_batch(my_names[off: off + 16],
                                       my_reads[off: off + 16]))
        want = primaries(recs)
        assert len(want) > 20
        assert two_process[pid]["primaries"] == want
        assert two_process[pid]["q_mb"] > 0 and two_process[pid]["a_mb"] > 0


def test_local_build_cap_equals_unsharded(two_process):
    """The occurrence cap of each local shard is the unsharded table's
    (the histogram is summed over the group), where shard 0's own
    histogram alone would give another."""
    genome = _genome(**CAP_GENOME)[0]
    full = MinimizerIndex.build(genome, **CAP_ARGS)
    hist0 = MinimizerIndex._extract_sorted(genome, K_DEFAULT, W_DEFAULT,
                                           (0, 2))[3]
    assert MinimizerIndex.occ_cap_from_hist(hist0, **CAP_ARGS) != \
        full.max_occ
    assert [r["cap"] for r in two_process] == [full.max_occ] * 2


def test_each_process_holds_half_the_table(two_process):
    genome, _ = _lookup_genome()
    full = MinimizerIndex.build(genome)
    full_bytes = full.hashes.nbytes + full.pos.nbytes + full.strand.nbytes
    for r in two_process:
        assert 0.3 * full_bytes < r["resident"] < 0.7 * full_bytes


def test_packed_alignment_refuses_local_index(two_process):
    for r in two_process:
        assert "local_only" in r["refused"]


def test_in_process_build_is_the_reference():
    """local_shard=None is the reference's in-process arm: every shard
    resident, the same tables and cap."""
    from lr2rmats_tpu.parallel.shard_index import \
        ShardedMinimizerIndex as RefShardedMinimizerIndex
    genome = _genome(seed=9, mb=0.5, repeats=40)[0]
    port = ShardedMinimizerIndex.build(genome, 3)
    ref = RefShardedMinimizerIndex.build(genome, 3)
    assert type(port) is ShardedMinimizerIndex and not port.local_only
    assert port.max_occ == ref.max_occ
    for a, b in zip(port.shards, ref.shards):
        assert np.array_equal(a.hashes, b.hashes)
        assert np.array_equal(a.pos, b.pos)


def test_single_process_local_build_and_shard_guard():
    """A local shard outside a group keeps its own histogram, and the
    collective lookup refuses to run with fewer processes than shards."""
    genome = _genome(**CAP_GENOME)[0]
    idx = ShardedMinimizerIndex.build(genome, 2, local_shard=0, **CAP_ARGS)
    hist0 = MinimizerIndex._extract_sorted(genome, K_DEFAULT, W_DEFAULT,
                                           (0, 2))[3]
    assert idx.max_occ == MinimizerIndex.occ_cap_from_hist(hist0,
                                                           **CAP_ARGS)
    with pytest.raises(ValueError, match="one process per shard"):
        idx.lookup_collective(idx.shards[0].hashes[:5])
