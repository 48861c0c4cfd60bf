"""(dp, tp) device meshes, the sharded alignment step and the candidate
all-gather, on torch.distributed.

Counterpart of lr2rmats_tpu/parallel/mesh.py.  A mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the process
group, one rank per device:

  dp axis: long-read batches are data-parallel;
  tp axis: the minimizer hash table is sharded; each shard contributes its
           local seed hits, which are all-gathered before chaining.

Where the reference expresses the step with shard_map over devices of one
process, each rank here runs its own shard and the collectives are
explicit `dist.all_gather` calls over the mesh's dimension groups, with
the pieces put in mesh-coordinate order (jax's tiled all-gather order).
The chain DP is the port's DP-only kernel (ops/chain.py `chain_dp`,
csrc/chain.cu's DP-only kernel on CUDA tensors, its plain version on CPU
tensors), which takes any number of anchors a read, as the reference's
`_chain_score_local` does.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..align.chain import ChainParams
from ..ops.chain import (NEG, chain_dp, chain_dp_reference,
                         chain_params_for_kernel)

# invalid-anchor position on int32 lanes (reference mesh.py:125)
SENTINEL = 2 ** 30


def make_mesh(n_dp: Optional[int] = None, n_tp: int = 1,
              device_type: str = "cuda"):
    """A (dp, tp) DeviceMesh over every rank of the initialized process
    group; n_dp * n_tp must be its world size."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel/distributed.py init_multihost or "
                           "torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if n_dp is None:
        n_dp = world // n_tp
    if n_dp * n_tp != world:
        raise ValueError(f"mesh {n_dp}x{n_tp} needs {n_dp * n_tp} ranks, "
                         f"the process group has {world}")
    return init_device_mesh(device_type, (n_dp, n_tp),
                            mesh_dim_names=("dp", "tp"))


def _mesh_device(mesh) -> torch.device:
    """The device this rank's tensors of `mesh` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _dim(mesh, name: str):
    """(size, this rank's coordinate) of mesh dimension `name`."""
    d = mesh.mesh_dim_names.index(name)
    return mesh.size(d), mesh.get_coordinate()[d]


def _gather(t: torch.Tensor, mesh, name: str, axis: int) -> torch.Tensor:
    """Tiled all-gather of t over mesh dimension `name`: the pieces of
    every rank along that dimension, concatenated along `axis` in mesh
    coordinate order."""
    d = mesh.mesh_dim_names.index(name)
    group = mesh.get_group(name)
    parts = [torch.empty_like(t) for _ in range(mesh.size(d))]
    dist.all_gather(parts, t.contiguous(), group=group)
    # parts come in group-rank order; the mesh's own rank tensor says which
    # global rank holds each coordinate of this rank's line along `name`
    coord = list(mesh.get_coordinate())
    coord[d] = slice(None)
    line = mesh.mesh[tuple(coord)].tolist()
    group_ranks = dist.get_process_group_ranks(group)
    return torch.cat([parts[group_ranks.index(r)] for r in line], axis)


def sharded_align_step(mesh, chain_params: Optional[ChainParams] = None,
                       hits_per_seed: int = 4, plain: bool = False):
    """The multi-rank alignment step (the reference's contract).

    The returned callable takes the GLOBAL numpy arrays
      idx_hash [M]     uint32 sorted minimizer hashes (tp-sharded)
      idx_pos  [M]     int32 positions                (tp-sharded)
      read_hash [B, Q] uint32 per-read minimizer hashes (dp-sharded)
      read_qpos [B, Q] int32 per-read minimizer positions (dp-sharded)
    and returns the global float32 best chain score per read [B], on every
    rank.  Each rank looks up up to hits_per_seed hits per seed in its
    contiguous 1/n_tp of the table (so a hash run that straddles a chunk
    boundary gives hits from both chunks, as in the reference), the
    anchors are all-gathered over tp and stably sorted by position, the
    chain DP runs, and the per-read max over the valid anchors is
    all-gathered over dp.  Rows without an anchor score -1e18.

    Any Q * H: the DP is csrc/chain.cu's DP-only kernel, which has no
    anchor cap.
    plain=True runs the DP's plain PyTorch version (chain_dp_reference)
    on the same device instead of the kernel, to hold one against the
    other.  Hashes are compared as int64 on the device, which keeps the
    uint32 order."""
    kp = chain_params_for_kernel(chain_params or ChainParams())
    H = hits_per_seed
    n_dp, i_dp = _dim(mesh, "dp")
    n_tp, i_tp = _dim(mesh, "tp")
    dev = _mesh_device(mesh)

    def step(idx_hash, idx_pos, read_hash, read_qpos) -> torch.Tensor:
        idx_hash = np.asarray(idx_hash)
        idx_pos = np.asarray(idx_pos)
        read_hash = np.asarray(read_hash)
        read_qpos = np.asarray(read_qpos)
        mx = int(np.max(idx_pos)) if len(idx_pos) else 0
        if mx >= SENTINEL:
            raise ValueError(
                f"sharded_align_step: idx_pos max {mx} >= 2**30 — global "
                "positions past ~1 Gbp collide with the invalid-anchor "
                "sentinel on int32 lanes.  Human-scale genomes go through "
                "the production cluster-relative chain path "
                "(align/batch.py), not this mesh validation kernel.")
        M = len(idx_hash)
        B, Q = read_hash.shape
        if M == 0 or M % n_tp or B % n_dp:
            raise ValueError(
                f"sharded_align_step: {M} index entries and {B} reads must "
                f"split evenly over tp={n_tp} and dp={n_dp} (and the index "
                "must not be empty)")
        A = n_tp * Q * H        # anchors per read after the tp gather
        Ml, Bl = M // n_tp, B // n_dp

        def local(a, n, i, dtype):
            return torch.from_numpy(np.ascontiguousarray(
                a[i * n: (i + 1) * n], dtype)).to(dev)

        h = local(idx_hash, Ml, i_tp, np.int64)
        pos = local(idx_pos, Ml, i_tp, np.int32)
        rh = local(read_hash, Bl, i_dp, np.int64)
        rq = local(read_qpos, Bl, i_dp, np.int32)
        lo = torch.searchsorted(h, rh.reshape(-1)).reshape(Bl, Q)
        hit = lo[:, :, None] + torch.arange(H, device=dev)
        ok = hit < Ml
        hit = hit.clamp(max=Ml - 1)
        ok &= h[hit] == rh[:, :, None]
        gpos = torch.where(ok, pos[hit], SENTINEL).to(torch.int32)
        qpos = rq[:, :, None].expand(Bl, Q, H)
        gpos, qpos, ok = (_gather(t.reshape(Bl, Q * H), mesh, "tp", 1)
                          for t in (gpos, qpos, ok.to(torch.uint8)))
        # stable, as jnp.argsort: anchors of equal position keep their
        # shard-major order, which decides window membership
        order = torch.argsort(gpos, dim=1, stable=True)
        gpos = gpos.gather(1, order)
        qpos = qpos.gather(1, order)
        n_anchor = ok.gather(1, order).sum(1, dtype=torch.int32)
        dp = chain_dp_reference if plain else chain_dp
        f, _ = dp(qpos, gpos, n_anchor, kp)
        valid = torch.arange(A, device=dev)[None, :] < n_anchor[:, None]
        scores = torch.where(valid, f, NEG).max(1).values
        return _gather(scores, mesh, "dp", 0)

    return step


def allgather_candidates(mesh):
    """All-gather per-rank candidate transcript tensors over dp, rows in
    (shard, ordinal) order: the collective of the `cat *.gtf | unique-gtf`
    gather (reference Snakefile:189-192).  The callable takes this rank's
    (exon_start [n, E], exon_end [n, E], exon_n [n], tid [n]) tensors and
    returns the gathered four; a no-op on one dp rank."""
    n_dp, _ = _dim(mesh, "dp")

    def gather(exon_start, exon_end, exon_n, tid):
        if n_dp == 1:
            return exon_start, exon_end, exon_n, tid
        return tuple(_gather(x, mesh, "dp", 0)
                     for x in (exon_start, exon_end, exon_n, tid))

    return gather


def mesh_exchange_candidates(T, mesh=None):
    """Run a candidate-transcript set T (full on every rank) through the
    dp all-gather, in place: rows padded to the dp size, this rank's dp
    slice gathered from every rank, and written back in (shard, ordinal)
    order, which is the host order again.  A no-op without a mesh, on one
    dp rank or for an empty set."""
    if mesh is None or T.n == 0 or _dim(mesh, "dp")[0] == 1:
        return T
    n_dp, i_dp = _dim(mesh, "dp")
    dev = _mesh_device(mesh)
    n = T.n
    rows = (n + n_dp - 1) // n_dp

    def mine(a) -> torch.Tensor:
        a = np.asarray(a[:n])
        pad = np.zeros((rows * n_dp - n,) + a.shape[1:], a.dtype)
        full = np.concatenate([a, pad], 0)
        return torch.from_numpy(np.ascontiguousarray(
            full[i_dp * rows: (i_dp + 1) * rows])).to(dev)

    out: List[torch.Tensor] = allgather_candidates(mesh)(
        mine(T.exon_start), mine(T.exon_end), mine(T.exon_n), mine(T.tid))
    ges, gee, gen, gtid = (x.cpu().numpy() for x in out)
    T.exon_start[:n] = ges[:n]
    T.exon_end[:n] = gee[:n]
    T.exon_n[:n] = gen[:n]
    T.tid[:n] = gtid[:n]
    return T

