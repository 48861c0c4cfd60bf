"""Multi-process runs: the torch.distributed process group and the
cross-process gather of byte payloads.

Counterpart of lr2rmats_tpu/parallel/distributed.py, with the same names,
the same `_STATE` bookkeeping and the same single-process short cuts.  Each
process of a group owns a round-robin shard of the samples, runs them on
its own device, and the pass-2 candidate GTFs are all-gathered so that
process 0 writes the cross-sample merge (the reference's qsub jobs and
shared-filesystem `cat`, Snakefile:172-192).

The group is `torch.distributed` with two backends: host payloads (byte
blobs, the barrier) travel as CPU tensors over gloo, CUDA tensors (the mesh
collectives of parallel/mesh.py) over NCCL.  A torch build without NCCL
(the CPU-only wheels) gets a gloo-only group, where a CUDA collective is
impossible anyway.  Nothing switches backend when a collective fails: the
error stops the run.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# process-group state, set by init_multihost / adopt_multihost, so that a
# single-process run never touches torch.distributed
_STATE: Dict[str, int] = {"process_id": 0, "num_processes": 1}


def backend() -> str:
    """The backend string of the group init_multihost creates."""
    import torch.distributed as dist
    return "cpu:gloo,cuda:nccl" if dist.is_nccl_available() else "gloo"


def free_port() -> int:
    """A TCP port on localhost that is free now, for a coordinator."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_multihost(coordinator: str, num_processes: int,
                   process_id: int) -> None:
    """Join the process group whose rendezvous is `coordinator`
    (host:port, served by process 0).  A no-op for one process."""
    if num_processes <= 1:
        return
    import torch.distributed as dist
    dist.init_process_group(backend=backend(),
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    _STATE["process_id"] = process_id
    _STATE["num_processes"] = num_processes


def adopt_multihost() -> None:
    """Record a process group the launcher initialized itself."""
    import torch.distributed as dist
    _STATE["process_id"] = dist.get_rank()
    _STATE["num_processes"] = dist.get_world_size()


def end_multihost() -> None:
    """Leave the process group init_multihost joined (a no-op outside
    one)."""
    if _STATE["num_processes"] <= 1:
        return
    import torch.distributed as dist
    dist.destroy_process_group()
    _STATE["process_id"], _STATE["num_processes"] = 0, 1


def multihost_info() -> Tuple[int, int]:
    """(process_id, num_processes); (0, 1) when not in a process group."""
    return _STATE["process_id"], _STATE["num_processes"]


def owned_indices(n_items: int, process_id: Optional[int] = None,
                  num_processes: Optional[int] = None) -> List[int]:
    """Round-robin sample ownership over the process group."""
    pid, nproc = multihost_info()
    pid = process_id if process_id is not None else pid
    nproc = num_processes if num_processes is not None else nproc
    return list(range(pid, n_items, nproc))


def barrier(name: str = "lr2rmats") -> None:
    """Block until every process reaches this point (over gloo: the group
    has a CPU backend, which torch.distributed prefers for barriers).
    `name` labels the call site only."""
    if multihost_info()[1] <= 1:
        return
    import torch.distributed as dist
    dist.barrier()


def _all_gather_cpu(t: torch.Tensor) -> List[torch.Tensor]:
    import torch.distributed as dist
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return out


def gather_blobs(blob: bytes) -> List[bytes]:
    """All-gather one byte payload per process, returned in process order.

    Two all-gathers of CPU tensors: the lengths, then the payloads padded
    to the longest as uint8, each trimmed to its length.  The reference
    rounds the padded width up to a power of two because XLA compiles per
    shape; torch has no per-shape compile, so the width here is the
    longest length itself.  The bytes returned are the same either way."""
    pid, nproc = multihost_info()
    if nproc <= 1:
        return [blob]
    lens = _all_gather_cpu(torch.tensor([len(blob)], dtype=torch.int64))
    lens = [int(x) for x in lens]
    pad = torch.zeros(max(max(lens), 1), dtype=torch.uint8)
    if blob:
        pad[: len(blob)] = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
    parts = _all_gather_cpu(pad)
    return [parts[i][: lens[i]].numpy().tobytes() for i in range(nproc)]


def gather_indexed_payloads(
        payloads: Sequence[Tuple[int, bytes]]) -> Dict[int, bytes]:
    """All-gather (global_index, payload) frames from every process.

    Each process contributes the payloads of the samples it owns; the
    result maps every global sample index to its payload, on every
    process.  Frames are `<qq` (index, length) followed by the bytes, as in
    the reference."""
    frames = b"".join(
        struct.pack("<qq", gi, len(b)) + b for gi, b in payloads)
    out: Dict[int, bytes] = {}
    for blob in gather_blobs(frames):
        off = 0
        while off < len(blob):
            gi, ln = struct.unpack_from("<qq", blob, off)
            off += 16
            out[gi] = blob[off: off + ln]
            off += ln
    return out

