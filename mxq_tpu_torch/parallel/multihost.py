"""Multi-process plumbing (port of ``mxq_tpu/parallel/multihost.py``).

``mxq_tpu`` is single-controller: one process sees every device and GSPMD
inserts the collectives. PyTorch is multi-controller: ``torchrun`` starts
one rank per device, each rank runs the same program on its own card, and
``torch.distributed`` carries the collectives. So here:

* :func:`initialize` wires this process into the group that ``torchrun``
  describes in its environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``): NCCL on the card,
  gloo only when the caller asks for the CPU. A process started without
  that environment is the single-process case and nothing is wired, as in
  ``mxq_tpu``.
* :func:`make_hybrid_mesh` lays ``("dcn", "dp", "fsdp", "tp")`` over the
  ranks, "dcn" being the node axis: each dcn index is one node's ranks, so
  a collective that does not name "dcn" stays inside a node.
* A rank loads its own slice of the data (:func:`host_local_slice`) and
  keeps it: :func:`global_batch` gives the global view of the local
  shards without moving them.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from mxq_tpu_torch import resolve_device

AXES = ("dcn", "dp", "fsdp", "tp")
DATA_AXES = ("dcn", "dp", "fsdp")
# a collective that waits longer than this fails instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)


def initialize(device: str | torch.device = "cuda",
               timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Join the process group ``torchrun`` describes in the environment:
    NCCL when ``device`` is the card (this rank takes card ``LOCAL_RANK``),
    gloo when it is the CPU. No-op when the group exists already or when
    the environment names no group (a plain single process). Returns
    whether it made the group (whose maker destroys it)."""
    dev = resolve_device(device)
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://", timeout=timeout)
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """True on the rank that logs and writes checkpoints (rank 0)."""
    return rank() == 0


def device_type() -> str:
    """"cuda" under NCCL, "cpu" under gloo: the device of a mesh's
    tensors."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: tuple[int, ...], names: tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh of {n} ranks needs the process group "
                           "(start the program with torchrun)")
    if n != world_size():
        raise ValueError(f"mesh {dict(zip(names, shape))} holds {n} ranks, "
                         f"the group {world_size()}")
    return init_device_mesh(device_type(), shape, mesh_dim_names=names)


def make_hybrid_mesh(dcn: int = 1, dp: int = 1, fsdp: int = 1, tp: int = 1):
    """A ``DeviceMesh`` with axes ``("dcn", "dp", "fsdp", "tp")`` over every
    rank of the group, rank-major: "dcn" spans nodes, the other three the
    ranks of one node. Across nodes, dcn must equal the number of nodes
    (``WORLD_SIZE // LOCAL_WORLD_SIZE``), the counterpart of ``mxq_tpu``'s
    ``dcn == process_count``; on one node any dcn simulates hosts."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))
    nodes = world_size() // local
    if nodes > 1 and dcn != nodes:
        raise ValueError(f"dcn={dcn} must equal the number of nodes "
                         f"{nodes} (WORLD_SIZE // LOCAL_WORLD_SIZE) when "
                         "the ranks span nodes")
    return _mesh((dcn, dp, fsdp, tp), AXES)


def mesh_axes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_spec(mesh) -> tuple:
    """The batch's spec: its rows over every data axis of the mesh larger
    than 1 (dcn is a data axis: data parallel across nodes)."""
    sizes = mesh_axes(mesh)
    axes = tuple(a for a in DATA_AXES if sizes.get(a, 1) > 1)
    return (axes if axes else None,)


def _data_index(names, coord, shape) -> int:
    idx = 0
    for a, c, n in zip(names, coord, shape):
        if a in DATA_AXES:
            idx = idx * n + c
    return idx


def data_rank(mesh) -> tuple[int, int]:
    """``(index, count)`` of this rank's slice of the batch: its coordinate
    over the mesh's data axes, row-major; ranks that differ only in "tp"
    hold the same slice."""
    shape = mesh.mesh.shape
    count = 1
    for a, n in zip(mesh.mesh_dim_names, shape):
        count *= n if a in DATA_AXES else 1
    return _data_index(mesh.mesh_dim_names, mesh.get_coordinate(),
                       shape), count


def data_ranks(mesh) -> list[int]:
    """One rank per slice of the batch, in the slices' order (of ranks
    holding the same slice, the first)."""
    import itertools
    ranks = mesh.mesh
    first: dict[int, int] = {}
    for coord in itertools.product(*(range(n) for n in ranks.shape)):
        first.setdefault(_data_index(mesh.mesh_dim_names, coord,
                                     ranks.shape), int(ranks[coord]))
    return [first[i] for i in range(len(first))]


def host_local_slice(n_global: int, mesh=None) -> slice:
    """The contiguous slice of a globally indexed dataset this rank loads:
    by its data coordinate on ``mesh``, else by its rank in the group."""
    idx, count = data_rank(mesh) if mesh is not None else (rank(),
                                                           world_size())
    if n_global % count:
        raise ValueError(f"global batch {n_global} not divisible by "
                         f"{count} data ranks")
    per = n_global // count
    return slice(idx * per, (idx + 1) * per)


def _data_placements(mesh, spec):
    from torch.distributed.tensor import Replicate, Shard
    axes = spec[0] or ()
    axes = (axes,) if isinstance(axes, str) else axes
    return [Shard(0) if a in axes else Replicate()
            for a in mesh.mesh_dim_names]


def global_batch(batch: dict, mesh, spec: Optional[tuple] = None) -> dict:
    """This rank's slice of every leaf of ``batch`` (what
    :func:`host_local_slice` loaded), as the global ``DTensor`` whose rows
    lie on the mesh's data axes: each rank keeps its local shard, nothing
    moves."""
    from torch.distributed.tensor import DTensor
    placements = _data_placements(mesh, spec or batch_spec(mesh))
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")
    return {k: DTensor.from_local(torch.as_tensor(v).to(dev), mesh,
                                  placements, run_check=False)
            for k, v in batch.items()}


def local_batch(batch: dict, mesh) -> dict:
    """This rank's rows of a batch that every rank holds whole."""
    return {k: v[host_local_slice(v.shape[0], mesh)]
            for k, v in batch.items()}


def sync_global_devices(name: str = "mxq") -> None:
    """Barrier across ranks; no-op in a single process. ``name`` labels
    the point of the program, as in ``mxq_tpu``."""
    del name
    if world_size() > 1:
        dist.barrier()
