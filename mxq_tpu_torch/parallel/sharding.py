"""Device-mesh sharding of the parameters (port of
``mxq_tpu/parallel/sharding.py``).

One mesh, three logical axes, as in ``mxq_tpu``:
  * ``dp``   -- pure data parallel (replicated weights)
  * ``fsdp`` -- weight-sharded data parallel (ZeRO-3)
  * ``tp``   -- tensor parallel (Megatron column/row split)

``mxq_tpu`` annotates the parameter pytree with ``PartitionSpec``s and lets
GSPMD insert the collectives. Here a spec is the same thing as a tuple,
one entry per tensor dim (None, an axis name, or a tuple of axis names,
major first), :func:`placements` turns it into DTensor placements on a
``DeviceMesh`` and :func:`shard_params` gives every rank its shard of
each tensor. Training shards through FSDP2 instead (``parallel/fsdp.py``),
calibration keeps each layer's storage sharded (``ptq/calibrate.py``), and
the tensor-parallel decoder layer takes local shards (``tp_layer.py``).
"""

from __future__ import annotations

import torch

from mxq_tpu_torch.packfmt import FIELDS, PackedMXQLinear
from mxq_tpu_torch.parallel import multihost


def make_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1):
    """A ``DeviceMesh`` with axes ``("dp", "fsdp", "tp")`` over every rank
    of the group (row-major); for the node axis use
    ``multihost.make_hybrid_mesh``. Every function here takes either."""
    return multihost._mesh((dp, fsdp, tp), ("dp", "fsdp", "tp"))


# Per-parameter spec of the stacked-layer Llama dict. Linear weights are
# [L, in, out]:
#   column-parallel (q/k/v/gate/up): out on tp, in on fsdp
#   row-parallel (o/down):           in on tp, out on fsdp
_COL = (None, "fsdp", "tp")
_ROW = (None, "tp", "fsdp")

LAYER_SPECS = {
    "q_proj": _COL, "k_proj": _COL, "v_proj": _COL,
    "gate_proj": _COL, "up_proj": _COL,
    # the fused serving-path linears are column-parallel like their parts
    "qkv_proj": _COL, "gate_up_proj": _COL,
    "o_proj": _ROW, "down_proj": _ROW,
    "input_layernorm": (None, None),
    "post_attention_layernorm": (None, None),
}

_LINEAR_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                 "up_proj", "down_proj", "qkv_proj", "gate_up_proj")

# Packed planes are [L, K-ish, N] with N = out-features: column-parallel
# linears shard N on tp; row-parallel linears pack their contraction dim
# into words, so they shard N on fsdp only.
_PACKED_COL = (None, None, "tp")
_PACKED_ROW = (None, None, "fsdp")


def _wrap_axis(spec: tuple, axis: str) -> tuple:
    """``spec`` with the mesh axis ``axis`` replaced by ("dcn", axis): that
    sharded dim extends across nodes."""
    def wrap(entry):
        if entry == axis:
            return ("dcn", axis)
        if isinstance(entry, tuple) and axis in entry:
            return tuple(a for e in entry for a in
                         (("dcn", e) if e == axis else (e,)))
        return entry
    return tuple(wrap(e) for e in spec)


def spec_for(keys: list, ndim: int, packed: bool = False,
             dcn_role: str | None = None) -> tuple:
    """The spec of the tensor at path ``keys`` of the params dict (a
    packed field's path ends in its field name)."""
    spec = None
    if "embed_tokens" in keys:
        spec = ("tp", "fsdp")
    elif "lm_head" in keys:
        spec = ("fsdp", "tp")
    elif "norm" in keys:
        spec = (None,)
    else:
        for name, s in LAYER_SPECS.items():
            if name in keys:
                if name in _LINEAR_NAMES and ndim == 3 and not packed:
                    spec = s
                elif name in _LINEAR_NAMES and packed:
                    spec = _PACKED_COL if s is _COL else _PACKED_ROW
                else:
                    spec = s
                break
    if spec is None:
        spec = ()
    if dcn_role is not None:
        wrapped = _wrap_axis(spec, dcn_role)
        if wrapped == spec and dcn_role == "tp" and spec == _PACKED_ROW:
            # packed row-parallel linears carry their only sharded dim (N)
            # on fsdp: under cross-node tensor parallelism they must still
            # spread over the nodes
            wrapped = _wrap_axis(spec, "fsdp")
        spec = wrapped
    return spec


def param_specs(params: dict, packed: bool = False,
                dcn_role: str | None = None) -> dict:
    """The spec tree of ``params``: a tuple per tensor, and for a packed
    linear a dict of its fields' specs.

    ``dcn_role`` says what the node axis of a hybrid mesh carries: None,
    the params replicate across nodes (data parallel over nodes); "fsdp",
    every fsdp-sharded dim shards over ("dcn", "fsdp"); "tp", tensor
    parallel across nodes, for a model that one node cannot hold."""
    if dcn_role not in (None, "fsdp", "tp"):
        raise ValueError(f"dcn_role must be None, 'fsdp' or 'tp', not "
                         f"{dcn_role!r}")

    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + [k]) for k, v in node.items()}
        if isinstance(node, PackedMXQLinear):
            return {f: spec_for(keys + [f], getattr(node, f).dim(), packed,
                                 dcn_role) for f in FIELDS}
        return spec_for(keys, node.dim(), packed, dcn_role)

    return walk(params, [])


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` names, ``Replicate()`` on the others.
    A tensor dim split over several axes is split in mesh order, which
    must be the spec's major-to-minor order."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order "
                             f"{names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def _distribute(t: torch.Tensor, spec: tuple, mesh):
    """Every rank takes its own shard of ``t`` (which each holds whole):
    no data moves."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)


def shard_params(params: dict, mesh, packed: bool = False,
                 dcn_role: str | None = None) -> dict:
    """``params`` (whole on every rank) as DTensors on ``mesh`` by
    :func:`param_specs`: each rank keeps its shard. Packed linears keep
    their type, their fields DTensors."""
    if dcn_role is not None and "dcn" not in mesh.mesh_dim_names:
        raise ValueError("dcn_role needs a hybrid mesh")
    specs = param_specs(params, packed, dcn_role)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, PackedMXQLinear):
            return PackedMXQLinear(
                *(_distribute(getattr(node, f), spec[f], mesh)
                  for f in FIELDS), in_features=node.in_features,
                out_features=node.out_features)
        return _distribute(node, spec, mesh)

    return walk(params, specs)


def gather_params(params: dict) -> dict:
    """The whole tensors of a tree of DTensors (a collective: every rank
    calls it); plain tensors pass through."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, PackedMXQLinear):
            return PackedMXQLinear(
                *(whole(getattr(node, f)) for f in FIELDS),
                in_features=node.in_features,
                out_features=node.out_features)
        return whole(node)

    return walk(params)


def batch_spec(mesh=None) -> tuple:
    if mesh is not None and "dcn" in mesh.mesh_dim_names:
        return multihost.batch_spec(mesh)
    return (("dp", "fsdp"),)


def shard_batch(batch: dict, mesh) -> dict:
    """A batch every rank holds whole, as DTensors over the mesh's data
    axes: each rank keeps its rows. Ranks that feed their own rows use
    ``multihost.global_batch``."""
    spec = batch_spec(mesh)
    return {k: _distribute(torch.as_tensor(v), spec + (None,) * (
        torch.as_tensor(v).dim() - 1), mesh) for k, v in batch.items()}


def local_of(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's shard of ``t`` (whole on every rank) under ``spec``."""
    return _distribute(t, spec, mesh).to_local()


def from_local(local: torch.Tensor, spec: tuple, mesh, shape):
    """The DTensor of ``shape`` whose shard on each rank is ``local``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(
        local, mesh, placements(spec, mesh), run_check=False,
        shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def whole(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (a collective), or ``t``."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t
