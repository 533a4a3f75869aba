"""The Llama model sharded for training with FSDP2
(``torch.distributed.fsdp.fully_shard``): the training half of
``mxq_tpu/parallel/sharding.py``, whose ``shard_params`` lets GSPMD
all-gather the weights of each layer and reduce-scatter its gradients.

The port's parameters are stacked ``[L, ...]`` tensors; FSDP2 shards one
module per layer, and its default ``Shard(0)`` of a stack would split the
layers. So :class:`ShardedLlama` copies each layer's tensors once, at shard
time, into a module of its own, and restacks them when a checkpoint is
written (:func:`stack_full`).

Mesh: the data axes that replicate the weights (``dcn``, ``dp``) are
HSDP's replicate dim, and the flattened ``(fsdp, tp)`` axes its shard
group: ``mxq_tpu``'s numbers do not depend on tp, and it does no Megatron
compute in training, so a tp rank is one more weight shard that reads the
same rows of the batch as its fsdp neighbours. Every ``[in, out]`` linear
shards its in-features (the fsdp dim of ``_COL``), the embedding its hidden
dim (the fsdp dim of ``("tp", "fsdp")``).

Gradients: FSDP2 averages them over the shard group and the replicate
dim. Each rank's loss is the mean over its rows, so the average is the
global batch mean's gradient when every rank holds as many loss tokens;
QAT's blocks are full, so they do.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from mxq_tpu_torch.models import llama
from mxq_tpu_torch.parallel import multihost, sharding

def training_mesh(mesh):
    """FSDP2's mesh for the training mesh ``mesh``: ``(replicate, shard)``
    with replicate = dcn * dp and shard = fsdp * tp (rank-major, as the
    ranks lie in ``mesh``), or the 1-D shard mesh when nothing
    replicates."""
    from torch.distributed.device_mesh import init_device_mesh
    sizes = multihost.mesh_axes(mesh)
    rep = sizes.get("dcn", 1) * sizes.get("dp", 1)
    shard = sizes.get("fsdp", 1) * sizes.get("tp", 1)
    if rep == 1:
        return init_device_mesh(mesh.device_type, (shard,),
                                mesh_dim_names=("shard",))
    return init_device_mesh(mesh.device_type, (rep, shard),
                            mesh_dim_names=("replicate", "shard"))


class _Layer(torch.nn.Module):
    """One decoder layer's tensors as parameters (until ``fully_shard``
    copies them into its shards, views of the given tensors)."""

    def __init__(self, layer: dict):
        super().__init__()
        for k, v in layer.items():
            self.register_parameter(k, torch.nn.Parameter(v.detach()))

    def forward(self, x, cos, sin, mask, cfg, train: bool):
        return llama.decoder_layer(x, dict(self.named_parameters()), cfg,
                                   cos, sin, mask, train=train)


class ShardedLlama(torch.nn.Module):
    """The dense Llama of a params dict as FSDP2 modules on ``mesh`` (a
    training mesh; see the module's docstring). ``requires_grad`` says
    whether the copies train (the student) or not (the KD teacher).
    Calling it gives the logits of this rank's rows, as
    ``llama.forward`` does for the whole batch."""

    def __init__(self, params: dict, cfg: llama.LlamaConfig, mesh,
                 requires_grad: bool = True):
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard
        super().__init__()
        self.cfg = cfg
        self.mesh = training_mesh(mesh)
        self.top = [k for k in ("embed_tokens", "norm", "lm_head")
                    if k in params]
        for k in self.top:
            self.register_parameter(k, torch.nn.Parameter(
                params[k].detach()))
        embed = self.embed_tokens

        def placement(p):
            return Shard(1) if p is embed else Shard(0)

        # FSDP2 copies each layer into its shards as it wraps it: the
        # copies of one layer at a time beside the given stacks
        self.layers = torch.nn.ModuleList()
        for i in range(cfg.num_hidden_layers):
            layer = _Layer({k: v[i] for k, v in params["layers"].items()})
            layer.requires_grad_(requires_grad)
            fully_shard(layer, mesh=self.mesh, shard_placement_fn=placement)
            self.layers.append(layer)
        for k in self.top:
            getattr(self, k).requires_grad_(requires_grad)
        fully_shard(self, mesh=self.mesh, shard_placement_fn=placement)

    def forward(self, ids: torch.Tensor, train: bool = False,
                remat: bool = False) -> torch.Tensor:
        cfg = self.cfg
        b, t = ids.shape
        x = self.embed_tokens[ids]
        positions = torch.arange(t, device=ids.device)[None].expand(b, t)
        cos, sin = llama.rope_tables(cfg, positions)
        cos, sin = cos.to(x.dtype), sin.to(x.dtype)
        mask = llama.causal_mask(t, device=ids.device)
        for layer in self.layers:
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    layer, x, cos, sin, mask, cfg, train,
                    use_reentrant=False)
            else:
                x = layer(x, cos, sin, mask, cfg, train)
        x = llama.rms_norm(x, self.norm, cfg.rms_norm_eps)
        head = {"embed_tokens": self.embed_tokens}
        if "lm_head" in self.top:
            head["lm_head"] = self.lm_head
        return llama.lm_head(head, x).float()

    def named_leaves(self) -> dict[str, torch.Tensor]:
        """Every parameter (this rank's DTensor shard) by the path of the
        stacked dict plus its layer: ``layers.q_proj.3``."""
        out = {k: getattr(self, k) for k in self.top}
        for i, layer in enumerate(self.layers):
            for k, p in layer.named_parameters():
                out[f"layers.{k}.{i}"] = p
        return out

    def shard_group(self):
        """The process group over which the parameters are split."""
        return self.mesh.get_group("shard")


def _layer_of(name: str):
    """``(stacked path, layer)`` of a per-layer name (``...q_proj.3``), or
    ``(name, None)``."""
    base, _, i = name.rpartition(".")
    return (base, int(i)) if i.isdigit() else (name, None)


def stack_full(named: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Whole tensors by the stacked dict's dotted paths, from per-layer
    names as :meth:`ShardedLlama.named_leaves` gives them (any prefix):
    each DTensor gathered (a collective), the layers' ``<path>.<i>``
    stacked into ``<path>`` [L, ...]."""
    out, stacks = {}, {}
    for name, t in named.items():
        full = sharding.whole(t).detach()
        base, i = _layer_of(name)
        if i is None:
            out[name] = full
        else:
            stacks.setdefault(base, {})[i] = full
    for base, per in stacks.items():
        out[base] = torch.stack([per[i] for i in range(len(per))])
    return out


def shards_of(full: dict[str, torch.Tensor],
              named: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """For every name of ``named`` (per-layer names), its tensor cut from
    the whole stacked tensors ``full`` (:func:`stack_full`'s paths): a
    DTensor with the mesh and placements of ``named[name]``, each rank
    taking its own shard (no data moves), or a plain tensor."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    out = {}
    for name, t in named.items():
        base, i = _layer_of(name)
        src = full[base] if i is None else full[base][i]
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"tensor {name!r} {tuple(src.shape)} does not "
                             f"fit the parameter {tuple(t.shape)}")
        src = src.to(t.device)
        if isinstance(t, DTensor):
            src = distribute_tensor(src, t.device_mesh, t.placements,
                                    src_data_rank=None)
        out[name] = src
    return out


@torch.no_grad()
def load_full(named: dict[str, torch.Tensor],
              full: dict[str, torch.Tensor]) -> None:
    """Copy whole tensors (by :func:`stack_full`'s paths) into this rank's
    shards of ``named``, in place."""
    from torch.distributed.tensor import DTensor
    for name, src in shards_of(full, named).items():
        t = named[name]
        if isinstance(t, DTensor):
            t, src = t.to_local(), src.to_local()
        t.copy_(src)


def params_dict(full: dict[str, torch.Tensor]) -> dict:
    """The stacked params dict of :func:`stack_full`'s paths."""
    out: dict = {}
    for name, t in full.items():
        *parents, leaf = name.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


def all_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of a 0-dim tensor over every rank (a copy)."""
    x = x.detach().clone()
    dist.all_reduce(x)
    return x / dist.get_world_size()
