"""Multi-rank serving: one continuous-batching engine over a mesh of ranks
(port of ``mxq_tpu/serving/multihost.py``).

``mxq_tpu`` is single-controller: GSPMD runs the engine's programs on
globally sharded arrays. PyTorch is multi-controller: ``torchrun`` starts
one rank per card (NCCL; gloo for ``device="cpu"``), every rank runs the
same engine loop in lockstep, and each step computes on this rank's local
shards what GSPMD computes for ``mxq_tpu``, with explicit collectives. The
port's kernels take plain tensors, not DTensors.

Layout: exactly ``mxq_tpu``'s, ``parallel.sharding.param_specs``:

* packed column linears (``qkv_proj``, ``gate_up_proj``): N over "tp";
* packed row linears (``o_proj``, ``down_proj``): N over "fsdp", or over
  ("dcn", "fsdp") under ``dcn_role="tp"``: no packed linear is split on
  its K axis, so no k-tile is cut;
* ``embed_tokens`` (vocab over "tp", hidden over "fsdp"), ``lm_head``
  (hidden over "fsdp", vocab over "tp"), norms replicated;
* the bf16 KV cache: heads over "tp" (``kv_cache_spec``).

A step on each rank is ``llama``'s own decode step and forward over
:class:`ShardedStep`, which overrides ``llama.Ops``' hooks: a packed
N-shard (padded to the format's column multiple, as
``parallel.overlap.pad_to_format`` pads) goes through
``llama.quant_linear`` on its own columns (K1 at 2-511 rows, K2 at one
row, K3 and a GEMM from 512 rows) and the outputs are all-gathered over
the axes that split N, in mesh order; a dense weight split on its K axis
(the head over "fsdp", the embedding over its vocabulary) multiplies this
rank's K-chunk of the input and the partial products, in the weight's
dtype, are summed over that axis. A sum all-gathers the partials and adds
them in rank order, so every rank holds the same bits: the logits, and so
the sampled tokens and the scheduler's state, are the same everywhere.
Attention runs over this rank's heads of the head-sharded cache, and the
context is gathered for ``o_proj``. The unsharded Engine runs the same
functions over ``llama.WHOLE``.

Submission goes through the coordinator: rank 0 broadcasts a 3-int32
header (length, max_new, eos or -1) and the prompt padded to at least one
token, so every rank runs the same two broadcasts per submit.

What each rank holds on its card at llama2_7b (packed; bf16 embeddings,
head and norms; 32 layers; a bf16 cache of 8 slots x 2048 rows), in
bytes, as ``held_bytes`` counts it:

  =====================  =============  ===========  =============
  layout                 packed         dense        KV cache
  =====================  =============  ===========  =============
  one rank               2,921,332,736  524,820,480  8,589,934,592
  fsdp 2 x tp 2          1,460,666,368  131,604,480  4,294,967,296
  dcn 2 x tp 2, tp role    982,515,712  131,604,480  2,147,483,648
  =====================  =============  ===========  =============

That is all a rank's engine takes when :class:`MultiHostEngine` is given
the whole params on the host: each rank slices its shards there, moves
only those to the card and allocates only its heads of the cache
(``chip_smoke.py``'s multihost phase holds the build's peak of
``torch.cuda.max_memory_allocated`` to these counts). Params given on the
card stay there beside the shards, as the caller keeps them.

At fsdp 2 x tp 2 every packed linear is split in two (column linears
over "tp", row linears over "fsdp"); with ``dcn_role="tp"`` the column
linears split four ways (gate_up's 22528 columns as 5632 a rank, padded
to 6144) and the row linears two ways over ("dcn", "fsdp"). The int8 KV
cache is refused: its kernels (K4, K11) are not sharded.

    torchrun --nproc_per_node 4 my_serve.py   # each rank:
        multihost.initialize("cuda")
        mesh = sharding.make_mesh(dp=1, fsdp=2, tp=2)
        e = MultiHostEngine(packed_on_host, cfg, mesh,
                            EngineConfig(kv_quant=False))
        req = e.submit(prompt if multihost.is_coordinator() else None)
        e.run()
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from mxq_tpu_torch import resolve_device
from mxq_tpu_torch.models import llama
from mxq_tpu_torch.packfmt import FIELDS, PackedMXQLinear
from mxq_tpu_torch.parallel import multihost, overlap, sharding
from mxq_tpu_torch.serving.engine import Engine, EngineConfig, Request


def _axes(entry) -> tuple:
    """The mesh axes of one spec entry (None, a name or a tuple of them)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def kv_cache_spec(caches: dict, dcn_role: Optional[str] = None) -> dict:
    """Head-sharded specs of an Engine's cache: bf16 k/v [L, B, S, H, D]
    (heads axis 3), int8 codes [L, B, H, S, D] and scales [L, B, H, S]
    (heads axis 2). Decode attention has no cross-head reduction, so each
    rank reads only its own heads' rows."""
    tp = ("dcn", "tp") if dcn_role == "tp" else "tp"

    def spec_for(name):
        if name in ("k", "v"):
            return (None, None, None, tp, None)
        if name.endswith("_codes"):
            return (None, None, tp, None, None)
        if name.endswith("_scale"):
            return (None, None, tp, None)
        return ()

    return {k: spec_for(k) for k in caches}


# ---------------------------------------------------------------------------
# collectives of one rank
# ---------------------------------------------------------------------------


class Comm:
    """This rank's place on a mesh (``sizes`` and ``coords`` by axis name)
    and the two collectives of the sharded step, built on
    :meth:`gather_axis`: the tensors of every rank that differs from this
    one only along ``axis``, in coordinate order. Axes of size 1 cost
    nothing."""

    def __init__(self, sizes: dict, coords: dict):
        self.sizes, self.coords = dict(sizes), dict(coords)

    def gather_axis(self, t: torch.Tensor, axis: str) -> list:
        raise NotImplementedError

    def index(self, axes) -> tuple[int, int]:
        """(this rank's chunk, the number of chunks) of a dim split over
        ``axes``, major first."""
        idx, count = 0, 1
        for a in _axes(axes):
            idx = idx * self.sizes.get(a, 1) + self.coords.get(a, 0)
            count *= self.sizes.get(a, 1)
        return idx, count

    def gather(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """The whole of a tensor split on ``dim`` over ``axes``: chunks
        concatenated minor axis first, so the major axis orders the
        result."""
        for a in reversed(_axes(axes)):
            if self.sizes.get(a, 1) > 1:
                t = torch.cat(self.gather_axis(t.contiguous(), a), dim=dim)
        return t

    def sum(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The sum of the partials over ``axes``, added in rank order on
        every rank (the same bits everywhere)."""
        for a in reversed(_axes(axes)):
            if self.sizes.get(a, 1) > 1:
                parts = self.gather_axis(t.contiguous(), a)
                t = parts[0]
                for p in parts[1:]:
                    t = t + p
        return t


class MeshComm(Comm):
    """The collectives over a ``DeviceMesh``'s process groups (NCCL or
    gloo): ``gather_axis`` is one ``all_gather`` in that axis's group."""

    def __init__(self, mesh):
        names = mesh.mesh_dim_names
        super().__init__(multihost.mesh_axes(mesh),
                         dict(zip(names, mesh.get_coordinate())))
        self.groups = {a: mesh.get_group(a) for a in names
                       if self.sizes[a] > 1}

    def gather_axis(self, t, axis):
        out = [torch.empty_like(t) for _ in range(self.sizes[axis])]
        dist.all_gather(out, t, group=self.groups[axis])
        return out


class _Exchange:
    def __init__(self, n: int, timeout: float):
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.slots: list = [None] * n


class LocalComm(Comm):
    """One of several ranks simulated by threads of one process (see
    :func:`run_ranks`): ``gather_axis`` hands tensors over through shared
    memory, the arithmetic of the collectives being the same."""

    def __init__(self, sizes, coords, rank: int, ranks: dict,
                 exchange: _Exchange):
        super().__init__(sizes, coords)
        self.rank, self._ranks, self._ex = rank, ranks, exchange

    def gather_axis(self, t, axis):
        ex = self._ex
        ex.slots[self.rank] = t
        ex.barrier.wait()
        peers = [self._ranks[tuple(dict(self.coords, **{axis: i})[a]
                                   for a in self.sizes)]
                 for i in range(self.sizes[axis])]
        out = [ex.slots[r] for r in peers]
        ex.barrier.wait()
        return out


def run_ranks(fn: Callable, sizes: dict, timeout: float = 600.0) -> list:
    """``fn(comm)`` for every rank of a mesh of ``sizes`` (axis name ->
    size, major first), each rank a thread of this process with a
    :class:`LocalComm`: every rank's local step on one device, joined by
    the collectives' arithmetic. Returns the results in rank order
    (row-major over the axes); re-raises a rank's error."""
    coords = list(itertools.product(*(range(n) for n in sizes.values())))
    ranks = {c: r for r, c in enumerate(coords)}
    ex = _Exchange(len(coords), timeout)
    out, errors = [None] * len(coords), []

    def body(r, c):
        try:
            out[r] = fn(LocalComm(sizes, dict(zip(sizes, c)), r, ranks, ex))
        except Exception as e:   # noqa: BLE001 - re-raised below
            errors.append((r, e))
            ex.barrier.abort()

    threads = [threading.Thread(target=body, args=(r, c))
               for r, c in enumerate(coords)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    real = [(r, e) for r, e in errors
            if not isinstance(e, threading.BrokenBarrierError)]
    if real or errors:
        r, e = (real or errors)[0]
        raise RuntimeError(f"rank {r} failed: {e!r}") from e
    return out


# ---------------------------------------------------------------------------
# local shards
# ---------------------------------------------------------------------------


def _slice(t: torch.Tensor, spec: tuple, comm: Comm) -> torch.Tensor:
    """This rank's chunk of ``t`` (whole) under ``spec``: a view when the
    split leaves it contiguous, else a copy."""
    for d, entry in enumerate(spec):
        idx, count = comm.index(entry)
        if count == 1:
            continue
        if t.shape[d] % count:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"over {count} ranks ({entry})")
        n = t.shape[d] // count
        t = t.narrow(d, idx * n, n)
    return t.contiguous()


def _local_packed(p: PackedMXQLinear, specs: dict, comm: Comm
                  ) -> PackedMXQLinear:
    """This rank's N-shard of a stacked packed linear: every plane's lane
    axis sliced, ``out_features`` the local width, the planes padded to
    the format's column multiple (zero columns, left out of the
    product)."""
    local = PackedMXQLinear(*(_slice(getattr(p, f), specs[f], comm)
                              for f in FIELDS),
                            in_features=p.in_features,
                            out_features=p.out_features)
    local = dataclasses.replace(
        local, out_features=min(p.out_features, local.n_padded))
    return overlap.pad_to_format(local)


def local_params(params: dict, specs: dict, comm: Comm,
                 device: Optional[torch.device] = None) -> dict:
    """This rank's shards of ``params`` (whole) under ``specs``
    (``sharding.param_specs``), sliced where ``params`` live and moved to
    ``device`` (if given): whole params on the host leave only the shards
    on the card."""
    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, PackedMXQLinear):
            if any(_axes(e) for e in spec["w2"][:-1]):
                raise ValueError("a packed linear may be split on its N "
                                 "axis only")
            local = _local_packed(node, spec, comm)
            return local if device is None else local.to(device)
        if not isinstance(node, torch.Tensor):
            raise ValueError(f"cannot shard a {type(node).__name__} (a "
                             "packed uniform head is not sharded)")
        local = _slice(node, spec, comm)
        return local if device is None else local.to(device)

    return walk(params, specs)


def held_bytes(local: dict, caches: dict) -> dict:
    """Bytes one rank holds: packed linears, dense tensors, cache."""
    packed = dense = 0

    def walk(node):
        nonlocal packed, dense
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, PackedMXQLinear):
            packed += sum(getattr(node, f).numel()
                          * getattr(node, f).element_size() for f in FIELDS)
        else:
            dense += node.numel() * node.element_size()

    walk(local)
    return {"packed": packed, "dense": dense,
            "cache": sum(t.numel() * t.element_size()
                         for t in caches.values())}


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------


class ShardedStep(llama.Ops):
    """The decoder's weights and cache on this rank's shards: the hooks of
    :class:`llama.Ops`, over which ``llama.decode_slots`` and
    ``llama.forward`` run unchanged (:meth:`decode_slots`,
    :meth:`forward`), with ``params`` the local shards and the bf16 cache
    this rank's heads."""

    def __init__(self, cfg: llama.LlamaConfig, specs: dict, comm: Comm,
                 head_axes, out_features: dict):
        if cfg.w_bits < 32 or cfg.a_bits < 32 or cfg.kv_bits < 32:
            raise ValueError("the sharded step serves a packed or "
                             "full-precision model, not the fake-quant "
                             "forward")
        self.specs, self.comm = specs, comm
        self.head_axes = _axes(head_axes)
        # whole output width of each packed linear (the gathered shards
        # hold its padded width)
        self.out_features = out_features
        _, self.head_split = comm.index(self.head_axes)
        if cfg.num_key_value_heads % self.head_split:
            raise ValueError(f"{cfg.num_key_value_heads} kv heads do not "
                             f"split over {self.head_split} ranks")

    def _product(self, x, w, spec, cfg=None, train=False):
        """The whole ``x @ w`` from this rank's shard ``w`` of a weight
        whose spec is ``spec`` (a dense [.., in, out] one's, or a packed
        field's: split on N only): the input's K-chunk, the local product
        (``llama.quant_linear`` under ``cfg``, a plain ``@`` without),
        a sum over the K axes, a gather over the N axes."""
        k_axes = () if isinstance(w, PackedMXQLinear) else _axes(spec[-2])
        if k_axes:
            idx, count = self.comm.index(k_axes)
            n = x.shape[-1] // count
            x = x.narrow(-1, idx * n, n)
        y = x @ w if cfg is None else llama.quant_linear(x, w, cfg, train)
        if k_axes:
            y = self.comm.sum(y, k_axes)
        return self.comm.gather(y, spec[-1], dim=-1)

    def linear(self, x, layer, name, cfg, train=False):
        w, spec = layer[name], self.specs["layers"][name]
        if isinstance(w, PackedMXQLinear):
            return self._product(x, w, spec["w2"], cfg, train)[
                ..., :self.out_features[name]]
        return self._product(x, w, spec, cfg, train)

    def embed(self, params, tokens):
        emb = params["embed_tokens"]
        spec = self.specs["embed_tokens"]
        v_idx, v_n = self.comm.index(spec[0])
        rows = tokens.long() - v_idx * emb.shape[0]
        if v_n > 1:
            inside = (rows >= 0) & (rows < emb.shape[0])
            x = emb[rows.clamp(0, emb.shape[0] - 1)] * inside[..., None]
            x = self.comm.sum(x, spec[0])
        else:
            x = emb[rows]
        return self.comm.gather(x, spec[1], dim=-1)

    def head(self, params, x):
        head = params.get("lm_head")
        if head is None:                  # tied: x @ embed.T
            spec = self.specs["embed_tokens"]
            return self._product(x, params["embed_tokens"].T,
                                 (spec[1], spec[0]))
        return self._product(x, head, self.specs["lm_head"])

    def attend(self, attend, idx, q, k, v):
        """``attend`` over this rank's heads of q, k, v, whose cache holds
        those heads; the context gathered over the head axes."""
        i, n = self.comm.index(self.head_axes)
        nh, nkv = q.shape[2] // n, k.shape[2] // n
        ctx = attend(idx, q.narrow(2, i * nh, nh), k.narrow(2, i * nkv, nkv),
                     v.narrow(2, i * nkv, nkv))
        return self.comm.gather(ctx, self.head_axes, dim=-2)

    def init_cache(self, cfg, batch, max_len, device, quant=False):
        """This rank's heads of the bf16 cache, allocated alone."""
        if quant:
            raise ValueError("the sharded step keeps a bf16 cache "
                             "(kv_quant=False)")
        local = dataclasses.replace(
            cfg, num_key_value_heads=cfg.num_key_value_heads
            // self.head_split)
        return llama.init_cache(local, batch, max_len, device=device)

    # ---- llama's calls over the shards ----

    def decode_slots(self, params, tokens, cfg, caches, positions):
        if "k_codes" in caches:
            raise ValueError("the sharded step keeps a bf16 cache")
        return llama.decode_slots(params, tokens, cfg, caches, positions,
                                  ops=self)

    def forward(self, params, input_ids, cfg, **kw):
        if "k_codes" in (kw.get("caches") or {}):
            raise ValueError("the sharded step keeps a bf16 cache")
        return llama.forward(params, input_ids, cfg, ops=self, **kw)


def _params_are_packed(params) -> bool:
    return any(isinstance(v, PackedMXQLinear)
               for v in params.get("layers", {}).values())


def sharded_step(params: dict, cfg: llama.LlamaConfig, comm: Comm,
                 dcn_role: Optional[str] = None,
                 device: Optional[torch.device] = None):
    """This rank's shards of ``params`` (whole, on any device; moved to
    ``device`` if given) and the step that runs on them: (local params,
    :class:`ShardedStep`)."""
    specs = sharding.param_specs(params, _params_are_packed(params),
                                 dcn_role)
    widths = {k: v.out_features for k, v in params["layers"].items()
              if isinstance(v, PackedMXQLinear)}
    step = ShardedStep(cfg, specs, comm,
                       kv_cache_spec({"k": None}, dcn_role)["k"][3], widths)
    return local_params(params, specs, comm, device), step


def local_caches(caches: dict, comm: Comm,
                 dcn_role: Optional[str] = None) -> dict:
    """This rank's heads of a whole cache (copies)."""
    specs = kv_cache_spec(caches, dcn_role)
    return {k: _slice(v, specs[k], comm).clone() for k, v in caches.items()}


def _mesh_comm(mesh, dcn_role, comm: Optional[Comm]) -> Comm:
    """``comm``, else the mesh's collectives, else the one whole rank."""
    if dcn_role is not None and mesh is not None \
            and "dcn" not in mesh.mesh_dim_names:
        raise ValueError("dcn_role needs a hybrid mesh")
    if comm is not None:
        return comm
    return MeshComm(mesh) if mesh is not None else Comm({}, {})


def shard_engine(engine: Engine, mesh, dcn_role: Optional[str] = None,
                 comm: Optional[Comm] = None) -> Engine:
    """Put a built Engine's params and bf16 cache on the mesh: each rank
    keeps its shards (``sharding.param_specs``, ``kv_cache_spec``) and the
    Engine's decode step and forward run over :class:`ShardedStep`.
    In place; returns the engine. ``comm`` overrides the mesh's
    collectives; with neither, this process is the one rank and holds
    every shard whole. (:class:`MultiHostEngine` builds its Engine on the
    shards instead, never holding the whole model or cache.)"""
    if "k_codes" in engine.caches:
        raise ValueError("the sharded step keeps a bf16 cache "
                         "(kv_quant=False)")
    comm = _mesh_comm(mesh, dcn_role, comm)
    engine.params, step = sharded_step(engine.params, engine.cfg, comm,
                                       dcn_role)
    caches, engine.caches = engine.caches, None
    engine.caches = local_caches(caches, comm, dcn_role)
    del caches
    engine.use_ops(step)
    return engine


class MultiHostEngine:
    """An Engine over a mesh of ranks with coordinator-funnelled submission.

    On every rank: construct with the same (params, cfg, mesh, ecfg); call
    :meth:`submit` on every rank together, only rank 0's arguments being
    used (the others may pass None); then :meth:`run` or :meth:`stream` on
    every rank. ``params`` are the whole model, best on the host: each
    rank slices its shards where they are and moves only those to
    ``device``, and allocates only its heads of the cache. ``comm``
    overrides the mesh's collectives (``run_ranks``)."""

    def __init__(self, params, cfg: llama.LlamaConfig, mesh,
                 ecfg: EngineConfig = EngineConfig(kv_quant=False),
                 dcn_role: Optional[str] = None,
                 device: str | torch.device = "cuda",
                 comm: Optional[Comm] = None):
        if ecfg.kv_quant:
            raise ValueError("MultiHostEngine needs kv_quant=False: the "
                             "int8-KV attention kernels are single-device "
                             "(they are not sharded)")
        if ecfg.lm_head_bits != 16:
            raise ValueError("MultiHostEngine shards a dense lm_head "
                             "(lm_head_bits=16)")
        dev = resolve_device(device)
        comm = _mesh_comm(mesh, dcn_role, comm)
        local, step = sharded_step(params, cfg, comm, dcn_role, dev)
        self.engine = Engine(local, cfg, ecfg, dev, ops=step)
        self.mesh = mesh
    def submit(self, prompt: Optional[np.ndarray], max_new_tokens: int = 64,
               eos_token_id: Optional[int] = None) -> Request:
        """Collective: every rank calls it together; rank 0's arguments
        are used. Returns the Request on every rank (the same uid
        everywhere). With no process group it is ``Engine.submit``."""
        if not dist.is_initialized():
            return self.engine.submit(prompt, max_new_tokens, eos_token_id)
        dev = torch.device(multihost.device_type(),
                           torch.cuda.current_device()) \
            if multihost.device_type() == "cuda" else torch.device("cpu")
        coord = multihost.is_coordinator()
        hdr = torch.zeros(3, dtype=torch.int32, device=dev)
        if coord:
            pr = np.asarray(prompt, np.int32)
            hdr = torch.tensor([len(pr), max_new_tokens,
                                -1 if eos_token_id is None else eos_token_id],
                               dtype=torch.int32, device=dev)
        dist.broadcast(hdr, src=0)
        n, new, eos = (int(v) for v in hdr.cpu())
        buf = torch.zeros(max(n, 1), dtype=torch.int32, device=dev)
        if coord:
            buf[:n] = torch.from_numpy(pr).to(dev)
        dist.broadcast(buf, src=0)
        return self.engine.submit(buf[:n].cpu().numpy(), new,
                                  None if eos < 0 else eos)

    def run(self) -> list:
        return self.engine.run()

    def stream(self, **kw):
        return self.engine.stream(**kw)

    def stats(self) -> dict:
        return self.engine.stats()
