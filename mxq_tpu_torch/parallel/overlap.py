"""Tensor-parallel matmuls with the ring's transfers overlapped by compute
(port of ``mxq_tpu/parallel/overlap.py``).

``mxq_tpu`` writes these as ``shard_map`` bodies whose ``lax.ppermute``
hops XLA's scheduler runs beside the next chunk's product. Here every rank
of the tensor-parallel group runs the same function on its local shards,
and each ring hop is a ``torch.distributed.batch_isend_irecv`` started
before the step's partial product and waited on after it. The hop
direction and the chunk each step multiplies follow ``mxq_tpu`` exactly,
so the f32 partial sums add up in the same order.

Two Megatron patterns for one transformer block:

* :func:`allgather_matmul` -- a column-parallel linear whose input arrives
  K-sharded: at ring step s a rank multiplies the activation chunk it holds
  (origin (d + s) mod tp) by the matching k-tile rows of its N-shard of
  the weight while the chunk travels one hop (d -> d - 1).
* :func:`matmul_reducescatter` -- a row-parallel linear with K-sharded
  weights: output chunk j starts at rank j + 1 and gathers one partial
  product per hop (d -> d + 1) until it lands, summed, at rank j.

Both take the ``matmul`` callable: ``x @ w`` for dense [in, out] weights,
``llama.quant_linear`` (K1 at 2-511 rows, K2 at one row, K3 from 512 rows)
or ``ops.mxq_matmul.mxq_matmul`` for packed ones. The local shards are
made once, by :func:`shard_weight` and :func:`row_chunks`: a packed
shard is contiguous and padded to the format (``_check_packed``'s rule),
whatever width the split leaves it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from mxq_tpu_torch.packfmt import FIELDS, N_LANE, NB_TILE, PackedMXQLinear

KT_COLS = NB_TILE * 64          # input columns covered by one k-tile (1024)

# rows of each k-tile plane per meta row
_ROWS_PER_META = {"w2": 3, "w4": 2, "meta2": 1, "qscale": 1, "qmin": 1}


def slice_ktiles(p: PackedMXQLinear, t0: int,
                 n_tiles: int) -> PackedMXQLinear:
    """Packed sub-linear of k-tiles [t0, t0 + n_tiles): rows t0*KT_COLS on
    of the logical [K, N] weight, as views (row slices of a contiguous
    plane stay contiguous). Summing partial products over disjoint tile
    ranges gives the whole product (smeta4's 4-bit scales do not depend
    on K). K must be a multiple of KT_COLS, as in ``mxq_tpu``."""
    if p.in_features % KT_COLS:
        raise ValueError("a K-sharded packed matmul needs in_features "
                         "divisible by 1024")
    planes = {f: getattr(p, f)[t0 * NB_TILE * r:(t0 + n_tiles) * NB_TILE * r]
              for f, r in _ROWS_PER_META.items()}
    return PackedMXQLinear(**planes, smeta4=p.smeta4,
                           in_features=n_tiles * KT_COLS,
                           out_features=p.out_features)


def slice_ncols(p: PackedMXQLinear, c0: int,
                n_cols: int) -> PackedMXQLinear:
    """Packed sub-linear of output columns [c0, c0 + n_cols) of the padded
    N axis, copied contiguous; its out_features is the whole chunk."""
    return PackedMXQLinear(
        *(getattr(p, f)[:, c0:c0 + n_cols].contiguous() for f in FIELDS),
        in_features=p.in_features, out_features=n_cols)


def localize(p: PackedMXQLinear) -> PackedMXQLinear:
    """The geometry of a shard whose planes were split: the local
    in/out_features are what the local planes hold."""
    return dataclasses.replace(
        p, in_features=min(p.in_features, p.meta2.shape[0] * 64),
        out_features=min(p.out_features, p.meta2.shape[1]))


def pad_to_format(p: PackedMXQLinear) -> PackedMXQLinear:
    """``p`` with zero columns up to a multiple of N_LANE, the width the
    kernels take (``ops.mxq_matmul._check_packed``): zero planes
    dequantize to zero columns, which the product's ``out_features``
    leaves out. The fields come back contiguous."""
    cols = -p.n_padded % N_LANE
    return PackedMXQLinear(
        *((F.pad(getattr(p, f), (0, cols)) if cols else getattr(p, f))
          .contiguous() for f in FIELDS),
        in_features=p.in_features, out_features=p.out_features)


def packed_specs(shard: str) -> dict:
    """Each field's spec under the split of a packed linear: ``"n"``
    (column-parallel) splits every plane's lane (N) axis; ``"k"``
    (row-parallel) splits the k-tile planes' rows and keeps the
    per-channel ``smeta4`` whole."""
    if shard == "n":
        return {f: (None, "tp") for f in FIELDS}
    spec = {f: ("tp", None) for f in FIELDS}
    spec["smeta4"] = (None, None)
    return spec


def shard_weight(w, shard: str, rank: int, tp: int):
    """Rank ``rank``'s shard of the whole weight ``w`` of one layer (a
    :class:`PackedMXQLinear`, or dense [in, out]) over ``tp`` ranks:
    ``"n"`` splits the outputs (column-parallel), ``"k"`` the inputs
    (row-parallel), by :func:`packed_specs` for packed planes. A packed
    shard is localized and its columns padded to the format; a
    row-parallel packed shard must hold whole k-tiles, as in
    ``mxq_tpu``."""
    if shard not in ("n", "k"):
        raise ValueError(f"shard must be 'n' or 'k', not {shard!r}")
    if not isinstance(w, PackedMXQLinear):
        dim = 1 if shard == "n" else 0
        if w.shape[dim] % tp:
            raise ValueError(f"dim {dim} of {tuple(w.shape)} does not split "
                             f"over {tp} ranks")
        return w.chunk(tp, dim=dim)[rank].contiguous()
    spec = packed_specs(shard)
    if shard == "k" and w.nbp % (tp * NB_TILE):
        # mxq_tpu's kernels and its plain dequant both refuse such a
        # shard: llama2_7b's down_proj (172 blocks padded to 176) at tp 2
        # and 4
        raise ValueError(f"a row-parallel shard must hold whole k-tiles: "
                         f"{w.nbp} meta rows over {tp} ranks leave "
                         f"{w.nbp / tp:g}, not a multiple of {NB_TILE}")
    planes = {}
    for f in FIELDS:
        t = getattr(w, f)
        if spec[f][0] == "tp":
            t = t.chunk(tp, dim=0)[rank]
        elif spec[f][1] == "tp":
            t = t.chunk(tp, dim=1)[rank]
        planes[f] = t
    local = PackedMXQLinear(**planes, in_features=w.in_features,
                            out_features=w.out_features)
    return pad_to_format(localize(local))


def row_chunks(w_local, n_chunks: int, chunk_cols: int) -> list:
    """The ``n_chunks`` output chunks of ``chunk_cols`` columns each of a
    row-parallel shard, each contiguous (and, packed, padded to the
    format) once, at shard time: :func:`matmul_reducescatter` multiplies
    one per ring step."""
    if isinstance(w_local, PackedMXQLinear):
        return [pad_to_format(slice_ncols(w_local, j * chunk_cols,
                                          chunk_cols))
                for j in range(n_chunks)]
    return [w_local[:, j * chunk_cols:(j + 1) * chunk_cols].contiguous()
            for j in range(n_chunks)]


def tp_group(group):
    """The process group of the "tp" axis: ``group`` itself, or the
    mesh dim of a ``DeviceMesh``."""
    if hasattr(group, "get_group"):
        names = group.mesh_dim_names or ()
        return group.get_group("tp") if "tp" in names else group.get_group()
    return group


def _hop(t: torch.Tensor, group, dst: int, src: int):
    """Start sending ``t`` to group rank ``dst`` and receiving its
    neighbour's tensor from ``src``; returns (buffer, requests)."""
    buf = torch.empty_like(t)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t, group=group, group_peer=dst),
        dist.P2POp(dist.irecv, buf, group=group, group_peer=src)])
    return buf, reqs


def _wait(reqs) -> None:
    for r in reqs:
        r.wait()


def allgather_matmul(x_shard: torch.Tensor, w_local, matmul: Callable,
                     group, *, n_ktiles_local: int):
    """Column-parallel ``allgather_K(x) @ w_local``, overlapped. ``x_shard``
    [B, K/tp] is this rank's K-chunk (chunk d holds k-tiles
    [d*n_ktiles_local, ...)); ``w_local`` holds every K row of the local
    output columns. ``w_local`` may be a tuple of weights: one ring pass
    feeds them all (q, k, v; gate, up) and a tuple comes back."""
    if n_ktiles_local < 1:
        raise ValueError("K-sharding granularity is one k-tile (1024 "
                         "columns): need K >= tp*1024")
    group = tp_group(group)
    tp, d = dist.get_world_size(group), dist.get_rank(group)
    ws = w_local if isinstance(w_local, tuple) else (w_local,)
    rows = n_ktiles_local * KT_COLS

    def tile_mm(w, origin, xc):
        wk = (slice_ktiles(w, origin * n_ktiles_local, n_ktiles_local)
              if isinstance(w, PackedMXQLinear)
              else w[origin * rows:(origin + 1) * rows])
        return matmul(xc, wk)

    xc = x_shard.contiguous()
    pending = _hop(xc, group, (d - 1) % tp, (d + 1) % tp) if tp > 1 else None
    accs = [tile_mm(w, d, xc) for w in ws]
    for s in range(1, tp):
        xc, reqs = pending
        _wait(reqs)                   # the hop ran beside the products
        if s + 1 < tp:
            pending = _hop(xc, group, (d - 1) % tp, (d + 1) % tp)
        accs = [a + tile_mm(w, (d + s) % tp, xc) for a, w in zip(accs, ws)]
    return tuple(accs) if isinstance(w_local, tuple) else accs[0]


def matmul_reducescatter(x_local: torch.Tensor, w_chunks: Sequence,
                         matmul: Callable, group):
    """Row-parallel ``sum over ranks(x_local @ w_local)``, this rank's
    output chunk, overlapped (a ring reduce-scatter fused with the
    products). ``w_chunks`` are the local K-shard's output chunks from
    :func:`row_chunks`; chunk j accumulates around the ring from rank
    (j + 1) mod tp and lands at rank j after tp - 1 hops, each hop beside
    the next chunk's partial product."""
    group = tp_group(group)
    tp, d = dist.get_world_size(group), dist.get_rank(group)
    if len(w_chunks) != tp:
        raise ValueError(f"{len(w_chunks)} weight chunks for {tp} ranks")
    acc = matmul(x_local, w_chunks[(d - 1) % tp])
    for s in range(1, tp):
        buf, reqs = _hop(acc, group, (d + 1) % tp, (d - 1) % tp)
        nxt = matmul(x_local, w_chunks[(d - 1 - s) % tp])
        _wait(reqs)
        acc = buf + nxt
    return acc


def tp_packed_mlp(group, x_kshard, gate, up, down_chunks, matmul, *,
                  n_ktiles_local: int):
    """A Megatron MLP block with both collectives chunked and overlapped:
    one ring pass gathers x while computing gate and up (column-parallel
    shards), silu(gate) * up in f32 locally, then the down projection
    (row-parallel chunks) rides the reduce-scatter ring. Activations stay
    K-sharded between blocks: [B, H/tp] in, [B, H/tp] out."""
    gl, ul = allgather_matmul(x_kshard, (gate, up), matmul, group,
                              n_ktiles_local=n_ktiles_local)
    h = (F.silu(gl.float()) * ul.float()).to(x_kshard.dtype)
    return matmul_reducescatter(h, down_chunks, matmul, group)


def tp_block_matmuls(group, x_kshard, w_col, w_row_chunks, matmul, *,
                     n_ktiles_local: int):
    """One overlapped column-parallel -> row-parallel pair: ``(allgather_K(x)
    @ w_col) @ w_row``, returned K-sharded (the reduce-scatter's output):
    the steady-state TP dataflow."""
    h = allgather_matmul(x_kshard, w_col, matmul, group,
                         n_ktiles_local=n_ktiles_local)
    return matmul_reducescatter(h, w_row_chunks, matmul, group)
