"""A tensor-parallel Llama decoder layer whose collectives are the
overlapped rings of ``overlap.py`` (port of
``mxq_tpu/parallel/tp_layer.py``).

Dataflow on each rank of the tp group (activations stay K-sharded between
blocks, so the only collectives are the rings plus one scalar all-reduce
per RMS norm):

  x_sh [rows, H/tp]
    -> sharded RMS norm (variance from one all-reduce of local sums of
       squares)
    -> q/k/v column-parallel on one activation ring (the rank's heads)
    -> RoPE, the cache write and attention over the rank's heads (the bf16
       cache is head-sharded; attention is the plain f32 einsum)
    -> o row-parallel on the reduce-scatter ring -> residual
    -> sharded RMS norm -> gate/up on one ring, silu * up, down on the
       reduce-scatter ring -> residual

The layer takes each rank's shards, made once by :func:`shard_layer` from
one layer's whole weights: q/k/v and gate/up unfused (a fused qkv's
contiguous N-shard would cut across the q|k|v boundaries, not along
heads), packed (``PackedMXQLinear``) or dense [in, out]. With packed
weights and ``matmul=llama.quant_linear`` a ring step's product is K1 at
2-511 rows, K2 at one row and K3 from 512 rows.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from mxq_tpu_torch import scheme
from mxq_tpu_torch.models import llama
from mxq_tpu_torch.packfmt import PackedMXQLinear
from mxq_tpu_torch.parallel import overlap

COL_LINEARS = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
ROW_LINEARS = ("o_proj", "down_proj")
NORMS = ("input_layernorm", "post_attention_layernorm")


def shard_layer(layer: dict, rank: int, tp: int) -> dict:
    """Rank ``rank``'s shards of one layer's whole weights over ``tp``
    ranks: column-parallel linears split their outputs, row-parallel
    linears their inputs and come as the ``tp`` output chunks of the
    reduce-scatter ring (hidden / tp columns each), the norms' weights
    split like the activations."""
    out = {n: overlap.shard_weight(layer[n], "n", rank, tp)
           for n in COL_LINEARS}
    for n in ROW_LINEARS:
        w = overlap.shard_weight(layer[n], "k", rank, tp)
        out[n] = overlap.row_chunks(w, tp, layer[NORMS[0]].shape[0] // tp)
    for n in NORMS:
        out[n] = layer[n].chunk(tp)[rank].contiguous()
    return out


def _sharded_rms_norm(x_sh, gamma_sh, hidden: int, eps: float, group):
    """RMS norm of a K-sharded activation: the row variance needs the
    whole hidden dim, so one all-reduce of the local sums of squares."""
    xf = x_sh.float()
    sumsq = (xf * xf).sum(dim=-1, keepdim=True)
    dist.all_reduce(sumsq, group=group)
    var = sumsq / hidden
    return (xf * torch.rsqrt(var + eps)).to(x_sh.dtype) * gamma_sh


def _out_features(w) -> int:
    return w.out_features if isinstance(w, PackedMXQLinear) else w.shape[1]


def _ffn_half(xf, ctx, layer, cfg, matmul, group, n_ktl):
    """The post-attention half of one layer on [rows, H/tp] activations:
    o_proj on the reduce-scatter ring, the sharded norm, gate/up on one
    activation ring, silu * up, down on the reduce-scatter ring. Returns
    the layer's output, K-sharded like its input."""
    xf = xf + overlap.matmul_reducescatter(ctx, layer["o_proj"], matmul,
                                           group)
    h2 = _sharded_rms_norm(xf, layer["post_attention_layernorm"],
                           cfg.hidden_size, cfg.rms_norm_eps, group)
    g, u = overlap.allgather_matmul(h2, (layer["gate_proj"],
                                         layer["up_proj"]), matmul, group,
                                    n_ktiles_local=n_ktl)
    inter_l = _out_features(layer["gate_proj"])
    act = (F.silu(g[..., :inter_l].float())
           * u[..., :inter_l].float()).to(xf.dtype)
    return xf + overlap.matmul_reducescatter(act, layer["down_proj"], matmul,
                                             group)


def _heads(cfg, tp: int) -> tuple[int, int, int]:
    nh, nkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    if nh % tp or nkv % tp or cfg.hidden_size % (tp * overlap.KT_COLS):
        raise ValueError(f"tp={tp} must split {nh} heads, {nkv} kv heads "
                         f"and hidden {cfg.hidden_size} in k-tiles of "
                         f"{overlap.KT_COLS}")
    return nh // tp, nkv // tp, d


def _qkv(h, layer, matmul, group, n_ktl, shape, nh_l, nkv_l, d):
    q, k, v = overlap.allgather_matmul(
        h, (layer["q_proj"], layer["k_proj"], layer["v_proj"]), matmul,
        group, n_ktiles_local=n_ktl)
    return (q[..., :nh_l * d].reshape(shape + (nh_l, d)),
            k[..., :nkv_l * d].reshape(shape + (nkv_l, d)),
            v[..., :nkv_l * d].reshape(shape + (nkv_l, d)))


def _attend(qf, kk, vv, mask, nh_l, nkv_l, d):
    """Softmax attention in f32: qf [B, Hl, T, D], kk/vv [B, S, Hkv_l, D]
    (kv heads repeated for GQA), mask [B or 1, 1, T, S] bool (True
    attends). Returns [B, Hl, T, D] f32."""
    if nkv_l != nh_l:
        kk = torch.repeat_interleave(kk, nh_l // nkv_l, dim=2)
        vv = torch.repeat_interleave(vv, nh_l // nkv_l, dim=2)
    kf = kk.transpose(1, 2).float()
    st = scheme.div_const(torch.einsum("bhtd,bhsd->bhts", qf, kf),
                          math.sqrt(d))
    st = torch.where(mask, st, torch.finfo(torch.float32).min)
    p = torch.softmax(st, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p, vv.transpose(1, 2).float())


def tp_decode_layer(group, x_sh, layer: dict, cache: dict, positions, cfg,
                    matmul: Callable):
    """One decode step of one layer on this rank: ``x_sh`` [B, H/tp]
    (this rank's K-chunk), ``layer`` from :func:`shard_layer`, ``cache``
    {"k", "v"} [B, S, Hkv/tp, D] (this rank's heads, written in place at
    row ``positions[b]`` of slot b). Returns ``(x_sh, cache)``."""
    group = overlap.tp_group(group)
    tp = dist.get_world_size(group)
    nh_l, nkv_l, d = _heads(cfg, tp)
    n_ktl = cfg.hidden_size // overlap.KT_COLS // tp
    b = x_sh.shape[0]

    h = _sharded_rms_norm(x_sh, layer["input_layernorm"], cfg.hidden_size,
                          cfg.rms_norm_eps, group)
    q, k, v = _qkv(h, layer, matmul, group, n_ktl, (b, 1), nh_l, nkv_l, d)
    cos, sin = llama.rope_tables(cfg, positions[:, None].float())
    q, k = llama.apply_rope(q, k, cos.to(q.dtype), sin.to(q.dtype))

    rows = torch.arange(b, device=x_sh.device)
    pos = positions.long()
    cache["k"][rows, pos] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, pos] = v[:, 0].to(cache["v"].dtype)
    s = cache["k"].shape[1]
    mask = (torch.arange(s, device=x_sh.device)[None, :]
            <= pos[:, None])[:, None, None, :]
    ctx = _attend(q.transpose(1, 2).float(), cache["k"], cache["v"], mask,
                  nh_l, nkv_l, d)
    ctx = ctx.reshape(b, nh_l * d).to(x_sh.dtype)
    return _ffn_half(x_sh, ctx, layer, cfg, matmul, group, n_ktl), cache


def tp_prefill_layer(group, x_sh, layer: dict, cache: dict, cfg,
                     matmul: Callable):
    """One prefill pass of one layer on this rank (T tokens per slot at
    positions 0..T-1, causal): ``x_sh`` [B, T, H/tp]; the ring products
    see [B*T, cols] rows (K3 from 512 rows). Rows 0..T-1 of this rank's
    head-sharded cache are written in place. Returns ``(x_sh, cache)``."""
    group = overlap.tp_group(group)
    tp = dist.get_world_size(group)
    nh_l, nkv_l, d = _heads(cfg, tp)
    n_ktl = cfg.hidden_size // overlap.KT_COLS // tp
    b, t, _ = x_sh.shape

    h = _sharded_rms_norm(x_sh, layer["input_layernorm"], cfg.hidden_size,
                          cfg.rms_norm_eps, group)
    q, k, v = _qkv(h.reshape(b * t, -1), layer, matmul, group, n_ktl,
                   (b, t), nh_l, nkv_l, d)
    pos = torch.arange(t, device=x_sh.device).float()[None].repeat(b, 1)
    cos, sin = llama.rope_tables(cfg, pos)
    q, k = llama.apply_rope(q, k, cos.to(q.dtype), sin.to(q.dtype))

    cache["k"][:, :t] = k.to(cache["k"].dtype)
    cache["v"][:, :t] = v.to(cache["v"].dtype)
    ar = torch.arange(t, device=x_sh.device)
    causal = (ar[None, :] <= ar[:, None])[None, None]
    ctx = _attend(q.transpose(1, 2).float(), k, v, causal, nh_l, nkv_l, d)
    ctx = ctx.transpose(1, 2).reshape(b * t, nh_l * d).to(x_sh.dtype)
    xf = _ffn_half(x_sh.reshape(b * t, -1), ctx, layer, cfg, matmul, group,
                   n_ktl)
    return xf.reshape(b, t, -1), cache
