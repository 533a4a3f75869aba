"""The int8 KV cache for serving (port of ``mxq_tpu/serving/kvcache.py``).

Layout (head-major, the decode-attention kernel's contract, ``ops/attn_int8``):
codes ``[L, B, H, S, D]`` int8, scales ``[L, B, H, S]`` bf16, one symmetric
scale per (token, head) (group = head_dim). Unlike the JAX version, which
returns new buffers, :func:`cache_update_layer` writes into the buffers it
is given.
"""

from __future__ import annotations

import torch

from mxq_tpu_torch import resolve_device
from mxq_tpu_torch.scheme import div_const


def init_quant_cache(num_layers: int, batch: int, max_len: int, kv_heads: int,
                     head_dim: int, group: int | None = None,
                     device: str | torch.device = "cuda") -> dict:
    """Zeroed stacked cache dict on ``device`` (the card unless the caller
    names the CPU). ``group`` must equal ``head_dim``."""
    device = resolve_device(device)
    g = group or head_dim
    if g != head_dim:
        raise ValueError(f"serving cache requires group == head_dim "
                         f"({g} != {head_dim})")
    code_shape = (num_layers, batch, kv_heads, max_len, head_dim)
    scale_shape = (num_layers, batch, kv_heads, max_len)
    return {"k_codes": torch.zeros(code_shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(scale_shape, dtype=torch.bfloat16,
                                   device=device),
            "v_codes": torch.zeros(code_shape, dtype=torch.int8, device=device),
            "v_scale": torch.zeros(scale_shape, dtype=torch.bfloat16,
                                   device=device)}


def quantize_kv(x: torch.Tensor, group: int):
    """[..., D] -> int8 codes [..., D], bf16 scales [..., D//G]: symmetric
    max-abs per group. Codes divide by the f32 scale; the scale is stored
    in bf16."""
    shape = x.shape
    g = x.reshape(shape[:-1] + (shape[-1] // group, group)).float()
    m = g.abs().amax(dim=-1, keepdim=True)
    s = div_const(m, 127.0)
    codes = torch.round(g / torch.clamp(s, min=1e-8)).to(torch.int8)
    return codes.reshape(shape), s[..., 0].to(torch.bfloat16)


def dequantize_kv(codes: torch.Tensor, scales: torch.Tensor, group: int,
                  dtype=torch.bfloat16) -> torch.Tensor:
    shape = codes.shape
    c = codes.reshape(shape[:-1] + (shape[-1] // group, group)).float()
    out = c * scales.float()[..., None]
    return out.reshape(shape).to(dtype)


def quantize_kv_headmajor(x: torch.Tensor):
    """[B, T, H, D] time-major K/V -> codes [B, H, T, D] int8, scales
    [B, H, T] bf16 (group == head_dim)."""
    xt = x.transpose(1, 2)
    codes, scales = quantize_kv(xt, xt.shape[-1])
    return codes.contiguous(), scales[..., 0].contiguous()


def cache_update_layer(cache_layer: dict, k_new: torch.Tensor,
                       v_new: torch.Tensor, pos: int,
                       group: int | None = None) -> dict:
    """Quantize [B, T, H, D] new K/V and write them IN PLACE at sequence
    rows ``pos .. pos+T`` of a per-layer head-major cache (codes
    [B, H, S, D], scales [B, H, S]). Returns the same dict. Raises if the
    rows do not fit (the JAX version's dynamic_update_slice would clamp)."""
    t = k_new.shape[1]
    s = cache_layer["k_codes"].shape[2]
    if not 0 <= pos <= s - t:
        raise ValueError(f"rows {pos}..{pos + t} do not fit a cache of {s}")
    for name, x in (("k", k_new), ("v", v_new)):
        codes, scales = quantize_kv_headmajor(x)
        cache_layer[f"{name}_codes"][:, :, pos:pos + t] = codes
        cache_layer[f"{name}_scale"][:, :, pos:pos + t] = scales
    return cache_layer


def cache_read_layer(cache_layer: dict, group: int | None = None,
                     dtype=torch.bfloat16):
    """Dequantize a per-layer head-major cache to time-major k, v
    [B, S, H, D]."""
    def rd(codes, scales):
        out = codes.float() * scales.float()[..., None]
        return out.transpose(1, 2).to(dtype)

    return (rd(cache_layer["k_codes"], cache_layer["k_scale"]),
            rd(cache_layer["v_codes"], cache_layer["v_scale"]))
