"""Swin Transformer in PyTorch (port of ``mxq_tpu/vision/swin.py``).

Windows are carved with reshapes and permutes, cyclic shifts are
``torch.roll``, and attention runs batched over ``[B * windows, ws*ws,
C]``. The relative-position index and the shifted-window masks are
computed on the host per stage (numpy, as in ``mxq_tpu``). Eval semantics
(dropout and drop-path are the identity). Activations are ``[B, H*W, C]``
tokens; images come NHWC. The block linears (qkv/proj/fc1/fc2, ``[in,
out]``) take the MXQ fake-quant forward when ``2 <= w_bits < 32`` and
their input width is a multiple of 64.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mxq_tpu_torch import resolve_device, scheme
from mxq_tpu_torch.config import MXQConfig
from mxq_tpu_torch.vision.vit import (Draws, as_images, attention, gelu,
                                      layer_norm, patchify)


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    image_size: int = 224
    patch_size: int = 4
    embed_dim: int = 96
    depths: tuple = (2, 2, 6, 2)
    num_heads: tuple = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: int = 4
    num_classes: int = 1000
    w_bits: int = 32
    scheme: MXQConfig = dataclasses.field(default_factory=MXQConfig)

    @classmethod
    def tiny(cls, **kw) -> "SwinConfig":
        d = dict(image_size=32, patch_size=4, embed_dim=32, depths=(2, 2),
                 num_heads=(2, 4), window_size=4, num_classes=10)
        d.update(kw)
        return cls(**d)

    def stage_dim(self, i: int) -> int:
        return self.embed_dim * (2 ** i)

    def stage_res(self, i: int) -> int:
        return self.image_size // self.patch_size // (2 ** i)


BLOCK_LINEARS = ("qkv", "proj", "fc1", "fc2")


def rel_pos_index(ws: int) -> np.ndarray:
    """Pairwise relative-position index inside one window, [ws*ws,
    ws*ws] int32."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))          # [2, ws, ws]
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]              # [2, N, N]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


def shift_attn_mask(res: int, ws: int, shift: int) -> np.ndarray:
    """0 / -100 mask [windows, N, N] of the shifted windows: tokens of
    different regions of the rolled image do not attend each other."""
    img = np.zeros((res, res))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wslice in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wslice] = cnt
            cnt += 1
    win = img.reshape(res // ws, ws, res // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def init_params(cfg: SwinConfig, seed: int = 0, dtype=torch.float32,
                device: str | torch.device = "cuda") -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``;
    ``stages`` is a list, each stage's ``blocks`` a list of dicts."""
    r = Draws(seed, resolve_device(device), dtype)

    def lin(i, o):
        return r.normal((i, o), 1 / math.sqrt(i))

    patch_dim = 3 * cfg.patch_size ** 2
    params = {"patch_embed": lin(patch_dim, cfg.embed_dim),
              "patch_ln": r.const((cfg.embed_dim,), 1.0),
              "patch_ln_b": r.const((cfg.embed_dim,), 0.0),
              "stages": []}
    ws = cfg.window_size
    for i in range(len(cfg.depths)):
        dim, nh = cfg.stage_dim(i), cfg.num_heads[i]
        st = {"blocks": []}
        if i > 0:
            prev = cfg.stage_dim(i - 1)
            st["merge_ln"] = r.const((4 * prev,), 1.0)
            st["merge_ln_b"] = r.const((4 * prev,), 0.0)
            st["merge"] = lin(4 * prev, dim)
        for _ in range(cfg.depths[i]):
            hid = cfg.mlp_ratio * dim
            st["blocks"].append({
                "ln1": r.const((dim,), 1.0), "ln1_b": r.const((dim,), 0.0),
                "qkv": lin(dim, 3 * dim), "qkv_b": r.const((3 * dim,), 0.0),
                "proj": lin(dim, dim), "proj_b": r.const((dim,), 0.0),
                "rel_bias": r.normal(((2 * ws - 1) ** 2, nh), 0.02),
                "ln2": r.const((dim,), 1.0), "ln2_b": r.const((dim,), 0.0),
                "fc1": lin(dim, hid), "fc1_b": r.const((hid,), 0.0),
                "fc2": lin(hid, dim), "fc2_b": r.const((dim,), 0.0),
            })
        params["stages"].append(st)
    hd = cfg.stage_dim(len(cfg.depths) - 1)
    params["norm"] = r.const((hd,), 1.0)
    params["norm_b"] = r.const((hd,), 0.0)
    params["head"] = lin(hd, cfg.num_classes)
    return params


def _linear(x, w, cfg: SwinConfig):
    if 2 <= cfg.w_bits < 32 and w.shape[0] % 64 == 0:
        w = scheme.mxq_fake_quant_qat(w.T, cfg.scheme).T
    return x @ w


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * windows, ws*ws, C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, h: int, w: int
                   ) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    c = x.shape[-1]
    x = x.reshape(-1, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, h, w, c)


def window_attention(xw, p, nh: int, rel_idx, mask, cfg: SwinConfig):
    """[BW, N, C] windowed multi-head attention with the relative position
    bias and, for shifted windows, ``mask`` [windows, N, N]."""
    bw, n, c = xw.shape
    bias = p["rel_bias"][rel_idx.reshape(-1)].reshape(n, n, nh)
    bias = bias.permute(2, 0, 1)[None]
    if mask is not None:
        nw = mask.shape[0]
        bias = (bias[None] + mask[None, :, None]).expand(
            bw // nw, nw, nh, n, n).reshape(bw, nh, n, n)
    ctx = attention(_linear(xw, p["qkv"], cfg) + p["qkv_b"], nh, bias)
    return _linear(ctx, p["proj"], cfg) + p["proj_b"]


def block(x, p, cfg: SwinConfig, res: int, nh: int, shift: int, rel_idx,
          mask):
    """One (S)W-MSA block; x [B, H*W, C]."""
    b, l, c = x.shape
    ws = min(cfg.window_size, res)
    shortcut = x
    x = layer_norm(x, p["ln1"], p["ln1_b"]).reshape(b, res, res, c)
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    xw = window_attention(window_partition(x, ws), p, nh, rel_idx, mask,
                          cfg)
    x = window_reverse(xw, ws, res, res)
    if shift > 0:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    x = shortcut + x.reshape(b, l, c)
    y = layer_norm(x, p["ln2"], p["ln2_b"])
    y = _linear(gelu(_linear(y, p["fc1"], cfg) + p["fc1_b"]), p["fc2"],
                cfg) + p["fc2_b"]
    return x + y


def patch_merge(x, st, res: int):
    """[B, H*W, C] -> [B, H/2*W/2, 2C]."""
    b, l, c = x.shape
    x = x.reshape(b, res // 2, 2, res // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, (res // 2) ** 2, 4 * c)
    x = layer_norm(x, st["merge_ln"], st["merge_ln_b"])
    return x @ st["merge"]


def forward(params, images, cfg: SwinConfig):
    """[B, H, W, 3] -> logits [B, num_classes]."""
    x = patchify(as_images(params, images), cfg.patch_size) \
        @ params["patch_embed"]
    x = layer_norm(x, params["patch_ln"], params["patch_ln_b"])
    dev = x.device
    for i, st in enumerate(params["stages"]):
        res = cfg.stage_res(i)
        if i > 0:
            x = patch_merge(x, st, cfg.stage_res(i - 1))
        ws = min(cfg.window_size, res)
        rel_idx = torch.from_numpy(rel_pos_index(ws)).long().to(dev)
        for j, bp in enumerate(st["blocks"]):
            # blocks alternate W-MSA and SW-MSA (shift = ws // 2)
            shift = 0 if (j % 2 == 0 or ws >= res) else ws // 2
            mask = (torch.from_numpy(shift_attn_mask(res, ws, shift)).to(dev)
                    if shift > 0 else None)
            x = block(x, bp, cfg, res, cfg.num_heads[i], shift, rel_idx,
                      mask)
    x = layer_norm(x, params["norm"], params["norm_b"])
    return x.mean(dim=1) @ params["head"]
