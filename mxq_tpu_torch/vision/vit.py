"""Vision Transformer (ViT, and DeiT with ``distilled=True``) in PyTorch
(port of ``mxq_tpu/vision/vit.py``).

Parameters are a plain dict as in ``mxq_tpu``: linear weights stored
``[in, out]`` (``x @ w``), the encoder blocks stacked on a leading
``[L]`` axis and run in a Python loop. Images come NHWC ``[B, H, W, 3]``.
The block linears take ``mxq_tpu``'s MXQ fake-quant forward when
``2 <= w_bits < 32`` (``scheme.mxq_fake_quant_qat``). GELU is the tanh
approximation, ``jax.nn.gelu``'s default.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from mxq_tpu_torch import resolve_device, scheme
from mxq_tpu_torch.config import MXQConfig


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    num_classes: int = 1000
    w_bits: int = 32
    distilled: bool = False     # DeiT: dist token + second head, eval =
                                # mean of both heads
    scheme: MXQConfig = dataclasses.field(default_factory=MXQConfig)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def tiny(cls, **kw) -> "ViTConfig":
        d = dict(image_size=32, patch_size=8, hidden_size=128, num_layers=2,
                 num_heads=4, mlp_dim=256, num_classes=10)
        d.update(kw)
        return cls(**d)


BLOCK_LINEARS = ("qkv", "proj", "fc1", "fc2")


class Draws:
    """Seeded draws on ``device`` from one ``torch.Generator``."""

    def __init__(self, seed: int, device: torch.device, dtype):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.device, self.dtype = device, dtype

    def normal(self, shape, std: float = 1.0) -> torch.Tensor:
        return (torch.randn(shape, generator=self.gen, device=self.device)
                * std).to(self.dtype)

    def truncated(self, shape, std: float, bound: float = 2.0
                  ) -> torch.Tensor:
        """Normal draws cut to [-bound, bound], times ``std`` (inverse CDF
        of a uniform draw)."""
        c = math.erf(bound / math.sqrt(2))
        u = torch.rand(shape, generator=self.gen, device=self.device)
        z = torch.erfinv((2 * u - 1) * c) * math.sqrt(2)
        return (z.clamp(-bound, bound) * std).to(self.dtype)

    def const(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=self.dtype, device=self.device)


def init_params(cfg: ViTConfig, seed: int = 0, dtype=torch.float32,
                device: str | torch.device = "cuda") -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    (the draws differ from ``mxq_tpu``'s; the layout is the same)."""
    r = Draws(seed, resolve_device(device), dtype)
    h, l = cfg.hidden_size, cfg.num_layers
    patch_dim = 3 * cfg.patch_size ** 2

    def lin(i, o):
        return r.normal((l, i, o), 1 / math.sqrt(i))

    blocks = {"qkv": lin(h, 3 * h), "proj": lin(h, h),
              "fc1": lin(h, cfg.mlp_dim), "fc2": lin(cfg.mlp_dim, h),
              "ln1": r.const((l, h), 1.0), "ln1_b": r.const((l, h), 0.0),
              "ln2": r.const((l, h), 1.0), "ln2_b": r.const((l, h), 0.0)}
    n_tok = cfg.num_patches + 1 + int(cfg.distilled)
    params = {
        "patch_embed": r.normal((patch_dim, h), 1 / math.sqrt(patch_dim)),
        "pos_embed": r.normal((1, n_tok, h), 0.02),
        "cls_token": r.const((1, 1, h), 0.0),
        "blocks": blocks,
        "ln_f": r.const((h,), 1.0), "ln_f_b": r.const((h,), 0.0),
        "head": r.normal((h, cfg.num_classes), 0.02),
    }
    if cfg.distilled:
        params["dist_token"] = r.const((1, 1, h), 0.0)
        params["head_dist"] = r.normal((h, cfg.num_classes), 0.02)
    return params


def layer_norm(x, w, b, eps: float = 1e-6):
    """LayerNorm over the last axis (population variance)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def gelu(x):
    return F.gelu(x, approximate="tanh")


def _linear(x, w, cfg: ViTConfig):
    if 2 <= cfg.w_bits < 32:
        w = scheme.mxq_fake_quant_qat(w.T, cfg.scheme).T
    return x @ w


def attention(qkv: torch.Tensor, nh: int, bias=None) -> torch.Tensor:
    """Softmax attention of a fused qkv [B, T, 3*C]: heads split as
    (3, nh, d); ``bias`` is added to the scores [B, nh, T, T]. Returns
    [B, T, C]."""
    b, t, c3 = qkv.shape
    c = c3 // 3
    d = c // nh
    qkv = qkv.reshape(b, t, 3, nh, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    att = scheme.div_const(torch.einsum("bthd,bshd->bhts", q, k),
                           math.sqrt(d))
    if bias is not None:
        att = att + bias
    att = torch.softmax(att, dim=-1)
    return torch.einsum("bhts,bshd->bthd", att, v).reshape(b, t, c)


def block(x, p, cfg: ViTConfig):
    y = layer_norm(x, p["ln1"], p["ln1_b"])
    ctx = attention(_linear(y, p["qkv"], cfg), cfg.num_heads)
    x = x + _linear(ctx, p["proj"], cfg)
    y = layer_norm(x, p["ln2"], p["ln2_b"])
    return x + _linear(gelu(_linear(y, p["fc1"], cfg)), p["fc2"], cfg)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, N, patch*patch*3]."""
    b, hh, ww, c = images.shape
    x = images.reshape(b, hh // patch, patch, ww // patch, patch, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        b, (hh // patch) * (ww // patch), patch * patch * c)


def as_images(params: dict, images) -> torch.Tensor:
    """``images`` (numpy or a tensor) on the parameters' device."""
    dev = next(v for v in params.values()
               if isinstance(v, torch.Tensor)).device
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.array(images, np.float32))
    return images.to(dev)


def embed(params, images, cfg: ViTConfig) -> torch.Tensor:
    """Patch embedding + special tokens + positions: the encoder input."""
    x = patchify(as_images(params, images), cfg.patch_size) \
        @ params["patch_embed"]
    b, _, h = x.shape
    toks = [params["cls_token"].expand(b, 1, h)]
    if cfg.distilled:
        toks.append(params["dist_token"].expand(b, 1, h))
    return torch.cat(toks + [x], dim=1) + params["pos_embed"]


def block_view(stack: dict, i: int) -> dict:
    return {k: v[i] for k, v in stack.items()}


def forward(params, images, cfg: ViTConfig) -> torch.Tensor:
    """[B, H, W, 3] -> logits [B, num_classes]. DeiT (``distilled``):
    cls and dist tokens prepended, the output the mean of both heads."""
    x = embed(params, images, cfg)
    for i in range(cfg.num_layers):
        x = block(x, block_view(params["blocks"], i), cfg)
    x = layer_norm(x, params["ln_f"], params["ln_f_b"])
    if cfg.distilled:
        return (x[:, 0] @ params["head"] + x[:, 1] @ params["head_dist"]) / 2
    return x[:, 0] @ params["head"]
