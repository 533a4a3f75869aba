"""MLP-Mixer in PyTorch (port of ``mxq_tpu/vision/mixer.py``): every block
is a token-mixing MLP across the patch axis (on x transposed) and a
channel-mixing MLP across features. Parameters as in ``vit.py``: blocks
stacked on ``[L]``, linears ``[in, out]``, quantizable with the MXQ
fake-quant forward when ``2 <= w_bits < 32`` and the input width is a
multiple of 64. Images come NHWC.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mxq_tpu_torch import resolve_device, scheme
from mxq_tpu_torch.config import MXQConfig
from mxq_tpu_torch.vision.vit import (Draws, as_images, block_view, gelu,
                                      layer_norm, patchify)


@dataclasses.dataclass(frozen=True)
class MixerConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    tokens_mlp_dim: int = 384
    channels_mlp_dim: int = 3072
    num_classes: int = 1000
    w_bits: int = 32
    scheme: MXQConfig = dataclasses.field(default_factory=MXQConfig)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def tiny(cls, **kw) -> "MixerConfig":
        d = dict(image_size=32, patch_size=8, hidden_size=128, num_layers=2,
                 tokens_mlp_dim=64, channels_mlp_dim=256, num_classes=10)
        d.update(kw)
        return cls(**d)


BLOCK_LINEARS = ("tok_fc1", "tok_fc2", "ch_fc1", "ch_fc2")


def init_params(cfg: MixerConfig, seed: int = 0, dtype=torch.float32,
                device: str | torch.device = "cuda") -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``."""
    r = Draws(seed, resolve_device(device), dtype)
    h, l, p = cfg.hidden_size, cfg.num_layers, cfg.num_patches
    patch_dim = 3 * cfg.patch_size ** 2

    def lin(i, o):
        return r.normal((l, i, o), 1 / math.sqrt(i))

    blocks = {"tok_fc1": lin(p, cfg.tokens_mlp_dim),
              "tok_fc2": lin(cfg.tokens_mlp_dim, p),
              "ch_fc1": lin(h, cfg.channels_mlp_dim),
              "ch_fc2": lin(cfg.channels_mlp_dim, h),
              "ln1": r.const((l, h), 1.0), "ln1_b": r.const((l, h), 0.0),
              "ln2": r.const((l, h), 1.0), "ln2_b": r.const((l, h), 0.0)}
    return {"patch_embed": r.normal((patch_dim, h), 1 / math.sqrt(patch_dim)),
            "blocks": blocks,
            "ln_f": r.const((h,), 1.0), "ln_f_b": r.const((h,), 0.0),
            "head": r.normal((h, cfg.num_classes), 0.02)}


def _linear(x, w, cfg: MixerConfig):
    if 2 <= cfg.w_bits < 32 and w.shape[0] % 64 == 0:
        w = scheme.mxq_fake_quant_qat(w.T, cfg.scheme).T
    return x @ w


def block(x, p, cfg: MixerConfig):
    """Token mixing on x^T [B, C, P], then channel mixing."""
    y = layer_norm(x, p["ln1"], p["ln1_b"]).transpose(1, 2)
    y = _linear(gelu(_linear(y, p["tok_fc1"], cfg)), p["tok_fc2"],
                cfg).transpose(1, 2)
    x = x + y
    y = layer_norm(x, p["ln2"], p["ln2_b"])
    return x + _linear(gelu(_linear(y, p["ch_fc1"], cfg)), p["ch_fc2"], cfg)


def forward(params, images, cfg: MixerConfig) -> torch.Tensor:
    """[B, H, W, 3] -> logits [B, num_classes]: the blocks, a final
    LayerNorm, the mean over tokens, the head."""
    x = patchify(as_images(params, images), cfg.patch_size) \
        @ params["patch_embed"]
    for i in range(cfg.num_layers):
        x = block(x, block_view(params["blocks"], i), cfg)
    x = layer_norm(x, params["ln_f"], params["ln_f_b"])
    return x.mean(dim=1) @ params["head"]
