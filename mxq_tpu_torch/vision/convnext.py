"""ConvNeXt in PyTorch (port of ``mxq_tpu/vision/convnext.py``).

Layout: the activations are NHWC ``[B, H, W, C]`` between layers, as in
``mxq_tpu``, so LayerNorm and the pointwise linears act on the last axis.
Each convolution views them as NCHW (a permute, no copy: the tensor is
then NCHW in ``channels_last`` memory) and calls ``F.conv2d``: the stem
and downsampling convolutions with stride 4 and 2, the depthwise 7x7 with
``groups=C`` and padding 3 (``SAME``). Convolution weights keep
``mxq_tpu``'s HWIO layout in the params dict (``[kh, kw, cin, cout]``,
the depthwise one ``[7, 7, C]``) and are permuted to OIHW per call. The
pointwise linears (``pwconv1``/``pwconv2``, ``[in, out]``) take the MXQ
fake-quant forward when ``2 <= w_bits < 32``. Eval semantics (stochastic
depth and dropout are the identity).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from mxq_tpu_torch import resolve_device, scheme
from mxq_tpu_torch.config import MXQConfig
from mxq_tpu_torch.vision.vit import Draws, as_images, block_view, gelu
from mxq_tpu_torch.vision.vit import layer_norm as _ln


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    depths: tuple = (3, 3, 9, 3)
    dims: tuple = (96, 192, 384, 768)
    num_classes: int = 1000
    layer_scale_init: float = 1e-6
    eps: float = 1e-6
    w_bits: int = 32
    scheme: MXQConfig = dataclasses.field(default_factory=MXQConfig)

    @classmethod
    def tiny(cls, **kw) -> "ConvNeXtConfig":
        d = dict(depths=(2, 2), dims=(64, 128), num_classes=10)
        d.update(kw)
        return cls(**d)


BLOCK_LINEARS = ("pwconv1", "pwconv2")     # what the pruner targets


def init_params(cfg: ConvNeXtConfig, seed: int = 0, dtype=torch.float32,
                device: str | torch.device = "cuda") -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``:
    convolutions, linears and the head truncated normal (std 0.02, cut at
    2 standard deviations), as ``mxq_tpu`` draws them."""
    r = Draws(seed, resolve_device(device), dtype)
    stem = cfg.dims[0]
    params = {"stem_conv": r.truncated((4, 4, 3, stem), 0.02),
              "stem_conv_b": r.const((stem,), 0.0),
              "stem_ln": r.const((stem,), 1.0),
              "stem_ln_b": r.const((stem,), 0.0)}
    stages = []
    for i, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims)):
        st = {}
        if i > 0:
            prev = cfg.dims[i - 1]
            st["ds_ln"] = r.const((prev,), 1.0)
            st["ds_ln_b"] = r.const((prev,), 0.0)
            st["ds_conv"] = r.truncated((2, 2, prev, dim), 0.02)
            st["ds_conv_b"] = r.const((dim,), 0.0)
        st["blocks"] = {
            "dwconv": r.truncated((depth, 7, 7, dim), 0.02),
            "dwconv_b": r.const((depth, dim), 0.0),
            "ln": r.const((depth, dim), 1.0),
            "ln_b": r.const((depth, dim), 0.0),
            "pwconv1": r.truncated((depth, dim, 4 * dim), 0.02),
            "pwconv1_b": r.const((depth, 4 * dim), 0.0),
            "pwconv2": r.truncated((depth, 4 * dim, dim), 0.02),
            "pwconv2_b": r.const((depth, dim), 0.0),
            "gamma": r.const((depth, dim), cfg.layer_scale_init),
        }
        stages.append(st)
    params["stages"] = stages
    hd = cfg.dims[-1]
    params["norm"] = r.const((hd,), 1.0)
    params["norm_b"] = r.const((hd,), 0.0)
    params["head"] = r.truncated((hd, cfg.num_classes), 0.02)
    params["head_b"] = r.const((cfg.num_classes,), 0.0)
    return params


def layer_norm(x, w, b, eps: float = 1e-6):
    return _ln(x, w, b, eps)


def _linear(x, w, cfg: ConvNeXtConfig):
    if 2 <= cfg.w_bits < 32:
        w = scheme.mxq_fake_quant_qat(w.T, cfg.scheme).T
    return x @ w


def _conv(x, w_hwio, b, stride: int, padding: int, groups: int = 1):
    """NHWC x, HWIO weight -> NHWC: ``F.conv2d`` on the NCHW view."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1), b,
                 stride=stride, padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def _dwconv(x, w, b):
    """Depthwise 7x7, NHWC: w [7, 7, C] -> a grouped conv, groups = C."""
    return _conv(x, w[:, :, None, :], b, 1, 3, groups=x.shape[-1])


def block(x, p, cfg: ConvNeXtConfig):
    """One ConvNeXt block, channels-last throughout."""
    inp = x
    x = _dwconv(x, p["dwconv"], p["dwconv_b"])
    x = layer_norm(x, p["ln"], p["ln_b"], cfg.eps)
    x = gelu(_linear(x, p["pwconv1"], cfg) + p["pwconv1_b"])
    x = _linear(x, p["pwconv2"], cfg) + p["pwconv2_b"]
    return inp + p["gamma"] * x


def downsample(x, st, cfg: ConvNeXtConfig, stage_idx: int, params):
    if stage_idx == 0:
        x = _conv(x, params["stem_conv"], params["stem_conv_b"], 4, 0)
        return layer_norm(x, params["stem_ln"], params["stem_ln_b"],
                          cfg.eps)
    x = layer_norm(x, st["ds_ln"], st["ds_ln_b"], cfg.eps)
    return _conv(x, st["ds_conv"], st["ds_conv_b"], 2, 0)


def run_stage(x, st, cfg: ConvNeXtConfig):
    for j in range(st["blocks"]["pwconv1"].shape[0]):
        x = block(x, block_view(st["blocks"], j), cfg)
    return x


def forward_features(params, images, cfg: ConvNeXtConfig):
    """[B, H, W, 3] NHWC -> pooled features [B, dims[-1]]: the stages, a
    global average pool, LayerNorm."""
    x = as_images(params, images)
    for i, st in enumerate(params["stages"]):
        x = downsample(x, st, cfg, i, params)
        x = run_stage(x, st, cfg)
    x = x.mean(dim=(1, 2))
    return layer_norm(x, params["norm"], params["norm_b"], cfg.eps)


def forward(params, images, cfg: ConvNeXtConfig):
    """[B, H, W, 3] -> logits [B, num_classes]."""
    x = forward_features(params, images, cfg)
    return x @ params["head"] + params["head_b"]
