"""Calibration-based pruning and quantization of the vision models (port
of ``mxq_tpu/vision/prune_vision.py``): one calibration batch, Wanda or
magnitude masks (``ptq.prune``) over each block's linears.

ViT and DeiT prune block by block, each block's input the previous pruned
block's output. ConvNeXt prunes stage by stage, every block's statistics
taken from the unpruned blocks' forward, as ``mxq_tpu`` (and the
reference it follows) does: the next stage calibrates on the unpruned
stage's output.
"""

from __future__ import annotations

import torch

from mxq_tpu_torch import scheme
from mxq_tpu_torch.ptq import prune as prune_lib
from mxq_tpu_torch.vision import convnext, vit


def _keep(w, inp, method: str, sparsity: float, n: int, m: int):
    """Keep-mask of ``w`` [in, out] from its input activations ``inp``."""
    if method == "magnitude":
        return prune_lib.magnitude_mask(w, sparsity, n, m)
    col_sq = (inp.reshape(-1, w.shape[0]).float() ** 2).sum(dim=0)
    return prune_lib.wanda_mask(w, col_sq, sparsity, n, m)


def _block_inputs(x, p, cfg: vit.ViTConfig) -> dict:
    """The activations feeding each linear of one encoder block."""
    y1 = vit.layer_norm(x, p["ln1"], p["ln1_b"])
    ctx = vit.attention(y1 @ p["qkv"], cfg.num_heads)
    x2 = x + ctx @ p["proj"]
    y2 = vit.layer_norm(x2, p["ln2"], p["ln2_b"])
    return {"qkv": y1, "proj": ctx, "fc1": y2,
            "fc2": vit.gelu(y2 @ p["fc1"])}


@torch.no_grad()
def prune_vit(params: dict, cfg: vit.ViTConfig, images,
              method: str = "wanda", sparsity: float = 0.5,
              n: int = 0, m: int = 0) -> dict:
    """Sequential block-by-block pruning with one calibration batch (DeiT
    too: ``cfg.distilled`` adds the dist token, the flow is the same)."""
    x = vit.embed(params, images, cfg)
    stacked = params["blocks"]
    new = {k: [] for k in stacked}
    for i in range(cfg.num_layers):
        p = vit.block_view(stacked, i)
        inputs = _block_inputs(x, p, cfg)
        p = dict(p)
        for name in vit.BLOCK_LINEARS:
            p[name] = p[name] * _keep(p[name], inputs[name], method,
                                      sparsity, n, m)
        x = vit.block(x, p, cfg)
        for k in stacked:
            new[k].append(p[k])
    return dict(params, blocks={k: torch.stack(v) for k, v in new.items()})


@torch.no_grad()
def prune_convnext(params: dict, cfg: convnext.ConvNeXtConfig, images,
                   method: str = "wanda", sparsity: float = 0.5,
                   n: int = 0, m: int = 0) -> dict:
    """Stage-by-stage pruning of the pointwise linears: per block, the
    inputs of both linears from the unpruned block, which also carries
    the activations on (the reference prunes after its hooked forward and
    never re-forwards)."""
    x = vit.as_images(params, images)
    stages = []
    for i, st in enumerate(params["stages"]):
        x = convnext.downsample(x, st, cfg, i, params)
        blocks = st["blocks"]
        new = {k: [] for k in blocks}
        for j in range(blocks["pwconv1"].shape[0]):
            p = dict(vit.block_view(blocks, j))
            h = convnext._dwconv(x, p["dwconv"], p["dwconv_b"])
            a1 = convnext.layer_norm(h, p["ln"], p["ln_b"], cfg.eps)
            a2 = vit.gelu(a1 @ p["pwconv1"] + p["pwconv1_b"])
            ins = {"pwconv1": a1, "pwconv2": a2}
            x = convnext.block(x, p, cfg)          # unpruned propagation
            for name in convnext.BLOCK_LINEARS:
                p[name] = p[name] * _keep(p[name], ins[name], method,
                                          sparsity, n, m)
            for k in blocks:
                new[k].append(p[k])
        stages.append(dict(st, blocks={k: torch.stack(v)
                                       for k, v in new.items()}))
    return dict(params, stages=stages)


def _zero_share(ws) -> float:
    zeros = sum(int((w == 0).sum()) for w in ws)
    total = sum(w.numel() for w in ws)
    return zeros / max(total, 1)


def check_sparsity(params: dict) -> float:
    """Share of zeros in the ViT / DeiT block linears."""
    return _zero_share([params["blocks"][n] for n in vit.BLOCK_LINEARS])


def check_sparsity_convnext(params: dict) -> float:
    """Share of zeros in the ConvNeXt pointwise linears."""
    return _zero_share([st["blocks"][n] for st in params["stages"]
                        for n in convnext.BLOCK_LINEARS])


def _fake_quant_stack(stack: torch.Tensor, cfg) -> torch.Tensor:
    """MXQ PTQ quant-dequant of each [in, out] layer of a stack."""
    return torch.stack([scheme.mxq_fake_quant_ptq(w.T, cfg.scheme).T
                        for w in stack])


@torch.no_grad()
def quantize_vit(params: dict, cfg: vit.ViTConfig) -> dict:
    """MXQ quant-dequant of every block linear."""
    blocks = dict(params["blocks"])
    for name in vit.BLOCK_LINEARS:
        blocks[name] = _fake_quant_stack(blocks[name], cfg)
    return dict(params, blocks=blocks)


@torch.no_grad()
def quantize_convnext(params: dict, cfg: convnext.ConvNeXtConfig) -> dict:
    """MXQ quant-dequant of the pointwise linears whose input width is a
    multiple of 64."""
    stages = []
    for st in params["stages"]:
        b = st["blocks"]
        stages.append(dict(st, blocks={**b, **{
            name: _fake_quant_stack(b[name], cfg)
            for name in convnext.BLOCK_LINEARS if b[name].shape[1] % 64 == 0}}))
    return dict(params, stages=stages)
