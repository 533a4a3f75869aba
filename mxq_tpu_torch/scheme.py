"""MXQ numerical primitives used by the packer (the PTQ formulation of
``mxq_tpu/scheme.py:36-131``). The fake-quant and STE half of that module
is not ported yet (see ROADMAP.md).

Weight orientation matches the reference: ``w`` is ``[out, in]`` = ``[O, K]``.
"""

from __future__ import annotations

import torch

from mxq_tpu_torch.config import DEFAULT_SCHEME, MXQConfig


def asym_find_params(x: torch.Tensor, maxq: int):
    """Per-row affine params over the last axis (quantizer.py:81-99).

    Returns ``(scale, zero)`` with the trailing axis reduced. Degenerate rows
    (min == max) use the reference's [-1, +1] fallback. ``zero`` stays in
    floating point."""
    xmin = x.amin(dim=-1)
    xmax = x.amax(dim=-1)
    deg = xmin == xmax
    xmin = torch.where(deg, torch.full_like(xmin, -1.0), xmin)
    xmax = torch.where(deg, torch.full_like(xmax, 1.0), xmax)
    scale = (xmax - xmin) / maxq
    zero = -xmin / scale
    return scale, zero


def asym_qdq(x: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
             maxq: int, eps: float = 1e-9) -> torch.Tensor:
    """Clamp-round quant-dequant: the scale is clamped only in the division."""
    return scale * (asym_quantize(x, scale, zero, maxq, eps) - zero)


def asym_quantize(x: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                  maxq: int, eps: float = 1e-9) -> torch.Tensor:
    """Integer codes in [0, maxq] (as floats; round half to even)."""
    return torch.clamp(torch.round(x / torch.clamp(scale, min=eps) + zero),
                       0, maxq)


def split_blocks(w: torch.Tensor, cfg: MXQConfig = DEFAULT_SCHEME):
    """Split ``w [O, K]`` into the 2-bit plane (first 48 columns of every
    64-column block) and the 4-bit plane (last 16): ``(w_lo [O, K2],
    w_hi [O, K4])``."""
    o, k = w.shape
    if k % cfg.block:
        raise ValueError(f"in_features {k} must divide block {cfg.block}")
    wb = w.reshape(o, k // cfg.block, cfg.block)
    w_lo = wb[:, :, : cfg.num_2b].reshape(o, -1)
    w_hi = wb[:, :, cfg.num_2b:].reshape(o, -1)
    return w_lo, w_hi


def merge_blocks(w_lo: torch.Tensor, w_hi: torch.Tensor,
                 cfg: MXQConfig = DEFAULT_SCHEME) -> torch.Tensor:
    """Inverse of :func:`split_blocks`."""
    o = w_lo.shape[0]
    nb = w_lo.shape[1] // cfg.num_2b
    lo = w_lo.reshape(o, nb, cfg.num_2b)
    hi = w_hi.reshape(o, nb, cfg.num_4b)
    return torch.cat([lo, hi], dim=-1).reshape(o, nb * cfg.block)
