"""MXQ numerical primitives: the PTQ formulation the packer uses
(``mxq_tpu/scheme.py:36-131``) and the QAT fake-quant forward with its
straight-through estimators (``:139-190``, ``:314-441``, ``:595``). The
PTQ fake-quant functions (double quantization, ``mxq_quantize_ptq``, the
outlier and sub-2-bit paths) are not ported yet (see ROADMAP.md).

Weight orientation matches the reference: ``w`` is ``[out, in]`` = ``[O, K]``.
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

from functools import partial

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


# ---------------------------------------------------------------------------
# QAT fake-quant (MXAsymQuantizer semantics, alpha/beta form)
# ---------------------------------------------------------------------------


def _qat_affine_qdq(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                    levels: int, eps: float) -> torch.Tensor:
    """q = round((x-beta)/(alpha+eps) * levels)/levels; q*(alpha+eps)+beta
    (utils_quant.py:456-460)."""
    a = alpha + eps
    q = torch.round((x - beta) / a * levels) / levels
    return q * a + beta


def _minmax(g: torch.Tensor):
    """(max - min, min) over the last axis, kept."""
    lo = g.amin(dim=-1, keepdim=True)
    return g.amax(dim=-1, keepdim=True) - lo, lo


def mxq_fake_quant_qat(w: torch.Tensor,
                       cfg: MXQConfig = DEFAULT_SCHEME) -> torch.Tensor:
    """MXAsymQuantizer.forward for a 2-D ``w [O, K]`` (utils_quant.py:
    330-461): the 2-bit plane per (row, 16-group) min/max, the gathered
    4-bit columns with one per-row min/max."""
    o, _ = w.shape
    w_lo, w_hi = split_blocks(w, cfg)
    g = w_lo.reshape(o, -1, cfg.group)
    lo_dq = _qat_affine_qdq(g, *_minmax(g), cfg.maxq_lo, cfg.qat_eps)
    hi_dq = _qat_affine_qdq(w_hi, *_minmax(w_hi), cfg.maxq_hi, cfg.qat_eps)
    return merge_blocks(lo_dq.reshape(o, -1), hi_dq, cfg)


class _ClipSTE(torch.autograd.Function):
    """Forward ``fq(x)``; backward passes the gradient where
    ``-clip < x < clip`` and zeroes it elsewhere (utils_quant.py:464-475,
    92-102; mxq_tpu/scheme.py:186-190, 404-407)."""

    @staticmethod
    def forward(ctx, x, fq, clip):
        ctx.save_for_backward(x)
        ctx.clip = clip
        return fq(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        mask = (x > -ctx.clip) & (x < ctx.clip)
        return torch.where(mask, g, torch.zeros_like(g)), None, None


def mxq_fake_quant_ste(w: torch.Tensor,
                       cfg: MXQConfig = DEFAULT_SCHEME) -> torch.Tensor:
    """:func:`mxq_fake_quant_qat` with the straight-through backward,
    clipped at ``cfg.ste_clip``."""
    return _ClipSTE.apply(w, partial(mxq_fake_quant_qat, cfg=cfg),
                          cfg.ste_clip)


# ---------------------------------------------------------------------------
# Activation / KV-cache fake-quant (Sym/Asym quantizers)
# ---------------------------------------------------------------------------


def _groups(x: torch.Tensor, groupsize: int) -> torch.Tensor:
    """``x [..., F]`` viewed as ``[..., F/groupsize, groupsize]``."""
    return x.reshape(x.shape[:-1] + (x.shape[-1] // groupsize, groupsize))


def sym_fake_quant(x: torch.Tensor, bits: int, groupsize: int = 128,
                   layerwise: bool = False) -> torch.Tensor:
    """SymQuantizer.forward (utils_quant.py:31-89): groupwise max-abs
    symmetric fake-quant, ``round(x*s) / (s + 1e-6)`` with
    ``s = (2^(b-1)-1) / (max + 1e-6)``, groups along the last axis at any
    rank (the 2-D semantics; :func:`sym_fake_quant_ref3d` keeps the
    reference's 3-D branch)."""
    if layerwise:
        m = x.abs().max()
    else:
        g = _groups(x, groupsize)
        m = g.abs().amax(dim=-1, keepdim=True).expand(g.shape).reshape(
            x.shape)
    s = (2 ** (bits - 1) - 1) / (m + 1e-6)
    return torch.round(x * s) / (s + 1e-6)


def sym_fake_quant_ref3d(x: torch.Tensor, bits: int,
                         groupsize: int = 128) -> torch.Tensor:
    """The reference SymQuantizer's 3-D branch, bug included
    (utils_quant.py:56-66): on ``[B, T, H]`` it slices the sequence axis
    with the feature axis's group count, so tokens
    ``t < min((H // groupsize) * groupsize, T)`` get a per-token row max
    and later tokens a max of 0 (near-identity). For checkpoints trained
    by the reference."""
    if x.dim() != 3:
        raise ValueError("the reference branch this reproduces is 3-D only")
    _, t, h = x.shape
    covered = min((h // groupsize) * groupsize, t)
    rowmax = x.abs().amax(dim=-1, keepdim=True)                # [B, T, 1]
    mask = (torch.arange(t, device=x.device) < covered)[None, :, None]
    m = torch.where(mask, rowmax, torch.zeros_like(rowmax))
    s = (2 ** (bits - 1) - 1) / (m + 1e-6)
    return torch.round(x * s) / (s + 1e-6)


def asym_fake_quant(x: torch.Tensor, bits: int, groupsize: int = 8,
                    layerwise: bool = False) -> torch.Tensor:
    """AsymQuantizer.forward (utils_quant.py:105-187): groupwise min-max
    asymmetric fake-quant, groups of 8 along the last axis, eps 1e-8."""
    if layerwise:
        lo = x.min()
        return _qat_affine_qdq(x, x.max() - lo, lo, 2 ** bits - 1, 1e-8)
    g = _groups(x, groupsize)
    return _qat_affine_qdq(g, *_minmax(g), 2 ** bits - 1, 1e-8).reshape(
        x.shape)


def sym_fake_quant_ste(x: torch.Tensor, bits: int, groupsize: int = 128,
                       layerwise: bool = False,
                       clip: float = 2.0) -> torch.Tensor:
    """:func:`sym_fake_quant` with the clipped straight-through backward
    (utils_quant.py:92-102)."""
    return _ClipSTE.apply(x, partial(sym_fake_quant, bits=bits,
                                     groupsize=groupsize,
                                     layerwise=layerwise), clip)


def asym_fake_quant_ste(x: torch.Tensor, bits: int, groupsize: int = 8,
                        layerwise: bool = False,
                        clip: float = 2.0) -> torch.Tensor:
    """:func:`asym_fake_quant` with the clipped straight-through backward."""
    return _ClipSTE.apply(x, partial(asym_fake_quant, bits=bits,
                                     groupsize=groupsize,
                                     layerwise=layerwise), clip)


# ---------------------------------------------------------------------------
# Scheme variants carried by the reference
# ---------------------------------------------------------------------------


def mx1_fake_quant_qat(w: torch.Tensor, ratio_2b: float = 0.6,
                       group: int = 32, bits_lo: int = 2, bits_hi: int = 4,
                       eps: float = 1e-8) -> torch.Tensor:
    """MX1AsymQuantizer.forward (utils_quant.py:477-598): the front
    ``ratio_2b`` of the columns, run on to a whole group of 32, in 2-bit
    groups; the tail at per-row 4 bits."""
    o, k = w.shape
    target = int(k * ratio_2b)
    split = min(-(-target // group) * group, k)
    front = w[:, :split].reshape(o, -1, group)
    lo = _qat_affine_qdq(front, *_minmax(front), 2 ** bits_lo - 1, eps)
    tail = w[:, split:]
    hi = _qat_affine_qdq(tail, *_minmax(tail), 2 ** bits_hi - 1, eps)
    return torch.cat([lo.reshape(o, split), hi], dim=-1)


def binary_fake_quant(w: torch.Tensor, groupsize: int = 8,
                      layerwise: bool = False) -> torch.Tensor:
    """1-bit weight fake-quant (utils_quant.py:649-685): per group of 8
    columns, mean |w| times the sign (the caller adds the STE)."""
    if layerwise:
        s = w.abs().mean()
        return s * torch.sign(w / s)
    g = _groups(w, groupsize)
    s = g.abs().mean(dim=-1, keepdim=True)
    return (s * torch.sign(g / s)).reshape(w.shape)
