"""MXQ numerical primitives (port of ``mxq_tpu/scheme.py``): the PTQ
formulation, with the packer's primitives, double quantization,
``mxq_quantize_ptq``/``mxq_dequantize``, the ratio, outlier and sub-2-bit
variants; and the QAT fake-quant forward with its straight-through
estimators.

Weight orientation matches the reference: ``w`` is ``[out, in]`` = ``[O, K]``.
``torch.round`` rounds half to even, as ``jnp.round`` does. Every
division by a constant goes through :func:`div_const` (or, for a constant
over a tensor, a 0-dim tensor numerator), so that the card divides as the
CPU and JAX do.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from mxq_tpu_torch.config import DEFAULT_SCHEME, MXQConfig


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded as IEEE division on every device: PyTorch turns a
    CUDA tensor's division by a Python scalar into a multiply by its
    reciprocal, which can land one ulp away."""
    return x / x.new_full((), c)


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
    scale = div_const(xmax - xmin, maxq)
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
    q = div_const(torch.round((x - beta) / a * levels), levels)
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


def _sym_scale(m: torch.Tensor, bits: int) -> torch.Tensor:
    """``(2^(b-1)-1) / (m + 1e-6)`` as an IEEE division: a Python number
    over a tensor is ``reciprocal() * number`` in PyTorch, on every
    device."""
    return m.new_full((), 2 ** (bits - 1) - 1) / (m + 1e-6)


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
    s = _sym_scale(m, bits)
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
    s = _sym_scale(m, bits)
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


# ---------------------------------------------------------------------------
# PTQ fake-quant (Quantizer + MXQGPT.fasterquant semantics, scale/zero form)
# ---------------------------------------------------------------------------


class DoubleQuantResult(NamedTuple):
    scale_dq: torch.Tensor   # dequantized scales, the input's shape
    codes: torch.Tensor      # per-scale integer codes in [0, maxq_qq]
    qq_scale: torch.Tensor   # second-order scale, one per qq group
    qq_zero: torch.Tensor    # second-order zero (rounded if round_zero)


def double_quant_scales(scale: torch.Tensor, qq_bits: int, qq_group: int,
                        round_zero: bool = False,
                        eps: float = 1e-9) -> DoubleQuantResult:
    """Double quantization of first-order scales (quantizer.py:114-121) in
    groups of ``qq_group`` along the last axis. ``round_zero`` rounds the
    second-order zero to an integer code (the packable variant)."""
    maxq = 2 ** qq_bits - 1
    sg = scale.reshape(scale.shape[:-1]
                       + (scale.shape[-1] // qq_group, qq_group))
    qq_scale, qq_zero = asym_find_params(sg, maxq)
    if round_zero:
        qq_zero = torch.clamp(torch.round(qq_zero), 0, maxq)
    qs, qz = qq_scale[..., None], qq_zero[..., None]
    codes = asym_quantize(sg, qs, qz, maxq, eps)
    return DoubleQuantResult((qs * (codes - qz)).reshape(scale.shape),
                             codes.reshape(scale.shape), qq_scale, qq_zero)


class MXQQuantized(NamedTuple):
    """Integer codes and quantization parameters of one [O, K] weight, the
    logical (unpacked) PTQ representation. ``*_codes`` hold small
    non-negative integers (int8); the zeros are floats, or int8 codes
    under ``round_zero``."""
    lo_codes: torch.Tensor        # [O, K2]  in [0, maxq_lo]
    hi_codes: torch.Tensor        # [O, K4]  in [0, maxq_hi]
    lo_zero: torch.Tensor         # [O, G2]
    lo_scale_codes: torch.Tensor  # [O, G2]  in [0, maxq_qq]
    lo_qq_scale: torch.Tensor     # [G2, O // qq_group]
    lo_qq_zero: torch.Tensor      # [G2, O // qq_group]
    hi_zero: torch.Tensor         # [O]
    hi_scale_codes: torch.Tensor  # [O]      in [0, maxq_qq]
    hi_qq_scale: torch.Tensor     # [O // qq_group]
    hi_qq_zero: torch.Tensor      # [O // qq_group]


def mxq_quantize_ptq(w: torch.Tensor, cfg: MXQConfig = DEFAULT_SCHEME,
                     round_zero: bool = False) -> MXQQuantized:
    """Quantize a weight to MXQ codes with PTQ semantics (mxqgpt.py:387-448):
    the 2-bit plane per (row, 16-column group), its scales double-quantized
    over 16 consecutive rows; the gathered 4-bit columns with one pair per
    row, its scales likewise. ``round_zero=False`` is the reference PTQ (fp
    zeros), ``True`` the packable variant with integer zero codes."""
    o, _ = w.shape
    w = w.float()
    w_lo, w_hi = split_blocks(w, cfg)
    g2 = w_lo.shape[1] // cfg.group

    g = w_lo.reshape(o, g2, cfg.group)
    scale, zero = asym_find_params(g, cfg.maxq_lo)          # [O, G2]
    dq = double_quant_scales(scale.T.reshape(g2, o), cfg.qq_scale_bits,
                             cfg.qq_group, round_zero, cfg.ptq_eps)
    lo_scale_dq = dq.scale_dq.reshape(g2, o).T
    lo_scale_codes = dq.codes.reshape(g2, o).T
    if round_zero:
        zero = torch.clamp(torch.round(zero), 0, cfg.maxq_lo)
    lo_codes = asym_quantize(g, lo_scale_dq[..., None], zero[..., None],
                             cfg.maxq_lo, cfg.ptq_eps).reshape(o, -1)

    scale4, zero4 = asym_find_params(w_hi, cfg.maxq_hi)     # [O]
    dq4 = double_quant_scales(scale4, cfg.qq_scale_bits, cfg.qq_group,
                              round_zero, cfg.ptq_eps)
    if round_zero:
        zero4 = torch.clamp(torch.round(zero4), 0, cfg.maxq_hi)
    hi_codes = asym_quantize(w_hi, dq4.scale_dq[:, None], zero4[:, None],
                             cfg.maxq_hi, cfg.ptq_eps)

    def zeros(z):
        return z.to(torch.int8) if round_zero else z

    i8 = torch.int8
    return MXQQuantized(
        lo_codes=lo_codes.to(i8), hi_codes=hi_codes.to(i8),
        lo_zero=zeros(zero), lo_scale_codes=lo_scale_codes.to(i8),
        lo_qq_scale=dq.qq_scale, lo_qq_zero=zeros(dq.qq_zero),
        hi_zero=zeros(zero4), hi_scale_codes=dq4.codes.to(i8),
        hi_qq_scale=dq4.qq_scale, hi_qq_zero=zeros(dq4.qq_zero))


def mxq_dequantize(qw: MXQQuantized,
                   cfg: MXQConfig = DEFAULT_SCHEME) -> torch.Tensor:
    """The dequantized [O, K] f32 weight of MXQ codes."""
    o = qw.lo_codes.shape[0]
    g2 = qw.lo_zero.shape[1]
    codes_t = qw.lo_scale_codes.float().T.reshape(g2, o // cfg.qq_group,
                                                  cfg.qq_group)
    scale = qw.lo_qq_scale.float()[..., None] * (
        codes_t - qw.lo_qq_zero.float()[..., None])
    scale = scale.reshape(g2, o).T                          # [O, G2]
    lo = scale[..., None] * (qw.lo_codes.float().reshape(o, g2, cfg.group)
                             - qw.lo_zero.float()[..., None])
    c4 = qw.hi_scale_codes.float().reshape(-1, cfg.qq_group)
    scale4 = (qw.hi_qq_scale.float()[:, None]
              * (c4 - qw.hi_qq_zero.float()[:, None])).reshape(o)
    hi = scale4[:, None] * (qw.hi_codes.float() - qw.hi_zero.float()[:, None])
    return merge_blocks(lo.reshape(o, -1), hi, cfg)


def mxq_fake_quant_ptq(w: torch.Tensor, cfg: MXQConfig = DEFAULT_SCHEME,
                       round_zero: bool = False) -> torch.Tensor:
    """PTQ quant-dequant of a weight, what ``fasterquant`` applies to every
    linear: ``mxq_dequantize(mxq_quantize_ptq(w))``."""
    return mxq_dequantize(mxq_quantize_ptq(w, cfg, round_zero), cfg)


def mxq_fake_quant_ptq_ratio(w: torch.Tensor, ratio_2b_num: int,
                             ratio_2b_den: int, blocksize: int = 16,
                             cfg: MXQConfig = DEFAULT_SCHEME) -> torch.Tensor:
    """Block-interleaved PTQ quant-dequant at any 2-bit ratio (the
    reference's ``SparseGPT.fasterprune``, sparsegpt.py:1993-2110): the
    2-bit part of each 64-column block in sub-blocks of ``blocksize``
    columns (a ragged last one allowed), the rest per row at 4 bits."""
    o, k = w.shape
    w = w.float()
    num_2b = int(cfg.block * ratio_2b_num / ratio_2b_den)
    wb = w.reshape(o, k // cfg.block, cfg.block)
    lo, hi = wb[:, :, :num_2b], wb[:, :, num_2b:]

    pieces = []
    for start in range(0, num_2b, blocksize):
        seg = lo[:, :, start:min(start + blocksize, num_2b)]
        s, z = asym_find_params(seg, cfg.maxq_lo)
        sdq = double_quant_scales(
            s.T.reshape(-1, o), cfg.qq_scale_bits, cfg.qq_group,
            eps=cfg.ptq_eps).scale_dq.reshape(s.T.shape).T
        pieces.append(asym_qdq(seg, sdq[..., None], z[..., None],
                               cfg.maxq_lo, cfg.ptq_eps))

    hi_flat = hi.reshape(o, -1)
    s4, z4 = asym_find_params(hi_flat, cfg.maxq_hi)
    s4dq = double_quant_scales(s4, cfg.qq_scale_bits, cfg.qq_group,
                               eps=cfg.ptq_eps).scale_dq
    hi_dq = asym_qdq(hi_flat, s4dq[:, None], z4[:, None], cfg.maxq_hi,
                     cfg.ptq_eps).reshape(hi.shape)
    return torch.cat(pieces + [hi_dq], dim=-1).reshape(o, k)


def _rowmean_sign_qdq(x: torch.Tensor) -> torch.Tensor:
    """The PTQ Quantizer's 1-bit path (quantizer.py:102-105,157-163):
    +mean|x| over the last axis where x >= 0, else -mean|x|."""
    s = x.abs().mean(dim=-1, keepdim=True)
    return torch.where(x >= 0, s, -s)


def leave_one_out_error(wb: torch.Tensor, hdiag: torch.Tensor,
                        bits: int) -> torch.Tensor:
    """SpQR-style leave-one-out error reduction (mxqgpt.py:454-491).
    ``wb`` [..., bs] groups, ``hdiag`` [..., bs] the matching diagonal of
    the upper Cholesky factor of H^-1. Per element: the Hessian-weighted
    squared error of its group quantized without it, subtracted from the
    whole group's. Returns [..., bs]."""
    bs = wb.shape[-1]
    maxq = 2 ** bits - 1
    idx = torch.arange(bs, device=wb.device)
    # row j: every index but j, in order (:459-461)
    loo = idx[None, 1:] - (idx[:, None] >= idx[None, 1:]).long()
    gw = wb[..., loo]                                   # [..., bs, bs-1]
    s, z = asym_find_params(gw, maxq)
    rec = asym_qdq(gw, s[..., None], z[..., None], maxq)
    loo_err = (((rec - gw) / hdiag[..., loo]) ** 2).sum(-1)

    s0, z0 = asym_find_params(wb, maxq)
    rec0 = asym_qdq(wb, s0[..., None], z0[..., None], maxq)
    base_err = (((rec0 - wb) / hdiag) ** 2).sum(-1, keepdim=True)
    return base_err - loo_err


def damped_hinv_chol(h: torch.Tensor, percdamp: float):
    """The Hessian preparation of the OBS/GPTQ family (sparsegpt.py:54-101):
    dead inputs (``diag(h) == 0``) get a unit diagonal, ``percdamp`` of the
    mean diagonal is added, and H^-1 is factored as an upper Cholesky
    factor (both in float64, the factor returned in h's dtype). Returns
    ``(dead [K] bool, hinv_chol [K, K])``; the caller zeroes the weight of
    the dead inputs."""
    k = h.shape[0]
    dead = torch.diagonal(h) == 0
    h = h + torch.diag(dead.to(h.dtype))
    damp = percdamp * torch.diagonal(h).mean()
    h = h + damp * torch.eye(k, dtype=h.dtype, device=h.device)
    # the inverse and its factor in float64: at K = 4096 and a condition
    # number near 3e5 (llama2_7b's second o_proj input over 8 x 2048
    # calibration tokens, random weights) the f32 factor of the f32
    # inverse fails, where mxq_tpu's f32 jnp.linalg.cholesky returns NaNs
    hinv = torch.linalg.inv(h.double())
    return dead, torch.linalg.cholesky(hinv, upper=True).to(h.dtype)


def mxq_outlier_quantize(w: torch.Tensor, h: torch.Tensor | None = None,
                         bits: int = 1, blocksize: int = 16,
                         percdamp: float = 0.01,
                         ol_threshold: float = 1.1,
                         count_threshold: int = 4,
                         outlier_rel_threshold: float = 0.6):
    """Outlier-aware quantization, the reference's ``MXQGPT1.fasterquant``
    (mxqgpt.py:155-254): quantize at ``bits`` and keep an outlier mask in
    full precision.

    ``bits == 1``: per ``blocksize``-column block, rows with more than
    ``count_threshold`` entries beyond ``ol_threshold`` times the block's
    mean |w| keep the whole row-block; the rest is mean-scale sign
    quantized. ``bits >= 2`` (needs ``h``): leave-one-out error reduction
    against ``outlier_rel_threshold * mean(var(W, axis=0) / diag^2)``
    picks likely outliers, the quantizer is fit with them replaced by the
    block's other mean, and the mask re-checks the weighted residual.

    Returns ``(w_qdq [O, K], outlier_mask [O, K] bool)``."""
    o, k = w.shape
    w = w.float()
    hdiag = None
    if h is not None:
        dead, hinv_chol = damped_hinv_chol(h, percdamp)
        w = torch.where(dead[None, :], 0.0, w)
        hdiag = torch.diagonal(hinv_chol)

    nb = k // blocksize
    wb = w.reshape(o, nb, blocksize)
    if bits == 1:
        wmean = div_const(wb.abs().sum(dim=-1, keepdim=True), blocksize)
        likely = (wb > ol_threshold * wmean) | (wb < -ol_threshold * wmean)
        rows = likely.sum(dim=-1, keepdim=True) > count_threshold
        mask = rows.expand(wb.shape)
        out = torch.where(mask, wb, _rowmean_sign_qdq(wb))
        return out.reshape(o, k), mask.reshape(o, k)

    if hdiag is None:
        raise ValueError("bits >= 2 outlier quantization needs the Hessian")
    # the threshold comes from the whole weight (mxqgpt.py:155-157);
    # torch.var, like the reference, is unbiased
    threshold = outlier_rel_threshold * (
        torch.var(w, dim=0, correction=1) / hdiag ** 2).mean()
    hd_b = hdiag.reshape(1, nb, blocksize)
    likely = leave_one_out_error(wb, hd_b, bits) > threshold
    non = ~likely
    mean_non = ((wb * non).sum(dim=-1, keepdim=True)
                / non.sum(dim=-1, keepdim=True).clamp_min(1))
    maxq = 2 ** bits - 1
    s, z = asym_find_params(torch.where(likely, mean_non, wb), maxq)
    wq = asym_qdq(wb, s[..., None], z[..., None], maxq)
    mask = ((wb - wq) / hd_b) ** 2 > threshold
    return torch.where(mask, wb, wq).reshape(o, k), mask.reshape(o, k)


def sub2bit_fake_quant(w: torch.Tensor, w_bits: int,
                       layerwise: bool = False) -> torch.Tensor:
    """Sub-2-bit symmetric path (utils_quant.py:689-711): scale 2*mean|w|
    per row, 2^(bits-1) levels, half-step offset rounding under a
    +-(1 - 1e-2) clip."""
    levels = 2 ** (w_bits - 1)
    clip = 1 - 1e-2
    s = 2 * (w.abs().mean() if layerwise
             else w.abs().mean(dim=1, keepdim=True))
    q = div_const(torch.round(torch.clamp(w / s, -clip, clip) * levels - 0.5)
                  + 0.5, levels)
    return s * q
