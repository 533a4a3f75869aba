"""The MXQ packed storage format, its packer and its reference dequant —
a port of ``mxq_tpu/packfmt.py`` that produces the same arrays bit for bit.

Layout (per linear; logical weight [O, K] stored as planes over [K-ish, N=O],
N padded to a multiple of ``N_LANE``, the block count NB = K/64 padded to
NBP, a multiple of ``NB_TILE``):

  w2    : int32 [NBP*3, N]  word (t, g) of k-tile t = the 16 codes of 2-bit
                            group g (g in [0, 48)), code j at bits 2j
  w4    : int32 [NBP*2, N]  8 x 4-bit codes per word, code j at bits 4j
  meta2 : int32 [NBP, N]    word (t, r): zero code of group 16i+r at bits 2i
                            and its 8-bit scale code at bits 6+8i, i < 3
  qscale: bf16  [NBP, N]    second-order scale of word (t, r)'s three groups
  qmin  : bf16  [NBP, N]    second-order min: s = qscale*code + qmin
  smeta4: f32   [8, N]      row 0: per-channel 4-bit scale, row 1: its zero

A stacked linear carries a leading ``[L]`` axis on every tensor; layer ``i``
is the view :meth:`PackedMXQLinear.layer` returns.

Torch's ``>>`` on int32 is arithmetic, so every unpack masks after the
shift; packing builds each word in int64 and wraps it into int32, because
the code at bits 30-31 makes the word negative.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from mxq_tpu_torch import scheme
from mxq_tpu_torch.config import DEFAULT_SCHEME, MXQConfig

NB_TILE = 16          # blocks per k-tile (= 1024 input columns)
KT = NB_TILE * 64     # input columns per k-tile
QQ_GROUPS = 3         # second-order chunk = the 3 groups of one meta word
N_LANE = 1024         # out-feature padding granularity (part of the format)
SCALE_CODE_BITS = 8   # first-order scale codes
SCALE_CODE_MAX = 2**SCALE_CODE_BITS - 1

FIELDS = ("w2", "w4", "meta2", "qscale", "qmin", "smeta4")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass
class PackedMXQLinear:
    """One packed linear layer, y = x @ dequant(self), or a stack of them
    (every tensor with a leading [L] axis)."""

    w2: torch.Tensor      # int32 [(L,) NBP*3, N]
    w4: torch.Tensor      # int32 [(L,) NBP*2, N]
    meta2: torch.Tensor   # int32 [(L,) NBP, N]
    qscale: torch.Tensor  # bf16  [(L,) NBP, N]
    qmin: torch.Tensor    # bf16  [(L,) NBP, N]
    smeta4: torch.Tensor  # f32   [(L,) 8, N]
    in_features: int
    out_features: int

    @property
    def nbp(self) -> int:
        return self.meta2.shape[-2]

    @property
    def n_padded(self) -> int:
        return self.meta2.shape[-1]

    @property
    def stacked(self) -> bool:
        return self.meta2.dim() == 3

    def layer(self, idx: int) -> "PackedMXQLinear":
        """Layer ``idx`` of a stack, as views (no copy): the stacked
        weights are only a layer offset for the kernels."""
        return PackedMXQLinear(
            *(getattr(self, f)[idx] for f in FIELDS),
            in_features=self.in_features, out_features=self.out_features)

    def to(self, device) -> "PackedMXQLinear":
        return PackedMXQLinear(
            *(getattr(self, f).to(device) for f in FIELDS),
            in_features=self.in_features, out_features=self.out_features)

    @property
    def device(self) -> torch.device:
        return self.w2.device


def stack_packed(ps: list[PackedMXQLinear]) -> PackedMXQLinear:
    """[L] per-layer packs -> one stacked pack."""
    return PackedMXQLinear(
        *(torch.stack([getattr(p, f) for p in ps]) for f in FIELDS),
        in_features=ps[0].in_features, out_features=ps[0].out_features)


def _pack_along_sublanes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """[R*per_word, N] integer codes -> [R, N] int32, code j of word r at
    bits j*bits (built in int64, wrapped into int32)."""
    per_word = 32 // bits
    r = codes.shape[0] // per_word
    c = codes.to(torch.int64).reshape(r, per_word, -1)
    shifts = (torch.arange(per_word, dtype=torch.int64,
                           device=codes.device) * bits)[None, :, None]
    words = torch.sum(c << shifts, dim=1)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def _unpack_along_sublanes(words: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`_pack_along_sublanes`: [R, N] -> [R*per_word, N]."""
    per_word = 32 // bits
    mask = (1 << bits) - 1
    shifts = (torch.arange(per_word, dtype=torch.int32,
                           device=words.device) * bits)[None, :, None]
    c = (words[:, None, :] >> shifts) & mask
    return c.reshape(words.shape[0] * per_word, words.shape[1])


def quantize_pack(w: torch.Tensor,
                  cfg: MXQConfig = DEFAULT_SCHEME) -> PackedMXQLinear:
    """Quantize a [O, K] weight straight into the packed format: 48 columns
    of each 64-column block at 2 bits in groups of 16 with integer zero
    codes and 8-bit min-offset double-quantized scales, the other 16
    columns at 4 bits with one scale/zero per row. Runs on ``w``'s device."""
    o, k = w.shape
    dev = w.device
    w = w.to(torch.float32)
    w_lo, w_hi = scheme.split_blocks(w, cfg)          # [O, K2], [O, K4]

    nb = k // cfg.block
    nbp = _cdiv(nb, NB_TILE) * NB_TILE
    n = _cdiv(o, N_LANE) * N_LANE

    # ----- 2-bit plane: per-(row, group-of-16) params -----
    g2 = w_lo.shape[1] // cfg.group
    gv = w_lo.reshape(o, g2, cfg.group)
    s, z = scheme.asym_find_params(gv, cfg.maxq_lo)   # [O, G2]
    zc = torch.clamp(torch.round(z), 0, cfg.maxq_lo)

    # Second-order: the chunk of meta word (t, r) is the QQ_GROUPS groups
    # {16*i + r} of k-tile t; view groups as [n_kt, i, r], reduce over i.
    g2p = nbp * cfg.groups_per_block
    n_kt = nbp // NB_TILE
    s_pad = F.pad(s, (0, g2p - g2, 0, n - o))
    zc_pad = F.pad(zc, (0, g2p - g2, 0, n - o))
    sv = s_pad.reshape(n, n_kt, QQ_GROUPS, NB_TILE)   # [.., i, r]
    qq_min = sv.amin(dim=2)                           # [N, n_kt, 16]
    qq_rng = sv.amax(dim=2) - qq_min
    qq_scale = torch.where(qq_rng > 0,
                           scheme.div_const(qq_rng, SCALE_CODE_MAX),
                           torch.ones_like(qq_rng))
    s_codes = torch.clamp(
        torch.round((sv - qq_min[:, :, None, :]) / qq_scale[:, :, None, :]),
        0, SCALE_CODE_MAX)                            # [N, n_kt, 3, 16]
    # bf16 storage of the second-order params (the precision kernels see)
    qq_scale_b = qq_scale.to(torch.bfloat16)
    qq_min_b = qq_min.to(torch.bfloat16)
    s_eff = (qq_scale_b.float()[:, :, None, :] * s_codes
             + qq_min_b.float()[:, :, None, :]).reshape(n, g2p)

    # 2-bit codes quantized against the effective (double-quantized) scale
    gv_pad = F.pad(gv, (0, 0, 0, g2p - g2, 0, n - o))
    codes2 = scheme.asym_quantize(gv_pad, s_eff[..., None],
                                  zc_pad[..., None], cfg.maxq_lo,
                                  cfg.ptq_eps)
    codes2 = codes2.reshape(n, g2p * cfg.group)       # [N, K2P]

    # ----- 4-bit plane: per-row params over the gathered columns -----
    s4, z4 = scheme.asym_find_params(w_hi, cfg.maxq_hi)  # [O]
    z4c = torch.clamp(torch.round(z4), 0, cfg.maxq_hi)
    codes4 = scheme.asym_quantize(w_hi, s4[:, None], z4c[:, None],
                                  cfg.maxq_hi, cfg.ptq_eps)
    k4p = nbp * cfg.num_4b
    codes4 = F.pad(codes4, (0, k4p - codes4.shape[1], 0, n - o))
    s4 = F.pad(s4, (0, n - o))
    z4c = F.pad(z4c, (0, n - o))

    # ----- bit-pack (transpose to [K-ish, N]) -----
    w2 = _pack_along_sublanes(codes2.T, cfg.bits_lo)
    w4 = _pack_along_sublanes(codes4.T, cfg.bits_hi)

    # meta word (t, r): field i holds the codes of group 16i + r
    zv = zc_pad.reshape(n, n_kt, QQ_GROUPS, NB_TILE).to(torch.int32)
    sc_i = s_codes.to(torch.int32)
    meta = torch.zeros((n, n_kt, NB_TILE), dtype=torch.int32, device=dev)
    for i in range(QQ_GROUPS):
        meta = (meta | (zv[:, :, i, :] << (2 * i))
                | (sc_i[:, :, i, :] << (6 + SCALE_CODE_BITS * i)))

    def rows(a):  # [N, n_kt, 16] -> [NBP, N]
        return a.permute(1, 2, 0).reshape(nbp, n).contiguous()

    smeta4 = torch.zeros((8, n), dtype=torch.float32, device=dev)
    smeta4[0] = s4
    smeta4[1] = z4c
    return PackedMXQLinear(w2=w2.contiguous(), w4=w4.contiguous(),
                           meta2=rows(meta), qscale=rows(qq_scale_b),
                           qmin=rows(qq_min_b), smeta4=smeta4,
                           in_features=k, out_features=o)


def group_params(p: PackedMXQLinear, cfg: MXQConfig = DEFAULT_SCHEME):
    """2-bit group scales and zero codes, f32 ``[NBP*3, N]`` each, row
    ``t*48 + g`` = group g of k-tile t (the row order of ``w2``)."""
    nbp, n = p.meta2.shape
    n_kt = nbp // NB_TILE
    mv = p.meta2.reshape(n_kt, 1, NB_TILE, n)
    fields = torch.arange(cfg.groups_per_block, dtype=torch.int32,
                          device=p.meta2.device)[None, :, None, None]
    zc = (mv >> (fields * 2)) & 0x3
    sc = (mv >> (6 + fields * SCALE_CODE_BITS)) & SCALE_CODE_MAX
    qq_scale = p.qscale.float().reshape(n_kt, 1, NB_TILE, n)
    qq_min = p.qmin.float().reshape(n_kt, 1, NB_TILE, n)
    s_eff = qq_scale * sc.float() + qq_min          # [n_kt, i, r, N]
    g2p = nbp * cfg.groups_per_block
    return s_eff.reshape(g2p, n), zc.float().reshape(g2p, n)


def unpack_dequant(p: PackedMXQLinear,
                   cfg: MXQConfig = DEFAULT_SCHEME) -> torch.Tensor:
    """Reference dequant -> [K, O] f32 (transposed for x @ W): the normative
    semantics every kernel reproduces."""
    codes2 = _unpack_along_sublanes(p.w2, cfg.bits_lo).float()
    codes4 = _unpack_along_sublanes(p.w4, cfg.bits_hi).float()
    s_eff, zc = group_params(p, cfg)
    w2 = (torch.repeat_interleave(s_eff, cfg.group, dim=0)
          * (codes2 - torch.repeat_interleave(zc, cfg.group, dim=0)))
    s4 = p.smeta4[0]
    z4 = p.smeta4[1]
    w4 = s4[None, :] * (codes4 - z4[None, :])
    wk = scheme.merge_blocks(w2.T, w4.T, cfg)         # [N, NBP*64]
    return wk[: p.out_features, : p.in_features].T    # [K, O]


def fake_quant_packed(w: torch.Tensor,
                      cfg: MXQConfig = DEFAULT_SCHEME) -> torch.Tensor:
    """Packed-format quant-dequant of a [O, K] weight (returns [O, K])."""
    return unpack_dequant(quantize_pack(w, cfg), cfg).T


def pad_inputs_split(x: torch.Tensor, p: PackedMXQLinear,
                     cfg: MXQConfig = DEFAULT_SCHEME):
    """Split activations [..., K] into the padded 2-bit and 4-bit planes
    (x2 [..., K2P], x4 [..., K4P]) matching the packed weight layout."""
    k = p.in_features
    nbp = p.nbp
    lead = x.shape[:-1]
    xp = F.pad(x, (0, nbp * cfg.block - k))
    xb = xp.reshape(lead + (nbp, cfg.block))
    x2 = xb[..., : cfg.num_2b].reshape(lead + (nbp * cfg.num_2b,))
    x4 = xb[..., cfg.num_2b:].reshape(lead + (nbp * cfg.num_4b,))
    return x2, x4
