"""Uniform 4-bit and 2-bit weight-only formats (the AWQ-style baselines):
packers, reference dequants, and ``y = x @ dequant(p)`` through kernels
K7 (4-bit) and K8 (2-bit), one template in ``csrc/uniform_gemv.cu``.

Port of ``mxq_tpu/ops/uniform4.py``; the packers produce JAX's eager
arrays bit for bit. Layout (transposed storage, N on the fast axis):

  KP = K padded to a multiple of KT = 1024 (one k-tile)
  w  : int32 [KP/8, N]   (4-bit) word r of k-tile t holds the codes of
                         columns t*1024 + j*128 + r, code j at bits 4j:
                         slab j is quant group t*8 + j
       int32 [KP/16, N]  (2-bit) columns t*1024 + j*64 + r at bits 2j:
                         slab j is half of group t*8 + j//2
  s  : bf16 [KP/128, N]  per-group scale
  z  : bf16 [KP/128, N]  per-group integer zero code

The function every path computes is ``bf16(x) @ unpack_dequant(p)`` with
f32 accumulation, cast back to x's dtype. The engine uses the 4-bit format
for a packed lm_head (``EngineConfig.lm_head_bits=4``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from mxq_tpu_torch import scheme
from mxq_tpu_torch.ops import count_launch

GROUP = 128            # quant group along K
KT = 1024              # input columns per k-tile
N_LANE = 1024          # out-feature padding


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass
class _PackedUniform:
    w: torch.Tensor        # int32 [KP * BITS / 32, N]
    s: torch.Tensor        # bf16  [KP/128, N]
    z: torch.Tensor        # bf16  [KP/128, N]
    in_features: int
    out_features: int

    BITS = 0

    @property
    def per_word(self) -> int:
        return 32 // self.BITS

    @property
    def kp(self) -> int:
        return self.w.shape[0] * self.per_word

    @property
    def n_padded(self) -> int:
        return self.w.shape[1]

    @property
    def device(self) -> torch.device:
        return self.w.device

    def to(self, device):
        return type(self)(self.w.to(device), self.s.to(device),
                          self.z.to(device), self.in_features,
                          self.out_features)


class PackedU4Linear(_PackedUniform):
    """One packed uniform-4b linear: y = x @ dequant(self)."""
    BITS = 4


class PackedU2Linear(_PackedUniform):
    """One packed uniform-2b linear: y = x @ dequant(self)."""
    BITS = 2


def _quantize_pack(w: torch.Tensor, cls):
    """Quantize a [O, K] weight into ``cls``'s packed format."""
    bits = cls.BITS
    maxq = (1 << bits) - 1
    per = 32 // bits
    o, k = w.shape
    w = w.to(torch.float32)
    kp = _cdiv(k, KT) * KT
    n = _cdiv(o, N_LANE) * N_LANE
    wp = F.pad(w, (0, kp - k, 0, n - o))                  # [N, KP]
    gv = wp.reshape(n, kp // GROUP, GROUP)
    s, z = scheme.asym_find_params(gv, maxq)              # [N, KP/128]
    zc = torch.clamp(torch.round(z), 0, maxq)
    s_b = s.to(torch.bfloat16)
    codes = scheme.asym_quantize(gv, s_b.float()[..., None], zc[..., None],
                                 maxq, 1e-9).reshape(n, kp)
    # word r of tile t <- columns t*1024 + j*(1024/per) + r, code j at bits
    # j*bits; built in int64 and wrapped into int32 (the top code makes the
    # word negative)
    c = codes.T.reshape(kp // KT, per, KT // per, n).to(torch.int64)
    shifts = (torch.arange(per, dtype=torch.int64, device=w.device)
              * bits)[None, :, None, None]
    words = torch.sum(c << shifts, dim=1).reshape(kp // per, n)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return cls(w=words.to(torch.int32).contiguous(),
               s=s_b.T.reshape(kp // GROUP, n).contiguous(),
               z=zc.to(torch.bfloat16).T.reshape(kp // GROUP, n).contiguous(),
               in_features=k, out_features=o)


def quantize_pack_u4(w: torch.Tensor) -> PackedU4Linear:
    """Quantize a [O, K] weight into the packed uniform-4b format."""
    return _quantize_pack(w, PackedU4Linear)


def quantize_pack_u2(w: torch.Tensor) -> PackedU2Linear:
    """Quantize a [O, K] weight into the packed uniform-2b format."""
    return _quantize_pack(w, PackedU2Linear)


def unpack_dequant(p: _PackedUniform) -> torch.Tensor:
    """Reference dequant of either width -> [K, O] f32 (the normative
    semantics; ``unpack_dequant_u4`` and ``_u2`` in ``mxq_tpu``)."""
    bits, per = p.BITS, p.per_word
    kp, n = p.kp, p.n_padded
    wv = p.w.reshape(kp // KT, 1, KT // per, n)
    shifts = (torch.arange(per, dtype=torch.int32, device=p.device)
              * bits)[None, :, None, None]
    c = ((wv >> shifts) & ((1 << bits) - 1)).float()     # [t, j, r, N]
    # slab j of a tile lies in group j // rep of the tile
    rep = per // (KT // GROUP)
    s = p.s.float().reshape(kp // KT, KT // GROUP, 1, n)
    z = p.z.float().reshape(kp // KT, KT // GROUP, 1, n)
    s = torch.repeat_interleave(s, rep, dim=1)
    z = torch.repeat_interleave(z, rep, dim=1)
    wk = (s * (c - z)).reshape(kp, n)                     # row t*1024+j*slab+r
    return wk[: p.in_features, : p.out_features]


def fake_quant_u4(w: torch.Tensor) -> torch.Tensor:
    """Uniform-4b quant-dequant of a [O, K] weight (returns [O, K])."""
    return unpack_dequant(quantize_pack_u4(w)).T


def fake_quant_u2(w: torch.Tensor) -> torch.Tensor:
    """Uniform-2b quant-dequant of a [O, K] weight (returns [O, K])."""
    return unpack_dequant(quantize_pack_u2(w)).T


# ---------------------------------------------------------------------------
# plain version and kernel wrappers
# ---------------------------------------------------------------------------


def uniform_matmul_plain(x: torch.Tensor, p: _PackedUniform) -> torch.Tensor:
    """Plain version of K7 and K8: bf16(x) [B, K] @ dequant(p) -> f32 [B, O]."""
    return x.to(torch.bfloat16).float() @ unpack_dequant(p)


def _tile(b: int) -> int:
    """The kernel's tile id for ``b`` batch rows (csrc/uniform_gemv.cu
    by_tile): codes-major blocks of 8 or 32 rows up to 64 rows (the weight
    read once, or twice from L2 above 32), then 128-row group-major tiles
    (the weight re-read b/128 times)."""
    return 0 if b <= 8 else 1 if b <= 64 else 2


@functools.cache
def _tiles() -> tuple[tuple[int, int], ...]:
    """(batch rows, columns) of each tile id, as the built kernel
    instantiates them. One block per SM fits (shared memory)."""
    from mxq_tpu_torch import _build
    buf = (ctypes.c_int * 16)()
    n = _build.load("uniform_gemv").uniform_gemv_tiles(buf, 8)
    return tuple((buf[2 * i], buf[2 * i + 1]) for i in range(n))


def _split_tiles(n_kt: int, n_padded: int, b: int, sms: int,
                 tiles) -> int:
    """k-tiles per K split: enough splits that the blocks of the tile
    that ``b`` picks from ``tiles`` (``_tiles()``) fill every SM."""
    bm, bn = tiles[_tile(b)]
    blocks = (n_padded // bn) * _cdiv(b, bm)
    want = _cdiv(sms, blocks)
    return _cdiv(n_kt, max(1, min(n_kt, want)))


def _check_uniform(p: _PackedUniform, dev: torch.device) -> None:
    rows = {"w": p.w.shape[0], "s": p.w.shape[0] * p.per_word // GROUP,
            "z": p.w.shape[0] * p.per_word // GROUP}
    want = {"w": torch.int32, "s": torch.bfloat16, "z": torch.bfloat16}
    n = p.w.shape[1]
    for f, dt in want.items():
        t = getattr(p, f)
        if t.device != dev or t.dtype != dt or not t.is_contiguous() \
                or tuple(t.shape) != (rows[f], n):
            raise ValueError(f"packed field {f}: {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}, contiguous={t.is_contiguous()}"
                             f"; want {dt} {(rows[f], n)} contiguous on {dev}")
    if p.kp % KT or n % N_LANE:
        raise ValueError(f"packed shape {(p.kp, n)} is not padded to the "
                         "format")


def _uniform_cuda(x: torch.Tensor, p: _PackedUniform) -> torch.Tensor:
    from mxq_tpu_torch import _build
    if x.dim() != 2 or x.shape[1] != p.in_features:
        raise ValueError(f"x must be [B, {p.in_features}], got "
                         f"{tuple(x.shape)}")
    _check_uniform(p, x.device)
    xb = x.to(torch.bfloat16)
    b, k = xb.shape
    if k % 8:     # the kernel copies x in 16-byte rows of 8 columns
        xb = F.pad(xb, (0, 8 - k % 8))
    xb = xb.contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()
    n = p.n_padded
    n_kt = p.kp // KT
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    per_split = _split_tiles(n_kt, n, b, sms, _tiles())
    ksplit = _cdiv(n_kt, per_split)
    y = torch.empty((b, p.out_features), dtype=torch.float32,
                    device=x.device)
    # one split writes y directly; more go through partial sums
    part = (torch.empty((ksplit, b, n), dtype=torch.float32, device=x.device)
            if ksplit > 1 else y)
    err = _build.load("uniform_gemv").uniform_gemv(
        p.BITS, _tile(b), xb.data_ptr(), b, xb.shape[1], p.w.data_ptr(),
        p.s.data_ptr(), p.z.data_ptr(), n_kt, n, p.out_features, per_split,
        ksplit, part.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"uniform_gemv (u{p.BITS})")
    return y


def u4_gemv(x: torch.Tensor, p: PackedU4Linear) -> torch.Tensor:
    """K7: bf16(x) [B, K] @ dequant(p) -> f32 [B, O], any B >= 1."""
    if x.device.type == "cpu":
        return uniform_matmul_plain(x, p)
    y = _uniform_cuda(x, p)
    count_launch(u4_gemv)
    return y


def u2_gemv(x: torch.Tensor, p: PackedU2Linear) -> torch.Tensor:
    """K8: bf16(x) [B, K] @ dequant(p) -> f32 [B, O], any B >= 1."""
    if x.device.type == "cpu":
        return uniform_matmul_plain(x, p)
    y = _uniform_cuda(x, p)
    count_launch(u2_gemv)
    return y


u4_gemv.launches = 0
u2_gemv.launches = 0
KERNELS = {"K7": u4_gemv, "K8": u2_gemv}


def _matmul(gemv, x: torch.Tensor, p: _PackedUniform) -> torch.Tensor:
    lead = x.shape[:-1]
    y = gemv(x.reshape(-1, x.shape[-1]), p)
    return y.to(x.dtype).reshape(lead + (p.out_features,))


def u4_matmul(x: torch.Tensor, p: PackedU4Linear) -> torch.Tensor:
    """y = x @ dequant(p): ``x`` [..., K] any float dtype, rounded to bf16;
    returns [..., O] in x.dtype (K7)."""
    return _matmul(u4_gemv, x, p)


def u2_matmul(x: torch.Tensor, p: PackedU2Linear) -> torch.Tensor:
    """y = x @ dequant(p) for the uniform-2b format (K8)."""
    return _matmul(u2_gemv, x, p)
