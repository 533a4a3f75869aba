"""y = x @ dequant(p) for packed MXQ linears: dispatch, plain PyTorch
versions, and the wrappers of kernels K1, K2, K3, K5 and K6 (``csrc/``).

Port of ``mxq_tpu/ops/mxq_matmul.py``. The function every path computes is
``bf16(x) @ unpack_dequant(p)`` with f32 accumulation:

* decode and prefill under 512 rows, B >= 2 -> K1 (:func:`gemv_batched`,
  ``csrc/mxq_gemv_tc.cu``: tensor cores, tiles picked by :func:`_k1_tile`)
* decode, B == 1 row   -> K2 (:func:`gemv_single`, ``csrc/mxq_gemv.cu``:
  4 columns a lane, warps splitting K, splits sized by :func:`_split_rows`)
* the GEMV layouts ``quad`` and ``bfexp`` (``MXQ_GEMV_LAYOUT``, read at
  import into :data:`GEMV_LAYOUT`; ``MXQ_GEMV_LAYOUT_B1`` for one row,
  read per call; :func:`gemv_layout`) -> K6 (:func:`gemv_quad`,
  :func:`gemv_bfexp`; K1's template at B >= 2; at one row quad is K2's
  kernel and bfexp its own tensor-core kernel beside it) at any row
  count. ``quad`` computes K1's function; ``bfexp`` a lossy one
  whose weights are rounded to bf16 in two steps
  (:func:`gemv_bfexp_plain`);
* prefill, >= 512 rows -> K3 (:func:`dequant_planes`, ``csrc/mxq_dequant.cu``)
  unpacks to bf16 planes, then two ``torch.matmul`` GEMMs (as the TPU left
  them to XLA); the 512-row switch lives in ``models/llama.quant_linear``;
* prefill with int8 activations (``prefill_act_bits=8``) -> K5
  (:func:`dequant_int8_planes`, same source) finds each out-channel's int8
  bound and requantizes the weight against it in x's padded order, then
  one int8 GEMM (``torch._int_mm``) and one rescale
  (:func:`mxq_matmul_prefill_a8`).

Every wrapper runs its plain version for CPU tensors only; for CUDA tensors
it launches its kernel or raises. ``<wrapper>.launches`` counts launches.
A stacked [L, ...] weight is only a layer offset (:meth:`PackedMXQLinear.layer`).
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F

from mxq_tpu_torch import packfmt, scheme
from mxq_tpu_torch.config import DEFAULT_SCHEME, MXQConfig
from mxq_tpu_torch.packfmt import PackedMXQLinear
from mxq_tpu_torch.ops import count_launch

# layout ids of csrc/mxq_gemv_tc.cu
_TC_LAYOUT = {"slab": 0, "quad": 1, "bfexp": 2}

# The GEMV layout of more than one row, as mxq_tpu reads it: once, at
# import. "slab" is K1; "quad" and "bfexp" are K6's two unpack bodies;
# "bdg" (the B=1 kernel) stands for "slab" at more than one row.
GEMV_LAYOUT = os.environ.get("MXQ_GEMV_LAYOUT", "slab")
LAYOUTS = ("slab", "quad", "bfexp", "bdg")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def gemv_plain(x: torch.Tensor, p: PackedMXQLinear,
               cfg: MXQConfig = DEFAULT_SCHEME) -> torch.Tensor:
    """Plain version of K1 and K2: bf16(x) [B, K] @ dequant(p) -> f32 [B, O]."""
    xb = x.to(torch.bfloat16).float()
    return xb @ packfmt.unpack_dequant(p, cfg)


def gemv_bfexp_plain(x: torch.Tensor, p: PackedMXQLinear,
                     cfg: MXQConfig = DEFAULT_SCHEME) -> torch.Tensor:
    """Plain version of K6's ``bfexp`` layout (``_kernel_body_bfexp``,
    mxq_matmul.py:252-317): bf16(x) [B, K] @ W -> f32 [B, O], where every
    weight is rounded to bf16 twice. Per 2-bit group, with ``s`` as in
    K1, ``s4 = bf16(4s)`` and ``b = bf16(4s + s*z)``; code c becomes
    ``1 + c/4`` (exact in bf16) and ``w = bf16(bf16(s4 * (1 + c/4)) - b)``.
    The 4-bit plane does the same per channel with ``bf16(16*s4)``,
    ``bf16(16*s4 + s4*z4)`` and ``1 + c/16``, so there is no separate
    4-bit epilogue. Both products are exact in f32 (an 8-bit by a 3- or
    5-bit significand) and both differences too (the operands are within a
    factor of two), so each ``bf16(...)`` of :func:`bfexp_weights_plain`
    is one rounding, as in K6's bf16x2 multiply and subtract: the weights
    are bit-equal, and the products x*w are exact in f32 and summed in
    f32."""
    w2, w4 = bfexp_weights_plain(p, cfg)
    x2, x4 = packfmt.pad_inputs_split(x.to(torch.bfloat16).float(), p, cfg)
    y = x2 @ w2 + x4 @ w4
    return y[:, : p.out_features]


def bfexp_weights_plain(p: PackedMXQLinear, cfg: MXQConfig = DEFAULT_SCHEME):
    """The weights of :func:`gemv_bfexp_plain`, bf16 values in f32: the
    2-bit plane ``[NBP*48, N]`` and the 4-bit plane ``[NBP*16, N]`` in
    natural plane order (row ``word*16 + j`` of the 2-bit plane holds code
    j of ``w2`` row ``word``; ``word*8 + j`` of the 4-bit one, of ``w4``),
    the rows of :func:`packfmt.pad_inputs_split`'s x2 and x4."""
    def bf(t):
        return t.to(torch.bfloat16).float()

    s_eff, zc = packfmt.group_params(p, cfg)               # [NBP*3, N]
    s4x = s_eff * 4.0
    s4b = torch.repeat_interleave(bf(s4x), cfg.group, dim=0)
    b2 = torch.repeat_interleave(bf(s4x + s_eff * zc), cfg.group, dim=0)
    pb2 = 1.0 + packfmt._unpack_along_sublanes(p.w2, cfg.bits_lo).float() / 4
    w2 = bf(bf(s4b * pb2) - b2)
    s16 = p.smeta4[0:1] * 16.0
    b4 = bf(s16 + p.smeta4[0:1] * p.smeta4[1:2])
    pb4 = 1.0 + packfmt._unpack_along_sublanes(p.w4, cfg.bits_hi).float() / 16
    w4 = bf(bf(bf(s16) * pb4) - b4)
    return w2, w4


def dequant_planes_plain(p: PackedMXQLinear,
                         cfg: MXQConfig = DEFAULT_SCHEME):
    """Plain version of K3: the bf16 planes ``wd2 [NBP*48, N]`` and
    ``wd4 [NBP*16, N]`` in natural plane order (row ``word*16 + j`` holds
    code j of ``w2`` row ``word``), each value ``s*c - s*z`` rounded once
    to bf16."""
    s_eff, zc = packfmt.group_params(p, cfg)
    neg_sz = s_eff * zc
    codes2 = packfmt._unpack_along_sublanes(p.w2, cfg.bits_lo).float()
    wd2 = (torch.repeat_interleave(s_eff, cfg.group, dim=0) * codes2
           - torch.repeat_interleave(neg_sz, cfg.group, dim=0))
    codes4 = packfmt._unpack_along_sublanes(p.w4, cfg.bits_hi).float()
    s4 = p.smeta4[0:1]
    sz4 = s4 * p.smeta4[1:2]
    wd4 = s4 * codes4 - sz4
    return wd2.to(torch.bfloat16), wd4.to(torch.bfloat16)


def int8_weight_scale(p: PackedMXQLinear) -> torch.Tensor:
    """Per-out-channel int8 scale bound [1, N] f32 from the metadata alone:
    max over the channel's groups of |s| * max(z, maxc - z), / 127 (port of
    ``_int8_weight_scale``, mxq_matmul.py:836). The division is IEEE on
    every device (``scheme.div_const``)."""
    qs = p.qscale.float()
    qm = p.qmin.float()
    m = None
    for i in range(3):
        zc = ((p.meta2 >> (2 * i)) & 0x3).float()
        sc = ((p.meta2 >> (6 + packfmt.SCALE_CODE_BITS * i))
              & packfmt.SCALE_CODE_MAX).float()
        s = qs * sc + qm
        b = s.abs() * torch.maximum(zc, 3.0 - zc)
        m = b if m is None else torch.maximum(m, b)
    m = m.amax(dim=0)                                   # [N]
    s4 = p.smeta4[0].float()
    z4 = p.smeta4[1].float()
    m = torch.maximum(m, s4.abs() * torch.maximum(z4, 15.0 - z4))
    return torch.clamp_min(scheme.div_const(m, 127.0), 1e-12)[None, :]


def dequant_int8_planes_plain(p: PackedMXQLinear,
                              cfg: MXQConfig = DEFAULT_SCHEME):
    """Plain version of K5: ``(sw, q)``. ``sw`` [1, N] f32 is
    :func:`int8_weight_scale`; ``q`` [N, NBP*64] int8 holds each weight
    ``(s*c - s*z) * (1 / sw[n])`` rounded half to even (the TPU kernel's
    order of operations, mxq_matmul.py:858-875), row n in x's padded order
    (``pad_inputs_split``): block b's 48 2-bit codes (``w2`` words 3b..3b+2,
    16 codes each), then its 16 4-bit codes (``w4`` rows 2b, 2b+1), so that
    ``q.t()`` is the column-major operand of one int8 GEMM against the
    padded x."""
    sw = int8_weight_scale(p)
    inv = 1.0 / sw
    s_eff, zc = packfmt.group_params(p, cfg)
    neg_sz = s_eff * zc
    codes2 = packfmt._unpack_along_sublanes(p.w2, cfg.bits_lo).float()
    w2 = (torch.repeat_interleave(s_eff, cfg.group, dim=0) * codes2
          - torch.repeat_interleave(neg_sz, cfg.group, dim=0)) * inv
    codes4 = packfmt._unpack_along_sublanes(p.w4, cfg.bits_hi).float()
    s4 = p.smeta4[0:1]
    sz4 = s4 * p.smeta4[1:2]
    w4 = (s4 * codes4 - sz4) * inv
    nbp, n = p.meta2.shape
    q = torch.cat([torch.round(w2).to(torch.int8).reshape(nbp, cfg.num_2b, n),
                   torch.round(w4).to(torch.int8).reshape(nbp, cfg.num_4b, n)],
                  dim=1)
    return sw, q.reshape(nbp * cfg.block, n).T.contiguous()


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_packed(p: PackedMXQLinear, dev: torch.device) -> None:
    if p.stacked:
        raise ValueError("pass one layer of a stacked pack (p.layer(i))")
    want = {"w2": torch.int32, "w4": torch.int32, "meta2": torch.int32,
            "qscale": torch.bfloat16, "qmin": torch.bfloat16,
            "smeta4": torch.float32}
    nbp, n = p.meta2.shape
    rows = {"w2": nbp * 3, "w4": nbp * 2, "meta2": nbp, "qscale": nbp,
            "qmin": nbp, "smeta4": 8}
    for f, dt in want.items():
        t = getattr(p, f)
        if t.device != dev or t.dtype != dt or not t.is_contiguous() \
                or tuple(t.shape) != (rows[f], n):
            raise ValueError(f"packed field {f}: {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}, contiguous={t.is_contiguous()}"
                             f"; want {dt} {(rows[f], n)} contiguous on {dev}")
    if nbp % packfmt.NB_TILE or n % packfmt.N_LANE:
        raise ValueError(f"packed shape {(nbp, n)} is not padded to the format")


@functools.cache
def _row_tiles() -> tuple[tuple[int, int, int], ...]:
    """(columns per block, warps per block that split its meta rows,
    blocks per SM) of the one-row kernels of ``csrc/mxq_gemv.cu``, as the
    built library reports them, blocks per SM by the card's occupancy
    rules: K2/K6-quad's ``gemv_row_kernel``, then K6-bfexp's
    ``bfexp_row_kernel``."""
    from mxq_tpu_torch import _build
    buf = (ctypes.c_int * 6)()
    n = _build.load("mxq_gemv").mxq_gemv_tiles(buf, 2)
    tiles = tuple(tuple(buf[3 * i: 3 * i + 3]) for i in range(n))
    if any(t[2] < 1 for t in tiles):
        raise RuntimeError(f"mxq_gemv: a kernel does not fit an SM: {tiles}")
    return tiles


def _split_rows(nbp: int, n_padded: int, sms: int, tile) -> int:
    """Meta rows (64 input columns each) per K split of a one-row kernel
    with geometry ``tile`` (a row of :func:`_row_tiles`): the fewest splits
    whose blocks fill every SM with the tile's blocks per SM, and of those
    the shortest split (splits of equal length). A split never straddles a
    k-tile (a divisor of 16 rows or a multiple of 16) and gives each warp
    that splits a block's rows at least one row; when no split fills the
    card, the shortest such split."""
    cols, warps, per_sm = tile
    blocks = n_padded // cols
    cands = [c for c in [1, 2, 4, 8] + list(range(16, nbp + 1, 16))
             if c >= warps]
    fits = [c for c in cands if blocks * -(-nbp // c) >= per_sm * sms]
    if not fits:
        return min(cands)
    fewest = min(-(-nbp // c) for c in fits)
    return min(c for c in fits if -(-nbp // c) == fewest)


def _gemv_cuda(fn_name: str, x: torch.Tensor,
               p: PackedMXQLinear) -> torch.Tensor:
    """Launch a one-row kernel of ``csrc/mxq_gemv.cu``: the kernel, then
    the fixed-order sum of its K splits."""
    from mxq_tpu_torch import _build
    if x.dim() != 2 or x.shape != (1, p.in_features):
        raise ValueError(f"x must be [1, {p.in_features}], got "
                         f"{tuple(x.shape)}")
    _check_packed(p, x.device)
    xb = x.to(torch.bfloat16).contiguous()
    b, k = xb.shape
    nbp, n = p.meta2.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile = _row_tiles()[1 if fn_name == "mxq_gemv_k6_bfexp1" else 0]
    rows = _split_rows(nbp, n, sms, tile)
    ksplit = -(-nbp // rows)
    part = torch.empty((ksplit, b, n), dtype=torch.float32, device=x.device)
    y = torch.empty((b, p.out_features), dtype=torch.float32,
                    device=x.device)
    fn = getattr(_build.load("mxq_gemv"), fn_name)
    err = fn(xb.data_ptr(), b, k, k, p.w2.data_ptr(), p.w4.data_ptr(),
             p.meta2.data_ptr(), p.qscale.data_ptr(), p.qmin.data_ptr(),
             p.smeta4.data_ptr(), nbp, n, p.out_features, rows, ksplit,
             part.data_ptr(), y.data_ptr(),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, fn_name)
    return y


def _k1_tile(b: int) -> int:
    """The tensor-core template's tile id for ``b`` batch rows
    (csrc/mxq_gemv_tc.cu by_tile): codes-major blocks of 8 or 32 rows up
    to 64 rows (the weight read once, or twice from L2 above 32), then
    128-row group-major tiles (the weight re-read b/128 times)."""
    return 0 if b <= 8 else 1 if b <= 64 else 2


@functools.cache
def _k1_tiles() -> tuple[tuple[int, int, int], ...]:
    """(batch rows, columns, blocks per SM) of each tile id, as the built
    kernel instantiates them and the card's occupancy rules place them."""
    from mxq_tpu_torch import _build
    buf = (ctypes.c_int * 24)()
    n = _build.load("mxq_gemv_tc").mxq_gemv_tc_tiles(buf, 8)
    tiles = tuple(tuple(buf[3 * i: 3 * i + 3]) for i in range(n))
    if any(t[2] < 1 for t in tiles):
        raise RuntimeError(f"mxq_gemv_tc: a tile does not fit an SM: {tiles}")
    return tiles


def _k1_split_tiles(n_kt: int, n_padded: int, b: int, sms: int,
                    tiles) -> int:
    """k-tiles per K split for the tile that ``b`` picks from ``tiles``
    (``_k1_tiles()``): the one that finishes first when the blocks run in
    waves of ``sms`` times the tile's blocks per SM and a block costs its
    k-tiles plus one k-tile's worth of pipeline fill; of equal costs, the
    fewest splits."""
    bm, bn, per_sm = tiles[_k1_tile(b)]
    blocks = (n_padded // bn) * -(-b // bm)
    slots = sms * per_sm

    def cost(p):
        waves = -(-blocks * -(-n_kt // p) // slots)
        return waves * (p + 1), -p

    return min(range(1, n_kt + 1), key=cost)


def _gemv_tc(layout: str, x: torch.Tensor,
             p: PackedMXQLinear) -> torch.Tensor:
    """Launch K1 (``layout`` "slab") or K6 ("quad", "bfexp") on the tensor
    cores: a first pass writes bf16(x) in the MMA's slot order, then the
    tile's mainloop, then (with a K split) the fixed-order sum of the
    splits."""
    from mxq_tpu_torch import _build
    if x.dim() != 2 or x.shape[1] != p.in_features:
        raise ValueError(f"x must be [B, {p.in_features}], got "
                         f"{tuple(x.shape)}")
    _check_packed(p, x.device)
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    x = x.contiguous()
    b, k = x.shape
    nbp, n = p.meta2.shape
    n_kt = nbp // packfmt.NB_TILE
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    per_split = _k1_split_tiles(n_kt, n, b, sms, _k1_tiles())
    ksplit = -(-n_kt // per_split)
    xp = torch.empty((b, nbp * 64), dtype=torch.bfloat16, device=x.device)
    y = torch.empty((b, p.out_features), dtype=torch.float32,
                    device=x.device)
    # one split writes y directly; more go through partial sums
    part = (torch.empty((ksplit, b, n), dtype=torch.float32, device=x.device)
            if ksplit > 1 else y)
    err = _build.load("mxq_gemv_tc").mxq_gemv_tc(
        _TC_LAYOUT[layout], _k1_tile(b), x.data_ptr(),
        int(x.dtype == torch.float32), b, k, k, p.w2.data_ptr(),
        p.w4.data_ptr(), p.meta2.data_ptr(), p.qscale.data_ptr(),
        p.qmin.data_ptr(), p.smeta4.data_ptr(), nbp, n, p.out_features,
        per_split, ksplit, xp.data_ptr(), part.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"mxq_gemv_tc ({layout})")
    return y


def gemv_quad(x: torch.Tensor, p: PackedMXQLinear,
              cfg: MXQConfig = DEFAULT_SCHEME) -> torch.Tensor:
    """K6, layout ``quad``: K1's function by byte-quad code extraction,
    bf16(x) [B, K] @ dequant(p) -> f32 [B, O] at any B; its MMA operands
    and sums equal K1's (at B=1 K2's), so the outputs are equal bit for
    bit."""
    if x.device.type == "cpu":
        return gemv_plain(x, p, cfg)
    y = (_gemv_cuda("mxq_gemv_k6_quad1", x, p) if x.shape[0] == 1
         else _gemv_tc("quad", x, p))
    count_launch(gemv_quad)
    return y


def gemv_bfexp(x: torch.Tensor, p: PackedMXQLinear,
               cfg: MXQConfig = DEFAULT_SCHEME) -> torch.Tensor:
    """K6, layout ``bfexp``: bf16(x) [B, K] @ the bf16 weights of
    :func:`gemv_bfexp_plain` -> f32 [B, O] at any B."""
    if x.device.type == "cpu":
        return gemv_bfexp_plain(x, p, cfg)
    y = (_gemv_cuda("mxq_gemv_k6_bfexp1", x, p) if x.shape[0] == 1
         else _gemv_tc("bfexp", x, p))
    count_launch(gemv_bfexp)
    return y


def gemv_batched(x: torch.Tensor, p: PackedMXQLinear,
                 cfg: MXQConfig = DEFAULT_SCHEME) -> torch.Tensor:
    """K1: bf16(x) [B, K] @ dequant(p) -> f32 [B, O] for B >= 2 (the
    tensor-core template takes B = 1 too)."""
    if x.device.type == "cpu":
        return gemv_plain(x, p, cfg)
    y = _gemv_tc("slab", x, p)
    count_launch(gemv_batched)
    return y


def gemv_single(x: torch.Tensor, p: PackedMXQLinear,
                cfg: MXQConfig = DEFAULT_SCHEME) -> torch.Tensor:
    """K2: bf16(x) [1, K] @ dequant(p) -> f32 [1, O]."""
    if x.device.type == "cpu":
        return gemv_plain(x, p, cfg)
    if x.shape[0] != 1:
        raise ValueError(f"K2 takes one row, got {x.shape[0]}")
    y = _gemv_cuda("mxq_gemv_k2", x, p)
    count_launch(gemv_single)
    return y


def dequant_planes(p: PackedMXQLinear, cfg: MXQConfig = DEFAULT_SCHEME):
    """K3: the bf16 planes of :func:`dequant_planes_plain`."""
    dev = p.device
    if dev.type == "cpu":
        return dequant_planes_plain(p, cfg)
    from mxq_tpu_torch import _build
    _check_packed(p, dev)
    nbp, n = p.meta2.shape
    wd2 = torch.empty((nbp * 48, n), dtype=torch.bfloat16, device=dev)
    wd4 = torch.empty((nbp * 16, n), dtype=torch.bfloat16, device=dev)
    err = _build.load("mxq_dequant").mxq_dequant_k3(
        p.w2.data_ptr(), p.w4.data_ptr(), p.meta2.data_ptr(),
        p.qscale.data_ptr(), p.qmin.data_ptr(), p.smeta4.data_ptr(), nbp, n,
        wd2.data_ptr(), wd4.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mxq_dequant_k3")
    count_launch(dequant_planes)
    return wd2, wd4


def dequant_int8_planes(p: PackedMXQLinear, cfg: MXQConfig = DEFAULT_SCHEME):
    """K5: ``(sw, q)`` of :func:`dequant_int8_planes_plain`, one call (the
    bound's kernel, then the codes' kernel)."""
    dev = p.device
    if dev.type == "cpu":
        return dequant_int8_planes_plain(p, cfg)
    from mxq_tpu_torch import _build
    _check_packed(p, dev)
    nbp, n = p.meta2.shape
    sw = torch.empty((1, n), dtype=torch.float32, device=dev)
    q = torch.empty((n, nbp * 64), dtype=torch.int8, device=dev)
    err = _build.load("mxq_dequant").mxq_dequant_k5(
        p.w2.data_ptr(), p.w4.data_ptr(), p.meta2.data_ptr(),
        p.qscale.data_ptr(), p.qmin.data_ptr(), p.smeta4.data_ptr(), nbp, n,
        sw.data_ptr(), q.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mxq_dequant_k5")
    count_launch(dequant_int8_planes)
    return sw, q


gemv_batched.launches = 0
gemv_single.launches = 0
gemv_quad.launches = 0
gemv_bfexp.launches = 0
dequant_planes.launches = 0
dequant_int8_planes.launches = 0
KERNELS = {"K1": gemv_batched, "K2": gemv_single, "K3": dequant_planes,
           "K5": dequant_int8_planes, "K6-quad": gemv_quad,
           "K6-bfexp": gemv_bfexp}


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def gemv_layout(rows: int, layout: str | None = None) -> str:
    """The layout a GEMV of ``rows`` rows runs, by ``mxq_matmul``'s rules
    (mxq_matmul.py:653-664): unless named, one row takes
    ``MXQ_GEMV_LAYOUT_B1`` (default "bdg"), more rows :data:`GEMV_LAYOUT`;
    "bdg" at more than one row takes :data:`GEMV_LAYOUT`, or "slab" where
    that is "bdg" too. An unknown name raises."""
    if layout is None:
        layout = (os.environ.get("MXQ_GEMV_LAYOUT_B1", "bdg") if rows == 1
                  else GEMV_LAYOUT)
    if layout == "bdg" and rows != 1:
        layout = GEMV_LAYOUT if GEMV_LAYOUT != "bdg" else "slab"
    if layout not in LAYOUTS:
        raise ValueError(f"unknown GEMV layout {layout!r}; choose {LAYOUTS}")
    return layout


def mxq_matmul(x: torch.Tensor, p: PackedMXQLinear,
               cfg: MXQConfig = DEFAULT_SCHEME,
               layout: str | None = None) -> torch.Tensor:
    """y = x @ dequant(p) (decode regime). ``x`` [..., K] any float dtype,
    rounded to bf16; returns [..., O] in x.dtype. The layout
    (:func:`gemv_layout`) picks the kernel: "quad" and "bfexp" go to K6;
    "bdg", and "slab" at one row, to K2; "slab" at more rows to K1."""
    lead = x.shape[:-1]
    xb = x.reshape(-1, x.shape[-1])
    layout = gemv_layout(xb.shape[0], layout)
    if layout == "quad":
        y = gemv_quad(xb, p, cfg)
    elif layout == "bfexp":
        y = gemv_bfexp(xb, p, cfg)
    elif xb.shape[0] == 1:
        y = gemv_single(xb, p, cfg)
    else:
        y = gemv_batched(xb, p, cfg)
    return y.to(x.dtype).reshape(lead + (p.out_features,))


def mxq_matmul_stacked(x: torch.Tensor, p: PackedMXQLinear, layer_idx: int,
                       cfg: MXQConfig = DEFAULT_SCHEME,
                       layout: str | None = None) -> torch.Tensor:
    """y = x @ dequant(p[layer_idx]) for a stacked [L, ...] pack."""
    return mxq_matmul(x, p.layer(layer_idx), cfg, layout)


def mxq_matmul_prefill(x: torch.Tensor, p: PackedMXQLinear,
                       layer_idx: int | None = None,
                       cfg: MXQConfig = DEFAULT_SCHEME) -> torch.Tensor:
    """y = x @ dequant(p) for the GEMM regime: K3 unpacks the planes to
    bf16, then ``bf16(x2) @ wd2 + bf16(x4) @ wd4`` in bf16 (the TPU's two
    XLA GEMMs and their bf16 rounding). ``p`` may be stacked with
    ``layer_idx``."""
    if layer_idx is not None:
        p = p.layer(layer_idx)
    lead = x.shape[:-1]
    xb = x.reshape(-1, x.shape[-1])
    x2, x4 = packfmt.pad_inputs_split(xb, p, cfg)
    wd2, wd4 = dequant_planes(p, cfg)
    y = (x2.to(torch.bfloat16) @ wd2) + (x4.to(torch.bfloat16) @ wd4)
    return y[:, : p.out_features].to(x.dtype).reshape(
        lead + (p.out_features,))


def _act_quant_rows(xb: torch.Tensor):
    """Per-token symmetric int8 scale: xb [T, K] f32 -> (scale [T, 1],
    1 / scale). max|x| is taken as max(max x, -min x), one read of x."""
    lo, hi = torch.aminmax(xb, dim=-1, keepdim=True)
    sx = scheme.div_const(torch.clamp_min(torch.maximum(hi, -lo), 1e-12),
                          127.0)
    return sx, 1.0 / sx


def mxq_matmul_prefill_a8(x: torch.Tensor, p: PackedMXQLinear,
                          layer_idx: int | None = None,
                          cfg: MXQConfig = DEFAULT_SCHEME) -> torch.Tensor:
    """y = x @ dequant(p) with int8 activations and weights (W~4A8): K5
    gives the per-out-channel bound ``sw`` of :func:`int8_weight_scale` and
    the weight requantized against it in x's padded order, the activations
    are quantized once per token, one int8 GEMM (``torch._int_mm``, exact
    int32 sums; the TPU left its two to XLA) gives ``acc``, and
    ``y = acc * sx * sw``. Port of ``mxq_matmul_prefill_a8``
    (mxq_matmul.py:924): the int32 sums are exact, so ``acc`` equals its
    two planes' sum. ``x`` [..., K] with more than 16 rows: the card's
    int8 GEMM takes M > 16, K and N multiples of 8 (the packed weight
    always is) and a column-major second operand."""
    if layer_idx is not None:
        p = p.layer(layer_idx)
    lead = x.shape[:-1]
    xb = x.reshape(-1, x.shape[-1]).float()
    sw, q = dequant_int8_planes(p, cfg)                 # [1, N], [N, NBP*64]
    sx, inv_sx = _act_quant_rows(xb)
    pad = q.shape[1] - xb.shape[1]
    xp = F.pad(xb, (0, pad)) if pad else xb
    xq = torch.clamp(torch.round(xp * inv_sx), -127, 127).to(torch.int8)
    acc = torch._int_mm(xq, q.t())
    y = acc * sx * sw               # acc rounded to f32 first, as .float()
    return y[:, : p.out_features].to(x.dtype).reshape(
        lead + (p.out_features,))
