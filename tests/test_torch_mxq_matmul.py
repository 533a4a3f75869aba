"""mxq_tpu_torch.ops.mxq_matmul (the plain versions the kernel wrappers run
on CPU tensors) against mxq_tpu.ops.mxq_matmul run as its own tests run it
(Pallas in interpret mode on the CPU). Tolerance: rel <= 1e-4 of max|y|
for the f32 decode paths; the prefill path rounds its two GEMM results to
bf16 as the JAX one does, so it is held to the same 1e-4 on the pair of
bf16 GEMMs plus one bf16 ulp per element where the two libraries' f32
sums round to different sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxq_tpu import packfmt as jpf
from mxq_tpu.ops import mxq_matmul as jmm
from mxq_tpu_torch import packfmt as tpf
from mxq_tpu_torch.ops import mxq_matmul as tmm
from torch_port_helpers import bits, port_params, rel, to_torch

O, K = 320, 1088        # ragged N (pads to 1024) and K (pads to 2 k-tiles)


@pytest.fixture(scope="module")
def packed():
    w = np.random.default_rng(0).standard_normal((O, K)).astype(np.float32)
    pj = jpf.quantize_pack(jnp.asarray(w))
    return pj, port_params({"p": pj})["p"]


@pytest.mark.parametrize("b", [1, 8, 40])
def test_mxq_matmul_matches_jax(packed, b):
    pj, pt = packed
    x = np.random.default_rng(b).standard_normal((b, K)).astype(np.float32)
    yj = np.asarray(jmm.mxq_matmul(jnp.asarray(x), pj))
    yt = tmm.mxq_matmul(torch.from_numpy(x), pt)
    assert yt.shape == (b, O) and yt.dtype == torch.float32
    assert rel(yt, yj) <= 1e-4


def test_mxq_matmul_3d_and_dtype(packed):
    _, pt = packed
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 3, K)).astype(np.float32))
    y = tmm.mxq_matmul(x.to(torch.bfloat16), pt)
    assert y.shape == (2, 3, O) and y.dtype == torch.bfloat16
    ref = tmm.gemv_plain(x.reshape(6, K), pt).reshape(2, 3, O)
    assert rel(y, ref) <= 1e-2           # the output is rounded to bf16


def test_stacked_per_layer_matches_jax():
    l = 3
    rng = np.random.default_rng(7)
    ps = [jpf.quantize_pack(jnp.asarray(rng.standard_normal((O, K)).astype(
        np.float32))) for _ in range(l)]
    st = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ps)
    pt = port_params({"p": st})["p"]
    assert pt.stacked
    x = rng.standard_normal((4, K)).astype(np.float32)
    for li in range(l):
        yj = np.asarray(jmm.mxq_matmul_stacked(jnp.asarray(x), st,
                                               jnp.int32(li)))
        yt = tmm.mxq_matmul_stacked(torch.from_numpy(x), pt, li)
        assert rel(yt, yj) <= 1e-4, li


def test_prefill_matches_jax_at_512(packed):
    pj, pt = packed
    x = np.random.default_rng(11).standard_normal((512, K)).astype(
        np.float32)
    yj = np.asarray(jmm.mxq_matmul_prefill(jnp.asarray(x), pj))
    yt = tmm.mxq_matmul_prefill(torch.from_numpy(x), pt)
    assert yt.shape == (512, O)
    yj_t = to_torch(yj)
    assert rel(yt, yj_t) <= 1e-2
    # the two sides agree to f32 rounding before the bf16 output rounding
    ulp = yj_t.abs() * 2.0**-7
    assert bool(((yt - yj_t).abs() <= ulp + 1e-4 * yj_t.abs().max()).all())


def test_dequant_planes_plain_matches_tpu_kernel_bits(packed):
    """K3's plain version equals the TPU dequant kernel up to row order:
    the TPU writes slab order (row j*48 + g of a k-tile holds code j of
    group g), the port natural order (row g*16 + j). The 2-bit plane is
    bit-equal. In the 4-bit plane XLA's CPU backend fuses s4*c - s4*z4
    into one FMA, so where c == z4 it leaves the rounding error of s4*z4
    (under one f32 ulp of it) where the port, like K3 (built with
    --fmad=false), gives exactly 0; every other value is bit-equal."""
    pj, pt = packed
    nbp, n = pt.meta2.shape
    wd2j, wd4j = jmm._dequant_pallas(pj.w2, pj.w4, pj.meta2, pj.qscale,
                                     pj.qmin, pj.smeta4, block_n=1024,
                                     interpret=True)
    wd2t, wd4t = tmm.dequant_planes_plain(pt)
    n_kt = nbp // tpf.NB_TILE
    slab2 = wd2t.reshape(n_kt, 48, 16, n).transpose(1, 2).reshape(-1, n)
    slab4 = wd4t.reshape(n_kt, 32, 8, n).transpose(1, 2).reshape(-1, n)
    assert torch.equal(bits(slab2), bits(to_torch(wd2j)))
    wd4j = to_torch(wd4j)
    differ = bits(slab4) != bits(wd4j)
    assert bool((slab4[differ] == 0).all())
    sz4 = (pt.smeta4[0] * pt.smeta4[1]).abs().expand_as(wd4j)
    assert bool((wd4j[differ].float().abs() <= sz4[differ] * 2.0**-23).all())


def test_gemv_plain_is_the_reference_dequant(packed):
    _, pt = packed
    x = torch.randn((3, K), generator=torch.Generator().manual_seed(0))
    ref = x.to(torch.bfloat16).float() @ tpf.unpack_dequant(pt)
    assert torch.equal(tmm.gemv_plain(x, pt), ref)


def test_cpu_dispatch_never_counts_a_launch(packed):
    """On CPU tensors the wrappers run the plain versions; a launch count
    moves only where a kernel is launched."""
    _, pt = packed
    before = {k: f.launches for k, f in tmm.KERNELS.items()}
    tmm.mxq_matmul(torch.ones((1, K)), pt)
    tmm.mxq_matmul(torch.ones((4, K)), pt)
    tmm.mxq_matmul_prefill(torch.ones((512, K)), pt)
    tmm.mxq_matmul_prefill_a8(torch.ones((512, K)), pt)
    assert {k: f.launches for k, f in tmm.KERNELS.items()} == before


def test_wrappers_reject_bad_input(packed):
    _, pt = packed
    tmm._check_packed(pt, torch.device("cpu"))
    short = tpf.PackedMXQLinear(pt.w2[:-1], pt.w4, pt.meta2, pt.qscale,
                                pt.qmin, pt.smeta4, pt.in_features,
                                pt.out_features)
    with pytest.raises(ValueError):
        tmm._check_packed(short, torch.device("cpu"))
    stacked = tpf.stack_packed([pt, pt])
    with pytest.raises(ValueError):
        tmm._check_packed(stacked, torch.device("cpu"))


# (columns per block, warps per block that split its meta rows, blocks per
# SM) of the one-row kernels as csrc/mxq_gemv.cu builds them on the H100:
# K2/K6-quad's gemv_row_kernel, then K6-bfexp's bfexp_row_kernel
# (ops/mxq_matmul._row_tiles reads them from the library on the card; a
# cuda test holds them to this)
ROW_TILES = ((128, 8, 2), (32, 4, 9))
ROW_WARP_BYTES = 32 * (6 * 16 + 2 * 8)   # a warp's loads of one meta row


@pytest.mark.parametrize("nbp,n,want", [
    (64, 4096, 8),       # o_proj: 32 column blocks -> 8 splits of one row
                         # per warp, 256 blocks (no split of >= 8 fills 264)
    (64, 12288, 16),     # qkv: 96 column blocks -> 4 splits, 384 blocks
    (176, 4096, 16),     # down: 11 splits of a whole k-tile, 352 blocks
    (64, 33792, 64),     # 264 column blocks fill the card alone: 1 split
    (64, 22528, 32),     # gate_up: 2 equal splits (not 48 + 16 rows)
])
def test_split_rows(nbp, n, want):
    """K2/K6-quad's K split on a 132-SM H100: the fewest splits whose
    blocks fill two blocks of 8 warps on every SM, of equal length, one
    meta row or more per warp. At each 7B linear every SM then has >= 32
    KB of weight loads requested (a warp keeps one meta row's 3.5 KB in
    flight)."""
    cols, warps, per_sm = ROW_TILES[0]
    rows = tmm._split_rows(nbp, n, 132, ROW_TILES[0])
    assert rows == want and rows >= warps
    blocks = (n // cols) * -(-nbp // rows)
    resident = min(per_sm, blocks / 132) * min(warps, rows)
    assert resident * ROW_WARP_BYTES >= 32 * 1024


@pytest.mark.parametrize("nbp,n,want", [
    (64, 4096, 4), (64, 12288, 16), (176, 4096, 16), (64, 22528, 32)])
def test_split_rows_bfexp_loop(nbp, n, want):
    """K6-bfexp's one-row kernel (32 columns a block, 4 warps splitting its
    meta rows, nine blocks per SM) at the four 7B linears: the fewest
    splits whose blocks fill the 1188 slots, of equal length, one meta row
    or more per warp. o_proj's 128 column blocks take 16 splits of 4 rows
    (one per warp); qkv 4 of 16, down 11 of 16, gate_up 2 of 32."""
    cols, warps, per_sm = ROW_TILES[1]
    rows = tmm._split_rows(nbp, n, 132, ROW_TILES[1])
    assert rows == want and rows >= warps
    assert (n // cols) * -(-nbp // rows) >= per_sm * 132


# ---------------------------------------------------------------------------
# int8-activation prefill (K5 and mxq_matmul_prefill_a8)
# ---------------------------------------------------------------------------


def test_int8_weight_scale_equals_jax(packed):
    pj, pt = packed
    sw = tmm.int8_weight_scale(pt)
    assert sw.shape == (1, pt.n_padded) and sw.dtype == torch.float32
    want = jmm._int8_weight_scale(pj.meta2, pj.qscale, pj.qmin, pj.smeta4)
    assert torch.equal(sw, to_torch(want))
    # the bound covers every dequantized weight: requantizing never clips
    wmax = tpf.unpack_dequant(pt).abs().amax(dim=0)
    assert bool((wmax <= sw[0, :O] * 127.0 * 1.0001).all())


def test_dequant_int8_plain_matches_tpu_kernel(packed):
    """K5's plain version against the TPU kernel (interpret mode), up to
    row order (slab order there; x's padded order here, the planes
    interleaved per 64-input block). The 2-bit plane is equal. In the 4-bit
    plane XLA's CPU backend fuses (s4*c - s4*z4) * inv otherwise than the
    kernel's three roundings, so values within a few f32 ulps of a
    half-way point (all at 63.5 here) round to the other neighbour: 56 of
    524288 codes at seed 0, each off by one; every other code is equal."""
    pj, pt = packed
    nbp, n = pt.meta2.shape
    sw, q = tmm.dequant_int8_planes_plain(pt)
    inv = 1.0 / sw
    q2j, q4j = jmm._dequant_int8_pallas(
        pj.w2, pj.w4, pj.meta2, pj.qscale, pj.qmin, pj.smeta4,
        jnp.asarray(inv.numpy()), block_n=1024, interpret=True)
    assert q.dtype == torch.int8 and q.shape == (n, nbp * 64)
    assert q.is_contiguous()
    blocks = q.T.reshape(nbp, 64, n)
    q2t = blocks[:, :48].reshape(nbp * 48, n)       # natural plane order
    q4t = blocks[:, 48:].reshape(nbp * 16, n)
    n_kt = nbp // tpf.NB_TILE
    slab2 = q2t.reshape(n_kt, 48, 16, n).transpose(1, 2).reshape(-1, n)
    assert torch.equal(slab2, to_torch(q2j))
    s4 = pt.smeta4[0:1]
    raw4 = (s4 * tpf._unpack_along_sublanes(pt.w4, 4).float()
            - s4 * pt.smeta4[1:2]) * inv                # before rounding
    diff = (q4t.int() - to_torch(q4j).reshape(n_kt, 8, 32, n).transpose(
        1, 2).reshape(-1, n).int())
    ties = diff != 0
    assert int(diff.abs().max()) <= 1
    assert int(ties.sum()) <= 100, int(ties.sum())
    frac = raw4[ties] - raw4[ties].floor()
    assert bool(((frac - 0.5).abs() <= 8 * 2.0**-23 * raw4[ties].abs()).all())
    # the codes are the rounded dequantized weights, inside [-127, 127]
    wd2, _ = tmm.dequant_planes_plain(pt)
    assert int(q2t.abs().max()) <= 127 and int(q4t.abs().max()) <= 127
    assert rel(q2t.float() / inv, wd2.float()) <= 1e-2


def test_dequant_int8_plain_sw_equals_weight_scale(packed):
    """The plain K5's bound is int8_weight_scale's and JAX's
    _int8_weight_scale's, bit for bit; q's rows are that bound's codes of
    the weights of unpack_dequant, in x's padded order."""
    pj, pt = packed
    sw, q = tmm.dequant_int8_planes_plain(pt)
    assert sw.dtype == torch.float32 and sw.shape == (1, pt.n_padded)
    assert torch.equal(sw, tmm.int8_weight_scale(pt))
    want = jmm._int8_weight_scale(pj.meta2, pj.qscale, pj.qmin, pj.smeta4)
    assert torch.equal(sw, to_torch(want))
    w = tpf.unpack_dequant(pt)                          # [K, O]
    deq = (q[:O, :K].float() * sw[0, :O, None]).T
    assert float((deq - w).abs().max()) <= float(sw.max()) * 0.5 * 1.0001


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_prefill_a8_one_gemm_equals_two_gemms(seed):
    """The one int8 GEMM over x's padded order gives y equal bit for bit to
    the two-plane formula (x split by pad_inputs_split, each plane
    quantized, two int8 GEMMs and an int32 add) on the same codes: the
    int32 sums are exact in any order."""
    rng = np.random.default_rng(seed)
    p = tpf.quantize_pack(torch.from_numpy(
        rng.standard_normal((O, K)).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((512, K)).astype(np.float32))
    y = tmm.mxq_matmul_prefill_a8(x, p)
    nbp, n = p.meta2.shape
    sw, q = tmm.dequant_int8_planes_plain(p)
    blocks = q.T.reshape(nbp, 64, n)
    q2t = blocks[:, :48].reshape(nbp * 48, n).T.contiguous()
    q4t = blocks[:, 48:].reshape(nbp * 16, n).T.contiguous()
    sx, inv_sx = tmm._act_quant_rows(x)
    x2, x4 = tpf.pad_inputs_split(x, p)
    xq2 = torch.clamp(torch.round(x2 * inv_sx), -127, 127).to(torch.int8)
    xq4 = torch.clamp(torch.round(x4 * inv_sx), -127, 127).to(torch.int8)
    acc = torch._int_mm(xq2, q2t.t()) + torch._int_mm(xq4, q4t.t())
    want = (acc.float() * sx * sw)[:, :O]
    assert torch.equal(y, want)


def _byte_perm_lanes(x, y, s):
    """CUDA's __byte_perm lane by lane: x, y and the selector s are uint32
    arrays, byte k of the result is byte (s >> 4k) & 7 of {y, x}."""
    src = [(x >> (8 * b)) & 0xFF for b in range(4)] + \
          [(y >> (8 * b)) & 0xFF for b in range(4)]
    out = np.zeros_like(x)
    for k in range(4):
        sel = (s >> (4 * k)) & 7
        out = out | (np.choose(sel, src) << (8 * k))
    return out


def _k5_emulated(p):
    """numpy emulation of csrc/mxq_dequant.cu's K5: k5_scale_kernel's bound
    (16 warps over the meta rows, then one max), and k5_codes_kernel's
    codes as it makes them: each 2-bit group's four codes and each
    column's sixteen 4-bit codes computed once, the packed codes looked up
    by byte permutes, staged per column as 32-bit words at the block's
    offsets and read out as x's padded order. f32 arithmetic one rounding
    per operation, as --fmad=false compiles it."""
    f32, u32 = np.float32, np.uint32
    w2, w4, meta2 = (getattr(p, f).numpy().view(u32) for f in
                     ("w2", "w4", "meta2"))
    qs_all = p.qscale.float().numpy()
    qm_all = p.qmin.float().numpy()
    s4, z4 = p.smeta4[0].numpy(), p.smeta4[1].numpy()
    nbp, n = meta2.shape

    part = np.zeros((16, n), f32)
    for warp in range(16):
        for r in range(warp, nbp, 16):
            for i in range(3):
                zc = ((meta2[r] >> u32(2 * i)) & u32(3)).astype(f32)
                sc = ((meta2[r] >> u32(6 + 8 * i)) & u32(255)).astype(f32)
                s = qs_all[r] * sc + qm_all[r]
                part[warp] = np.fmax(part[warp],
                                     np.abs(s) * np.fmax(zc, f32(3) - zc))
    m = np.fmax(part.max(axis=0), np.abs(s4) * np.fmax(z4, f32(15) - z4))
    sw = np.fmax(m / f32(127), f32(1e-12))
    iv = f32(1) / sw

    def code_byte(v):
        return np.rint(v).astype(np.int64).astype(u32) & u32(0xFF)

    def pack4(a, b, c, d):
        return _byte_perm_lanes(_byte_perm_lanes(a, b, 0x0040),
                                _byte_perm_lanes(c, d, 0x0040), 0x5410)

    sz4 = s4 * z4
    t4 = [pack4(*(code_byte((s4 * f32(c + j) - sz4) * iv) for j in range(4)))
          for c in range(0, 16, 4)]
    tile = np.zeros((nbp // 16, n, 256), u32)
    for kt in range(nbp // 16):
        for warp in range(8):
            for h in range(2):
                r = warp + 8 * h
                mo = kt * 16 + r
                for i in range(3):
                    zc = ((meta2[mo] >> u32(2 * i)) & u32(3)).astype(f32)
                    sc = ((meta2[mo] >> u32(6 + 8 * i)) & u32(255)).astype(f32)
                    s = qs_all[mo] * sc + qm_all[mo]
                    sz = s * zc
                    t = pack4(*(code_byte((s * f32(c) - sz) * iv)
                                for c in range(4)))
                    g = 16 * i + r
                    w = w2[kt * 48 + g]
                    words = []
                    for hh in range(2):
                        ws = w >> u32(16 * hh)
                        ev = _byte_perm_lanes(t, np.zeros_like(t),
                                              ws & u32(0x3333))
                        od = _byte_perm_lanes(t, np.zeros_like(t),
                                              (ws >> u32(2)) & u32(0x3333))
                        words += [_byte_perm_lanes(ev, od, 0x5140),
                                  _byte_perm_lanes(ev, od, 0x7362)]
                    off = (g // 3) * 16 + (g % 3) * 4
                    tile[kt, :, off:off + 4] = np.stack(words, axis=1)
                blk = r
                words = []
                for j in range(2):
                    w = w4[kt * 32 + 2 * blk + j]
                    for hh in range(2):
                        ws = w >> u32(16 * hh)
                        lo = _byte_perm_lanes(t4[0], t4[1], ws & u32(0x7777))
                        hi = _byte_perm_lanes(t4[2], t4[3], ws & u32(0x7777))
                        top = _byte_perm_lanes(np.zeros_like(ws),
                                               np.full_like(ws, 0xFFFFFFFF),
                                               (ws >> u32(1)) & u32(0x4444))
                        words.append((lo & ~top) | (hi & top))
                tile[kt, :, blk * 16 + 12: blk * 16 + 16] = np.stack(
                    words, axis=1)
    q = tile.transpose(1, 0, 2).reshape(n, nbp * 16).view(np.int8)
    return torch.from_numpy(sw[None, :]), torch.from_numpy(q.copy())


@pytest.mark.parametrize("o,k", [(320, 1088), (64, 11008)])
def test_k5_kernel_emulation_equals_plain(o, k):
    """K5's table lookups, byte permutes and shared-memory offsets, emulated
    in numpy, give the plain version's sw and q bit for bit, at the test
    shape and at llama2_7b down_proj's K (NBP 176, 11 k-tiles)."""
    rng = np.random.default_rng(o + k)
    p = tpf.quantize_pack(torch.from_numpy(
        rng.standard_normal((o, k)).astype(np.float32)))
    sw, q = _k5_emulated(p)
    rsw, rq = tmm.dequant_int8_planes_plain(p)
    assert torch.equal(sw, rsw)
    assert torch.equal(q, rq)


def test_prefill_a8_matches_jax(packed):
    """mxq_matmul_prefill_a8 against JAX's at 512 rows: the int32 sums are
    exact on both sides, so y differs only where an activation or weight
    code flips on a half-way tie (<= 5e-3 * max|y|, the tolerance of
    tests/test_mxq_matmul.py:209); and against the f32 path, the int8
    quantization error (< 0.03, tests/test_mxq_matmul.py:189)."""
    pj, pt = packed
    x = np.random.default_rng(13).standard_normal((512, K)).astype(
        np.float32)
    yj = np.asarray(jmm.mxq_matmul_prefill_a8(jnp.asarray(x), pj))
    yt = tmm.mxq_matmul_prefill_a8(torch.from_numpy(x), pt)
    assert yt.shape == (512, O) and yt.dtype == torch.float32
    assert rel(yt, yj) <= 5e-3
    ref = torch.from_numpy(x) @ tpf.unpack_dequant(pt)
    assert rel(yt, ref) < 0.03
    # the int8 GEMM accumulates exactly: equal to an int64 matmul
    a = torch.randint(-127, 128, (32, 64), dtype=torch.int8)
    b = torch.randint(-127, 128, (64, 24), dtype=torch.int8)
    assert torch.equal(torch._int_mm(a, b).long(), a.long() @ b.long())


def test_prefill_a8_stacked_and_dtype():
    rng = np.random.default_rng(17)
    ps = [tpf.quantize_pack(torch.from_numpy(rng.standard_normal(
        (256, 1024)).astype(np.float32))) for _ in range(2)]
    st = tpf.stack_packed(ps)
    x = torch.from_numpy(rng.standard_normal((2, 40, 1024)).astype(
        np.float32))
    for i, p in enumerate(ps):
        y = tmm.mxq_matmul_prefill_a8(x, st, i)
        assert y.shape == (2, 40, 256)
        assert torch.equal(y, tmm.mxq_matmul_prefill_a8(x, p))
    yb = tmm.mxq_matmul_prefill_a8(x.to(torch.bfloat16), ps[0])
    assert yb.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# K6: the quad and bfexp GEMV layouts (MXQ_GEMV_LAYOUT)
# ---------------------------------------------------------------------------


LAYOUT_SHAPES = [(8, 256, 1024), (5, 100, 2112)]


@pytest.fixture(scope="module", params=LAYOUT_SHAPES,
                ids=lambda s: "b%d_o%d_k%d" % s)
def layout_case(request):
    return _layout_case(*request.param)


def _layout_case(b, o, k):
    """JAX's test sizes (tests/test_mxq_matmul.py:15-21, :102): x, the pack
    on both sides, and JAX's interpret-mode quad and bfexp outputs."""
    rng = np.random.default_rng(o)
    w = rng.standard_normal((o, k)).astype(np.float32)
    x = rng.standard_normal((b, k)).astype(np.float32)
    pj = jpf.quantize_pack(jnp.asarray(w))
    ys = {lay: np.asarray(jmm.mxq_matmul(jnp.asarray(x), pj, layout=lay))
          for lay in ("quad", "bfexp")}
    return torch.from_numpy(x), port_params({"p": pj})["p"], ys


def test_quad_layout_matches_jax(layout_case):
    """The port's quad route (K6's plain version: K1's function) against
    JAX's interpret-mode quad body: <= 1e-4 of max|y| (measured 7.8e-7 and
    4.6e-7)."""
    x, pt, ys = layout_case
    y = tmm.mxq_matmul(x, pt, layout="quad")
    assert y.shape == ys["quad"].shape
    assert rel(y, ys["quad"]) <= 1e-4


def test_bfexp_plain_matches_jax(layout_case):
    """gemv_bfexp_plain against JAX's interpret-mode bfexp body. Measured
    1.3e-7 and 1.9e-7 of max|y|: XLA's CPU backend rounds the bf16
    multiply and subtract as the TPU body reads them, so only the f32
    summation order differs. Gate 1e-4. Against the exact product both
    sit at the bf16 weight error (1.8e-2 and 1.5e-2), under JAX's own 0.05
    (tests/test_mxq_matmul.py:107-117)."""
    x, pt, ys = layout_case
    y = tmm.mxq_matmul(x, pt, layout="bfexp")
    assert torch.equal(y, tmm.gemv_bfexp_plain(x, pt))
    assert rel(y, ys["bfexp"]) <= 1e-4
    exact = tmm.gemv_plain(x, pt)
    assert 1e-3 < rel(y, exact) < 0.05


def test_bfexp_weights_are_bf16_rounded_twice(packed):
    """Each bfexp weight is bf16(bf16(4s * (1 + c/4)) - bf16(4s + s*z)):
    one-hot rows of x read the weights out, which must be bf16 values
    within 2.5 % of the exact dequantized weights' largest magnitude."""
    _, pt = packed
    eye = torch.eye(K)[:64]
    w = tmm.gemv_bfexp_plain(eye, pt)
    exact = tpf.unpack_dequant(pt)[:64]
    assert torch.equal(w, w.to(torch.bfloat16).float())
    assert rel(w, exact) < 0.05
    assert not torch.equal(w, exact)


@pytest.mark.parametrize("env,b1,rows,given,want", [
    ("slab", "bdg", 1, None, "bdg"),
    ("slab", "bdg", 4, None, "slab"),
    ("quad", "bdg", 1, None, "bdg"),
    ("quad", "bdg", 4, None, "quad"),
    ("bfexp", "quad", 1, None, "quad"),
    ("bfexp", "slab", 1, None, "slab"),
    ("bfexp", "bdg", 7, "bdg", "bfexp"),     # bdg at B>1 -> GEMV_LAYOUT
    ("bdg", "bdg", 7, None, "slab"),         # ... or slab where that is bdg
    ("slab", "bdg", 7, "bfexp", "bfexp"),    # an explicit layout wins
])
def test_gemv_layout_rules(monkeypatch, env, b1, rows, given, want):
    """mxq_matmul's layout rules (mxq_matmul.py:653-664, :1158-1165)."""
    monkeypatch.setattr(tmm, "GEMV_LAYOUT", env)
    monkeypatch.setenv("MXQ_GEMV_LAYOUT_B1", b1)
    assert tmm.gemv_layout(rows, given) == want


def test_gemv_layout_unknown_name_raises(monkeypatch, packed):
    _, pt = packed
    with pytest.raises(ValueError, match="layout"):
        tmm.mxq_matmul(torch.ones((2, K)), pt, layout="slabz")
    monkeypatch.setenv("MXQ_GEMV_LAYOUT_B1", "nope")
    with pytest.raises(ValueError, match="layout"):
        tmm.mxq_matmul(torch.ones((1, K)), pt)
    monkeypatch.setattr(tmm, "GEMV_LAYOUT", "nope")
    with pytest.raises(ValueError, match="layout"):
        tmm.mxq_matmul(torch.ones((3, K)), pt)


@pytest.mark.parametrize("env,rows,want", [
    ("slab", 1, "gemv_single"), ("slab", 6, "gemv_batched"),
    ("quad", 6, "gemv_quad"), ("bfexp", 6, "gemv_bfexp"),
    ("bdg", 6, "gemv_batched")])
def test_layout_routes_to_its_kernel(monkeypatch, env, rows, want):
    """Each layout reaches its wrapper, for one pack and for a layer of a
    stacked pack; the stacked path follows the same rules. MXQ_GEMV_LAYOUT_B1
    picks the one-row route: quad and bfexp run K6 at B=1 too."""
    rng = np.random.default_rng(3)
    ps = [tpf.quantize_pack(torch.from_numpy(rng.standard_normal(
        (128, 1024)).astype(np.float32))) for _ in range(2)]
    st = tpf.stack_packed(ps)
    monkeypatch.delenv("MXQ_GEMV_LAYOUT_B1", raising=False)
    called = []
    for name in ("gemv_single", "gemv_batched", "gemv_quad", "gemv_bfexp"):
        real = getattr(tmm, name)
        monkeypatch.setattr(tmm, name, lambda x, p, cfg, _n=name, _f=real:
                            called.append(_n) or _f(x, p, cfg))
    monkeypatch.setattr(tmm, "GEMV_LAYOUT", env)
    x = torch.from_numpy(rng.standard_normal((rows, 1024)).astype(
        np.float32))
    y = tmm.mxq_matmul(x, ps[1])
    ys = tmm.mxq_matmul_stacked(x, st, 1)
    assert called == [want, want] and torch.equal(y, ys)
    for b1 in ("quad", "bfexp"):
        monkeypatch.setenv("MXQ_GEMV_LAYOUT_B1", b1)
        called.clear()
        tmm.mxq_matmul(x[:1], ps[0])
        assert called == ["gemv_" + b1]


def test_gemv_layout_is_read_at_import():
    """MXQ_GEMV_LAYOUT is read once, when the module is imported, as in
    mxq_tpu; MXQ_GEMV_LAYOUT_B1 on every call."""
    import os
    import subprocess
    import sys
    code = ("from mxq_tpu_torch.ops import mxq_matmul as m; import os; "
            "os.environ['MXQ_GEMV_LAYOUT'] = 'slab'; "
            "os.environ['MXQ_GEMV_LAYOUT_B1'] = 'quad'; "
            "print(m.GEMV_LAYOUT, m.gemv_layout(3), m.gemv_layout(1))")
    env = dict(os.environ, MXQ_GEMV_LAYOUT="bfexp")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["bfexp", "bfexp", "quad"], out.stderr


# ---------------------------------------------------------------------------
# K1/K6 at B >= 2 on the tensor cores (csrc/mxq_gemv_tc.cu): numpy
# emulations of the kernel's operand build, x's slot order and its
# group-folded sums, and the wrapper's tile and K-split rule
# ---------------------------------------------------------------------------

MAGIC = np.uint32(0x43004300)       # bf16 128.0 in both halves


def _u32(a):
    return np.asarray(a).astype(np.int64).astype(np.uint32)


def _byte_perm(x, y, sel):
    """PTX prmt (CUDA __byte_perm): result byte n is byte
    (sel >> 4n) & 7 of the pair (y:x)."""
    x, y = _u32(x), _u32(y)
    out = np.zeros(np.broadcast(x, y).shape, np.uint32)
    for n in range(4):
        k = (sel >> (4 * n)) & 7
        src = x if k < 4 else y
        byte = (src >> np.uint32(8 * (k % 4))) & np.uint32(0xFF)
        out |= byte << np.uint32(8 * n)
    return out


def _rotl(w, n):
    n %= 32
    w = _u32(w)
    if n == 0:
        return w
    return (w << np.uint32(n)) | (w >> np.uint32(32 - n))


def _operand2(w, tq, layout):
    """Registers r0 (codes tq, tq+8) and r1 (tq+4, tq+12) of lane tq from
    2-bit words, before the zero is subtracted (operand2)."""
    w = _u32(w)
    if layout == "slab":
        return tuple((w >> np.uint32(s)) & np.uint32(0x00030003) | MAGIC
                     for s in (2 * tq, 2 * tq + 8))
    t = (w >> np.uint32(2 * tq)) & np.uint32(0x03030303)
    return (_byte_perm(t, 0x43434343, 0x4240),
            _byte_perm(t, 0x43434343, 0x4341))


def _operand4(w0, w1, tq, layout):
    """Registers r0 (codes tq, tq+4 of w0) and r1 (8+tq, 12+tq: the same
    of w1) of lane tq from 4-bit words (operand4)."""
    if layout == "slab":
        return tuple((_u32(w) >> np.uint32(4 * tq)) & np.uint32(0x000F000F)
                     | MAGIC for w in (w0, w1))
    sel = 0x4240 + 0x0101 * (tq >> 1)
    return tuple(_byte_perm((_u32(w) >> np.uint32(4 * (tq & 1)))
                            & np.uint32(0x0F0F0F0F), 0x43434343, sel)
                 for w in (w0, w1))


def _halves(r):
    """bf16 halves (low, high) of 32-bit registers as bf16 tensors."""
    r = _u32(r)
    return [torch.from_numpy(((h & np.uint32(0xFFFF)) << np.uint32(16))
                             .view(np.float32)).to(torch.bfloat16)
            for h in (r, r >> np.uint32(16))]


def _minus_zero(r, z):
    """sub.bf16x2 of bf16x2(128 + z): the zero operand built as the kernel
    builds it (entry_ops: prmt of the zero byte), both halves, f32."""
    zz = _halves(_byte_perm(_u32(z), 0x43, 0x4040))
    return [(h - zh).float() for h, zh in zip(_halves(r), zz)]


def _words_with(codes_at, bits, rng, n):
    """n random words whose every field is random, except those that
    codes_at {position: codes} sets; every other word negative as int32."""
    w = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    w[::2] |= np.uint32(0x80000000)
    for j, c in codes_at.items():
        field = np.uint32(((1 << bits) - 1) << (bits * j))
        w = (w & ~field) | (_u32(c) << np.uint32(bits * j))
    return w


@pytest.mark.parametrize("layout", ["slab", "quad"])
def test_tc_operand_build_is_exact(layout):
    """Every code value at every position, with every zero, in words whose
    other bits are random and half of them negative as int32: lane tq's
    registers hold c - z exactly, 2-bit r0 codes (tq, tq+8) and r1 (tq+4,
    tq+12), 4-bit r0 codes (tq, tq+4) of the first word and r1 (tq, tq+4)
    of the second; and quad's byte-quad extraction gives the very 32-bit
    registers of slab's shift and lop3."""
    rng = np.random.default_rng(7)
    n = 64
    for tq in range(4):
        js = (tq, tq + 8, tq + 4, tq + 12)
        for z in range(4):
            cs = [rng.integers(0, 4, n) for _ in js]
            for c in cs:
                c[:4] = np.arange(4)[rng.permutation(4)]     # every value
            w = _words_with(dict(zip(js, cs)), 2, rng, n)
            regs = _operand2(w, tq, layout)
            for r, (ca, cb) in zip(regs, (cs[:2], cs[2:])):
                lo, hi = _minus_zero(r, np.full(n, z))
                np.testing.assert_array_equal(lo.numpy(), ca - z)
                np.testing.assert_array_equal(hi.numpy(), cb - z)
            for r, rs in zip(regs, _operand2(w, tq, "slab")):
                np.testing.assert_array_equal(r, rs)
        for z in range(16):
            cs = [rng.integers(0, 16, n) for _ in range(4)]
            for c in cs:
                c[:16] = rng.permutation(16)
            w0 = _words_with({tq: cs[0], tq + 4: cs[1]}, 4, rng, n)
            w1 = _words_with({tq: cs[2], tq + 4: cs[3]}, 4, rng, n)
            regs = _operand4(w0, w1, tq, layout)
            for r, (ca, cb) in zip(regs, (cs[:2], cs[2:])):
                lo, hi = _minus_zero(r, np.full(n, z))
                np.testing.assert_array_equal(lo.numpy(), ca - z)
                np.testing.assert_array_equal(hi.numpy(), cb - z)
            for r, rs in zip(regs, _operand4(w0, w1, tq, "slab")):
                np.testing.assert_array_equal(r, rs)


# the MMA k-slot of each column of a 16-column chunk (permute_x_kernel):
# slot 2i + h holds column i + 8h of a 2-bit group, i + 4h + 4*(i >= 4) of
# a block's 4-bit chunk
SLOT_COL2 = [i + 8 * h for i in range(8) for h in range(2)]
SLOT_COL4 = [i + 4 * h + 4 * (i >= 4) for i in range(8) for h in range(2)]


def _permuted_x(x, p):
    """bf16(x) padded to the packed K and permuted as the kernel's first
    pass writes it: [B, NBP*3, 16] (row t*48 + g: 2-bit group g of k-tile
    t, the row order of w2) and [B, NBP, 16] (block's 4-bit chunk)."""
    nbp = p.meta2.shape[0]
    xb = torch.nn.functional.pad(x.to(torch.bfloat16).float(),
                                 (0, nbp * 64 - x.shape[1]))
    xc = xb.reshape(x.shape[0], nbp, 4, 16)
    x2 = xc[:, :, :3][..., SLOT_COL2].reshape(x.shape[0], nbp * 3, 16)
    return x2, xc[:, :, 3][..., SLOT_COL4]


def _group_meta(p):
    """Each 2-bit group's scale code, zero and second-order scale/min as
    the kernel's group table reads them: meta word (t, g % 16), field
    g // 16, for w2's row order t*48 + g."""
    nbp, n = p.meta2.shape
    rows = np.arange(nbp * 3)
    t, g = rows // 48, rows % 48
    r = t * 16 + g % 16
    f = (g // 16)[:, None]
    m = _u32(p.meta2.numpy())[r]
    z = (m >> _u32(2 * f)) & np.uint32(3)
    sc = ((m >> _u32(6 + 8 * f)) & np.uint32(255)).astype(np.float32)
    qs = p.qscale.float().numpy()[r]
    qm = p.qmin.float().numpy()[r]
    return z, sc, qs, qm


def _slot_weights(p, layout, entry):
    """The A (or B) operand of every 2-bit group and 4-bit chunk as the
    kernel builds it from the packed words, by k-slot: [NBP*3, 16, N] and
    [NBP, 16, N] f32. ``entry(regs, group_params)`` finishes a lane's
    registers (c - z, or bfexp's weights)."""
    nbp, n = p.meta2.shape
    w2 = _u32(p.w2.numpy())
    w4 = _u32(p.w4.numpy())
    a2 = torch.empty((nbp * 3, 16, n))
    a4 = torch.empty((nbp, 16, n))
    for tq in range(4):
        for k, r in enumerate(_operand2(w2, tq, layout)):
            lo, hi = entry(r, 2)
            a2[:, 2 * tq + 8 * k], a2[:, 2 * tq + 8 * k + 1] = lo, hi
        regs = _operand4(w4[0::2], w4[1::2], tq, layout)
        for k, r in enumerate(regs):
            lo, hi = entry(r, 4)
            a4[:, 2 * tq + 8 * k], a4[:, 2 * tq + 8 * k + 1] = lo, hi
    return a2, a4


def _tc_folded(x, p, layout="slab"):
    """The kernel's sums: per 2-bit group acc += s * (x_g . (c_g - z_g)),
    s = qscale * code + qmin rounded twice in f32; the 4-bit plane's
    x . (c4 - z4) over all of K, y = acc + s4 * acc4; every product over
    the k-slots of the permuted x."""
    z, sc, qs, qm = _group_meta(p)
    s = torch.from_numpy((qs * sc).astype(np.float32) + qm)      # [R, N]
    z4 = p.smeta4[1].numpy()

    def entry(r, bits):
        return _minus_zero(r, z if bits == 2 else
                           np.broadcast_to(z4.astype(np.int64), r.shape))

    a2, a4 = _slot_weights(p, layout, entry)
    x2, x4 = _permuted_x(x, p)
    part = torch.einsum("bgs,gsn->bgn", x2, a2)
    acc = (s[None] * part).sum(dim=1)
    acc4 = torch.einsum("bks,ksn->bn", x4, a4)
    return (acc + p.smeta4[0] * acc4)[:, : p.out_features]


@pytest.mark.parametrize("b,o,k", [(2, 320, 1088), (40, 1024, 4096),
                                   (130, 320, 2048)])
def test_tc_group_folded_algebra_matches_plain_and_jax(b, o, k):
    """The kernel's algebra (operands from the packed words, x in its slot
    order, the per-group fold) against gemv_plain within 1e-6 of max|y|
    (only the f32 summation order and the rounding of s * sum against the
    sum of s*(c - z) differ), and against mxq_tpu's mxq_matmul (Pallas in
    interpret mode) within 1e-4; slab and quad give the same sums."""
    rng = np.random.default_rng(b)
    w = rng.standard_normal((o, k)).astype(np.float32)
    x = rng.standard_normal((b, k)).astype(np.float32)
    pj = jpf.quantize_pack(jnp.asarray(w))
    pt = port_params({"p": pj})["p"]
    xt = torch.from_numpy(x)
    got = _tc_folded(xt, pt)
    assert got.shape == (b, o)
    assert rel(got, tmm.gemv_plain(xt, pt)) <= 1e-6
    assert rel(got, np.asarray(jmm.mxq_matmul(jnp.asarray(x), pj))) <= 1e-4
    assert torch.equal(_tc_folded(xt, pt, "quad"), got)


def test_tc_bfexp_registers_match_plain():
    """bfexp's registers: the code pair rotated into bf16 1.0's mantissa
    (1 + c/4; 4-bit 1 + c/16), times bf16(4s) and less bf16(4s + s*z) in
    bf16 (4-bit: bf16(16*s4), bf16(16*s4 + s4*z4)), with the table's
    operands packed in one word and split by prmt, give gemv_bfexp_plain's
    weights bit for bit, and with x in the same slots its output within
    1e-4 of max|y| (the f32 summation order differs)."""
    rng = np.random.default_rng(21)
    o, k = 256, 2112
    p = tpf.quantize_pack(torch.from_numpy(
        rng.standard_normal((o, k)).astype(np.float32)))
    z, sc, qs, qm = _group_meta(p)
    s = (qs * sc).astype(np.float32) + qm
    s4x = (4 * s).astype(np.float32)

    def packed_entry(a, b):
        """bf16(a) | bf16(b) << 16, split back as entry_ops does"""
        ha = _u32(torch.from_numpy(a).to(torch.bfloat16).view(
            torch.int16).numpy()) & np.uint32(0xFFFF)
        hb = _u32(torch.from_numpy(b).to(torch.bfloat16).view(
            torch.int16).numpy()) & np.uint32(0xFFFF)
        e = ha | (hb << np.uint32(16))
        return (_halves(_byte_perm(e, 0, 0x1010))[0],
                _halves(_byte_perm(e, 0, 0x3232))[0])

    e2 = packed_entry(s4x, (s4x + s * z.astype(np.float32)).astype(
        np.float32))
    s4, z4 = p.smeta4[0].numpy(), p.smeta4[1].numpy()
    s16 = (16 * s4).astype(np.float32)
    e4 = packed_entry(s16, (s16 + s4 * z4).astype(np.float32))

    def entry(r, bits):
        # the code pair sits at bits 0-1 (2-bit) or 0-3 (4-bit) of each
        # half of a slab register: rotate it to bits 5-6 or 3-6
        c = _u32(r) & np.uint32(0x000F000F)
        pb = c << np.uint32(5 if bits == 2 else 3) | np.uint32(0x3F803F80)
        sb, zb = e2 if bits == 2 else (
            e4[0].expand(c.shape[0], -1), e4[1].expand(c.shape[0], -1))
        return [((sb * h) - zb).float() for h in _halves(pb)]

    a2, a4 = _slot_weights(p, "slab", entry)
    x = torch.from_numpy(rng.standard_normal((5, k)).astype(np.float32))
    x2, x4 = _permuted_x(x, p)
    y = (torch.einsum("bgs,gsn->bn", x2, a2)
         + torch.einsum("bks,ksn->bn", x4, a4))[:, :o]
    assert rel(y, tmm.gemv_bfexp_plain(x, p)) <= 1e-4
    # the weights in natural column order against the plain version's,
    # read out by one-hot rows of x
    nat2 = a2.reshape(-1, 3, 16, a2.shape[-1])[:, :, np.argsort(SLOT_COL2)]
    nat4 = a4[:, np.argsort(SLOT_COL4)]
    wk = torch.cat([nat2.reshape(nat2.shape[0], 48, -1),
                    nat4.reshape(nat4.shape[0], 16, -1)], dim=1)
    wk = wk.reshape(-1, a2.shape[-1])[:k, :o]
    assert torch.equal(wk, tmm.gemv_bfexp_plain(torch.eye(k), p))


def test_tc_bfexp_rotation_is_the_kernels_shift():
    """The kernel takes bfexp's code pair by one rotation of the word
    (rotl(w, 5 - 2j) & 0x00600060; 4-bit rotl(w, 3 - 4j) & 0x00780078),
    which must put codes j and j+8 (4-bit j and j+4) where the slab
    register's mask, shifted, puts them, for every position and word."""
    rng = np.random.default_rng(3)
    w = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    for j in range(8):
        slab = (w >> np.uint32(2 * j)) & np.uint32(0x00030003)
        np.testing.assert_array_equal(
            _rotl(w, 5 - 2 * j) & np.uint32(0x00600060),
            slab << np.uint32(5))
    for j in range(4):
        slab = (w >> np.uint32(4 * j)) & np.uint32(0x000F000F)
        np.testing.assert_array_equal(
            _rotl(w, 3 - 4 * j) & np.uint32(0x00780078),
            slab << np.uint32(3))


# (batch rows, columns, blocks per SM) of K1/K6's tile ids as
# csrc/mxq_gemv_tc.cu builds them on the H100 (ops/mxq_matmul._k1_tiles
# reads them from the library on the card; a cuda test holds them to this)
K1_TILES = ((8, 128, 2), (32, 64, 2), (128, 128, 1))
K1_SPLIT_ROWS = (2, 8, 40, 64, 65, 128, 511)


@pytest.mark.parametrize("b,tile", [(1, 0), (2, 0), (8, 0), (9, 1), (40, 1),
                                    (64, 1), (65, 2), (128, 2), (511, 2)])
def test_k1_tile_rule(b, tile):
    """Codes-major blocks of 8 rows up to 8, of 32 up to 64 (two row blocks
    above 32), then 128-row group-major tiles, up to the 511 rows under
    the prefill switch."""
    assert tmm._k1_tile(b) == tile
    assert b <= 2 * K1_TILES[tile][0] or tile == len(K1_TILES) - 1


@pytest.mark.parametrize("name,n_kt,n,want", [
    ("qkv", 4, 12288, (2, 2, 2, 2, 4, 4, 4)),
    ("o", 4, 4096, (1, 1, 2, 2, 1, 1, 4)),
    ("gate_up", 4, 22528, (4, 4, 4, 4, 2, 2, 4)),
    ("down", 11, 4096, (2, 2, 6, 6, 3, 3, 11)),
])
@pytest.mark.parametrize("i", range(len(K1_SPLIT_ROWS)),
                         ids=[f"b{b}" for b in K1_SPLIT_ROWS])
def test_k1_split_tiles(name, n_kt, n, want, i):
    """K1/K6's K split at llama2_7b's four packed linears on a 132-SM
    H100, k-tiles per split: the fewest waves times (k-tiles + 1 of
    fill), ties to fewer splits. E.g. o at B=8: 32 column blocks, four
    splits of one k-tile fill 128 of the 264 slots in one wave."""
    b = K1_SPLIT_ROWS[i]
    per = tmm._k1_split_tiles(n_kt, n, b, 132, K1_TILES)
    assert per == want[i]
    assert 1 <= per <= n_kt




# ---------------------------------------------------------------------------
# K2 and K6-quad at one row (csrc/mxq_gemv.cu gemv_row_kernel): numpy
# emulations of the kernel's code floats, its lane <-> column map, the
# warps' K partition and its fixed-order sums
# ---------------------------------------------------------------------------

F32_2_23 = np.float32(2.0**23)


def _code_floats(words, bits, layout):
    """Every code of ``words`` as the kernel's float: [32 // bits, *shape]
    f32, code j first. slab shifts field j down and mask-ors it into
    0x4B000000 (2^23 + c); quad masks four codes per shift (2-bit &
    0x03030303: byte b of shift k is code k + 4b; 4-bit & 0x0F0F0F0F: code
    k + 2b) and byte-permutes each byte into the same pattern; both then
    subtract 2^23."""
    w = _u32(words)
    per = 32 // bits
    out = np.empty((per,) + w.shape, np.uint32)
    if layout == "slab":
        for j in range(per):
            out[j] = ((w >> np.uint32(bits * j)) & np.uint32((1 << bits) - 1)
                      | np.uint32(0x4B000000))
    else:
        shifts = per // 4
        mask = np.uint32(0x03030303 if bits == 2 else 0x0F0F0F0F)
        for k in range(shifts):
            t = (w >> np.uint32(bits * k)) & mask
            for b in range(4):
                out[k + shifts * b] = _byte_perm(t, 0x4B000000, 0x7540 | b)
    return out.view(np.float32) - F32_2_23


def _field_float(word, shift, bits):
    """A meta field (zero or scale code) as the kernel's float."""
    f = (_u32(word) >> np.uint32(shift)) & np.uint32((1 << bits) - 1)
    return (f | np.uint32(0x4B000000)).view(np.float32) - F32_2_23


def _warp_rows(nbp, rows, warps):
    """[(split, warp, meta rows)] of the kernel's K partition: split s
    holds rows [s*rows, min(nbp, (s+1)*rows)), cut into ``warps`` runs of
    ceil(rows / warps)."""
    per = -(-rows // warps)
    out = []
    for s in range(-(-nbp // rows)):
        m0, m1 = s * rows, min(nbp, (s + 1) * rows)
        for w in range(warps):
            out.append((s, w, range(min(m1, m0 + w * per),
                                    min(m1, m0 + (w + 1) * per))))
    return out


def _row_emulated(x, p, rows, layout="slab", tile=ROW_TILES[0]):
    """y [1, O] as gemv_row_kernel computes it, in f32, in its order: x
    staged as f32 with every 16-column chunk summed as (x0 + .. + x7) +
    (x8 + .. + x15); lane l of column block nb owns columns nb*128 + 4l ..
    +3 (its 16-byte loads); per warp and meta row, per 2-bit group dot =
    sum_j x_j * c_j in code order, acc += s*dot - s*z*chunk sum, the 4-bit
    codes into acc4, the block's 4-bit chunk sums into xsum4; the warps'
    sums added in warp order (thread t reads slot t of the lanes' float4
    stores: column nb*128 + t); part = acc + s4*acc4 - s4*z4*xsum4; the
    splits added in order."""
    cols, warps, _ = tile
    nbp, n = p.meta2.shape
    nb = n // cols
    xs = np.zeros(nbp * 64, np.float32)
    xs[: x.shape[1]] = x.to(torch.bfloat16).float().numpy()[0]
    half = xs.reshape(-1, 8)
    h = half[:, 0].copy()
    for e in range(1, 8):
        h = h + half[:, e]
    csum = h[0::2] + h[1::2]                        # [nbp * 4] chunks

    def lanes(a):                                   # [rows, nb, 32, 4]
        return np.asarray(a).reshape(a.shape[0], nb, 32, cols // 32)

    w2, w4, meta = (lanes(_u32(t.numpy())) for t in (p.w2, p.w4, p.meta2))
    qs, qm = (lanes(t.float().numpy()) for t in (p.qscale, p.qmin))
    col_of_slot = lanes(np.arange(n)[None])[0].reshape(nb, cols)
    assert (col_of_slot == np.arange(n).reshape(nb, cols)).all()
    s4 = p.smeta4[0].numpy().reshape(nb, cols)
    z4 = p.smeta4[1].numpy().reshape(nb, cols)
    parts = {}
    for s, w, run in _warp_rows(nbp, rows, warps):
        acc = np.zeros((nb, 32, cols // 32), np.float32)
        acc4 = np.zeros_like(acc)
        xsum4 = np.float32(0)
        for mm in run:
            t, r = divmod(mm, 16)
            for i in range(3):
                g = 16 * i + r
                chunk = t * 64 + 4 * (g // 3) + g % 3
                v = _code_floats(w2[t * 48 + g], 2, layout)
                dot = np.zeros_like(acc)
                for j in range(16):
                    dot = dot + xs[16 * chunk + j] * v[j]
                zc = _field_float(meta[mm], 2 * i, 2)
                sc = _field_float(meta[mm], 6 + 8 * i, 8)
                sg = qs[mm] * sc + qm[mm]
                acc = acc + (sg * dot - sg * zc * csum[chunk])
            for hh in range(2):
                v = _code_floats(w4[2 * mm + hh], 4, layout)
                base = t * 1024 + 64 * r + 48 + 8 * hh
                for j in range(8):
                    acc4 = acc4 + xs[base + j] * v[j]
            xsum4 = xsum4 + csum[t * 64 + 4 * r + 3]
        parts.setdefault(s, []).append((acc.reshape(nb, cols),
                                        acc4.reshape(nb, cols), xsum4))
    y = np.zeros((nb, cols), np.float32)
    for s in sorted(parts):
        a, a4, x4 = parts[s][0]
        for b, b4, bx in parts[s][1:]:
            a, a4, x4 = a + b, a4 + b4, x4 + bx
        y = y + (a + s4 * a4 - s4 * z4 * x4)
    return torch.from_numpy(y.reshape(1, n)[:, : p.out_features].copy())


@pytest.mark.parametrize("bits", [2, 4])
def test_row_code_floats_are_exact(bits):
    """Every code value at every position of words whose other bits are
    random (half of them negative as int32): slab's and quad's floats are
    the code exactly, and quad's equal slab's; every zero and scale code of
    a meta word at each of its three fields, likewise."""
    rng = np.random.default_rng(11)
    per, top = 32 // bits, 1 << bits
    n = 4 * top
    for j in range(per):
        c = np.tile(np.arange(top), 4)
        w = _words_with({j: c}, bits, rng, n)
        slab = _code_floats(w, bits, "slab")
        np.testing.assert_array_equal(slab[j], c.astype(np.float32))
        np.testing.assert_array_equal(_code_floats(w, bits, "quad"), slab)
    for i in range(3):
        z = np.tile(np.arange(4), 256)
        sc = np.repeat(np.arange(256), 4)
        m = _u32(rng.integers(0, 2**32, z.size, dtype=np.uint64))
        m &= ~_u32((3 << (2 * i)) | (255 << (6 + 8 * i)))
        m |= _u32(z << (2 * i)) | _u32(sc << (6 + 8 * i))
        np.testing.assert_array_equal(_field_float(m, 2 * i, 2), z)
        np.testing.assert_array_equal(_field_float(m, 6 + 8 * i, 8), sc)


@pytest.mark.parametrize("nbp,rows,warps", [
    (64, 8, 8), (64, 16, 8), (64, 32, 8), (176, 16, 8), (176, 32, 8),
    (176, 4, 1), (32, 8, 8), (48, 64, 8)])
def test_row_warp_partition(nbp, rows, warps):
    """The warps' runs of meta rows cover [0, nbp) once, in order, each
    within one split, and a split's rows lie in the k-tiles of x the block
    stages (row_tiles: rows / 16 k-tiles, or the one k-tile of a shorter
    split)."""
    runs = _warp_rows(nbp, rows, warps)
    seen = [m for _, _, run in runs for m in run]
    assert seen == list(range(nbp))
    staged = rows // 16 if rows >= 16 else 1
    for s, _, run in runs:
        if len(run):
            assert s * rows <= run[0] and run[-1] < (s + 1) * rows
            assert run[-1] // 16 - s * rows // 16 < staged


@pytest.mark.parametrize("o,k", [(320, 1088), (1024, 4096), (384, 2880)])
def test_row_kernel_algebra_matches_plain_and_jax(o, k):
    """The one-row kernel's decomposition at the rule's split and at splits
    of one and two k-tiles (and the whole K): against gemv_plain within
    1e-6 of max|y| (the f32 summation order and the per-group fold differ)
    and against mxq_tpu's one-row mxq_matmul (bdg, Pallas in interpret
    mode) within 1e-4; quad's sums equal slab's bit for bit."""
    rng = np.random.default_rng(o + k)
    w = rng.standard_normal((o, k)).astype(np.float32)
    x = rng.standard_normal((1, k)).astype(np.float32)
    pj = jpf.quantize_pack(jnp.asarray(w))
    pt = port_params({"p": pj})["p"]
    xt = torch.from_numpy(x)
    nbp, n = pt.meta2.shape
    plain = tmm.gemv_plain(xt, pt)
    yj = np.asarray(jmm.mxq_matmul(jnp.asarray(x), pj))
    rule = tmm._split_rows(nbp, n, 132, ROW_TILES[0])
    for rows in sorted({rule, 16, 32, nbp}):
        got = _row_emulated(xt, pt, rows)
        assert got.shape == (1, o)
        assert rel(got, plain) <= 1e-6, rows
        assert rel(got, yj) <= 1e-4, rows
    assert torch.equal(_row_emulated(xt, pt, rule, "quad"),
                       _row_emulated(xt, pt, rule))


# ---------------------------------------------------------------------------
# K6-bfexp at one row (csrc/mxq_gemv.cu bfexp_row_kernel): numpy emulation
# of the kernel's lane map (columns onto MMA rows, codes onto k-slots, x's
# slot order in shared memory) and of its fixed-order sums
# ---------------------------------------------------------------------------

BF_ROT = (3, 31, 27, 23)            # register i's rotation: 3 - 4 (i % 4)


def _bf_stage_pairs(x16, mm, tq):
    """Lane tq's 8 x pair words of meta row mm as the kernel stages them
    (bf_stage_pairs): the 16-column chunk of 2-bit group 16 tq + r (tq <
    3) or the 4-bit chunk (tq == 3), read as 8 words of column pairs and
    byte-permuted into the registers' code pairs. ``x16`` holds x's 16-bit
    values, zero beyond K and padded to the packed K. Returns [8] uint32."""
    t, r = divmod(mm, 16)
    g = 16 * tq + r
    col = t * 1024 + (64 * r + 48 if tq == 3 else 64 * (g // 3) + 16 * (g % 3))
    v = _u32(x16[col:col + 16])
    w = v[0::2] | (v[1::2] << np.uint32(16))
    out = np.empty(8, np.uint32)
    for i in range(4):
        if tq == 3:
            sel = 0x7632 if i & 1 else 0x5410
            out[i] = _byte_perm(w[i >> 1], w[(i >> 1) + 2], sel)
            out[i + 4] = _byte_perm(w[4 + (i >> 1)], w[6 + (i >> 1)], sel)
        else:
            out[i] = _byte_perm(w[i], w[i + 4], 0x7632)
            out[i + 4] = _byte_perm(w[i], w[i + 4], 0x5410)
    return out


def _bf16(a):
    """f32 array rounded to bf16 (nearest even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _bf_registers(p, mm, tq):
    """Lane tq's eight registers of meta row mm for every column, as the
    kernel builds them: [8, 2, N] f32 (low half, high half)."""
    f32, u32 = np.float32, np.uint32
    t, r = divmod(mm, 16)
    w2, w4, meta = (_u32(getattr(p, f).numpy()) for f in ("w2", "w4",
                                                         "meta2"))
    m = meta[mm]
    if tq == 3:
        wa, wb = w4[2 * mm], w4[2 * mm + 1]
        mask = u32(0x00780078)
        s4, z4 = p.smeta4[0].numpy(), p.smeta4[1].numpy()
        s16 = (f32(16) * s4).astype(f32)
        e0, e1 = _bf16(s16), _bf16(s16 + (s4 * z4).astype(f32))
    else:
        wa = w2[t * 48 + 16 * tq + r]
        wb = _rotl(wa, 2)
        mask = u32(0x00600060)
        z = _field_float(m, 2 * tq, 2)
        sc = _field_float(m, 6 + 8 * tq, 8)
        s = ((p.qscale[mm].float().numpy() * sc).astype(f32)
             + p.qmin[mm].float().numpy()).astype(f32)
        s4x = (f32(4) * s).astype(f32)
        e0, e1 = _bf16(s4x), _bf16(s4x + (s * z).astype(f32))
    out = np.empty((8, 2) + wa.shape, f32)
    for i in range(8):
        pb = (_rotl(wa if i < 4 else wb, BF_ROT[i % 4]) & mask) \
            | u32(0x3F803F80)
        for h, half in enumerate(_halves(pb)):
            out[i, h] = _bf16(_bf16(e0 * half.float().numpy()) - e1)
    return out


def _bfexp_row_emulated(x, p, rows, warps):
    """bfexp_row_kernel in numpy: (y [1, O], the weights it multiplies
    [NBP*64, N] in x's column order). Per meta row and lane tq the
    registers (_bf_registers) and the x pairs the kernel stages for the
    same slots (_bf_stage_pairs, zero at columns >= K; staging column
    indices in place of x tells where each weight sits); each MMA's 16
    products of a column summed in slot order, accumulated over the warp's
    rows; the warps' sums added in warp order, the splits in split
    order."""
    nbp, n = p.meta2.shape
    k = x.shape[1]
    xbits = np.zeros(nbp * 64, np.int64)
    xbits[:k] = x.to(torch.bfloat16).view(torch.int16).numpy()[0].view(
        np.uint16)
    cols = np.arange(nbp * 64)                # where each staged half came from
    wk = np.full((nbp * 64, n), np.nan, np.float32)
    per_row = []
    for mm in range(nbp):
        acc = np.zeros(n, np.float32)
        regs = [_bf_registers(p, mm, tq) for tq in range(4)]
        xw = [_bf_stage_pairs(xbits, mm, tq) for tq in range(4)]
        cw = [_bf_stage_pairs(cols, mm, tq) for tq in range(4)]
        for q in range(4):                    # MMA q: registers 2q, 2q + 1
            dot = np.zeros(n, np.float32)
            for i in (2 * q, 2 * q + 1):
                for tq in range(4):
                    for h in range(2):
                        sh = np.uint32(16 * h)
                        col = int((cw[tq][i] >> sh) & np.uint32(0xFFFF))
                        wk[col] = regs[tq][i, h]
                        xv = (((xw[tq][i] >> sh) & np.uint32(0xFFFF))
                              << np.uint32(16)).view(np.float32)
                        dot = dot + xv * regs[tq][i, h]
            acc = acc + dot
        per_row.append(acc)
    y = np.zeros(n, np.float32)
    parts = {}
    for s, _, run in _warp_rows(nbp, rows, warps):
        a = np.zeros(n, np.float32)
        for mm in run:
            a = a + per_row[mm]
        parts[s] = a if s not in parts else parts[s] + a
    for s in sorted(parts):
        y = y + parts[s]
    return (torch.from_numpy(y[None, : p.out_features].copy()),
            torch.from_numpy(wk))


@pytest.mark.parametrize("o,k", [(320, 1088), (64, 11008)])
def test_bfexp_row_kernel_emulation_equals_plain(o, k):
    """The one-row bfexp kernel's lane map, emulated in numpy: every weight
    it multiplies (code onto k-slot, rotation, mask, entry) equals
    gemv_bfexp_plain's bit for bit at the position its x pair holds, every
    position once; and its sums (split by the rule's K split and 4 warps)
    within 1e-6 of max|y| of gemv_bfexp_plain (only the f32 order
    differs), at the test shape and at llama2_7b down_proj's K (NBP 176,
    11 k-tiles)."""
    rng = np.random.default_rng(o + k + 1)
    p = tpf.quantize_pack(torch.from_numpy(
        rng.standard_normal((o, k)).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((1, k)).astype(np.float32))
    nbp, n = p.meta2.shape
    rows = tmm._split_rows(nbp, n, 132, ROW_TILES[1])
    y, wk = _bfexp_row_emulated(x, p, rows, ROW_TILES[1][1])
    w2, w4 = tmm.bfexp_weights_plain(p)
    want = torch.cat([w2.reshape(nbp, 48, n), w4.reshape(nbp, 16, n)],
                     dim=1).reshape(nbp * 64, n)
    assert not bool(wk.isnan().any())
    assert torch.equal(wk, want)
    assert rel(y, tmm.gemv_bfexp_plain(x, p)) <= 1e-6


if __name__ == "__main__":
    # the gaps quoted in ROADMAP.md (queue 3), as rel = max|diff| / max|y|
    for shape in LAYOUT_SHAPES:
        x, pt, ys = _layout_case(*shape)
        bfexp = tmm.gemv_bfexp_plain(x, pt)
        print(shape, "quad vs JAX", rel(tmm.gemv_plain(x, pt), ys["quad"]),
              "bfexp vs JAX", rel(bfexp, ys["bfexp"]),
              "bfexp vs exact", rel(bfexp, tmm.gemv_plain(x, pt)))
