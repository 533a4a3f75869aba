"""K1-K6, K4a-K4d, K7, K8, K9-K11, K12, K13 and K13-bwd on the card
against their plain PyTorch versions at small shapes (the one-row kernels
also at llama2_7b down's K of 11008, the attention kernels at histories
of up to 4096 rows, cut at their 128-row split edges), and the
quantizers on the card against the CPU (the PTQ packer, the QAT
fake-quants, the int8 KV and activation quantizers). Needs a CUDA device
and nvcc (marker ``cuda``); skips elsewhere. Run on the H100 with
``python -m pytest -m cuda tests/test_torch_kernels_cuda.py``;
``chip_smoke.py`` holds the same kernels at llama2_7b's shapes."""

import math

import pytest
import torch

from mxq_tpu_torch import packfmt
from mxq_tpu_torch.ops import attn_bf16 as ab
from mxq_tpu_torch.ops import attn_int8 as a8
from mxq_tpu_torch.ops import mxq_matmul as mm
from mxq_tpu_torch.ops import uniform4 as u4

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _pack(gen, o, k):
    w = torch.randn((o, k), generator=gen, device="cuda") / math.sqrt(k)
    return packfmt.quantize_pack(w)


# every tile of K1/K6's template and its edges: codes-major 8-row (2-8)
# and 32-row blocks (13-64, two row blocks above 32), group-major 128-row
# tiles (65-511)
GEMV_ROWS = [1, 2, 8, 13, 40, 64, 65, 128, 200, 511]


@pytest.mark.parametrize("b", GEMV_ROWS)
@pytest.mark.parametrize("o,k", [(320, 1088), (1024, 4096)])
def test_gemv_kernels_match_plain(gen, b, o, k):
    p = _pack(gen, o, k)
    x = torch.randn((b, k), generator=gen, device="cuda").to(torch.bfloat16)
    fn = mm.gemv_single if b == 1 else mm.gemv_batched
    y = fn(x, p)
    ref = mm.gemv_plain(x, p)
    torch.cuda.synchronize()
    assert y.shape == (b, o)
    assert float((y - ref).abs().max() / ref.abs().max()) <= 1e-4


@pytest.mark.parametrize("b", GEMV_ROWS)
@pytest.mark.parametrize("o,k", [(320, 1088), (1024, 4096)])
def test_gemv_layout_kernels_match_plain(gen, b, o, k):
    """K6 against its plain versions, <= 1e-4 of max|y|: quad against
    K1's function (and equal to K1's, at B=1 K2's, output bit for bit:
    the same operands and sums in the same order), bfexp against
    gemv_bfexp_plain (the same bf16 weights, bit for bit; only the f32
    summation order differs), and bfexp's function within 0.05 of the
    exact product."""
    p = _pack(gen, o, k)
    x = torch.randn((b, k), generator=gen, device="cuda").to(torch.bfloat16)
    yq, yb = mm.gemv_quad(x, p), mm.gemv_bfexp(x, p)
    ref, refb = mm.gemv_plain(x, p), mm.gemv_bfexp_plain(x, p)
    torch.cuda.synchronize()
    assert yq.shape == yb.shape == (b, o)
    assert float((yq - ref).abs().max() / ref.abs().max()) <= 1e-4
    assert torch.equal(yq, (mm.gemv_single if b == 1 else mm.gemv_batched)(
        x, p))
    assert float((yb - refb).abs().max() / refb.abs().max()) <= 1e-4
    assert float((refb - ref).abs().max() / ref.abs().max()) < 0.05


@pytest.mark.parametrize("b", [1, 8, 40, 128])
def test_gemv_kernels_on_stacked_layer(gen, b):
    """K1 (K2 at one row) and K6 on layer 1 of a stacked pack (views at a
    layer offset) from f32 x, as the model's layer loop calls them: equal
    to the same kernel on that layer's own pack, and within 1e-4 of the
    plain version."""
    ps = [_pack(gen, 512, 2112) for _ in range(3)]
    st = packfmt.stack_packed(ps)
    x = torch.randn((b, 2112), generator=gen, device="cuda")
    k1 = mm.gemv_single if b == 1 else mm.gemv_batched
    for fn, plain in ((k1, mm.gemv_plain),
                      (mm.gemv_quad, mm.gemv_plain),
                      (mm.gemv_bfexp, mm.gemv_bfexp_plain)):
        y = fn(x, st.layer(1))
        ref = plain(x, ps[1])
        torch.cuda.synchronize()
        assert torch.equal(y, fn(x, ps[1]))
        assert float((y - ref).abs().max() / ref.abs().max()) <= 1e-4


@pytest.mark.parametrize("o,k", [(512, 11008), (4096, 11008)])
def test_one_row_kernels_at_down_width(gen, o, k):
    """The one-row kernels at K = 11008 (llama2_7b down's 176 meta rows,
    11 k-tiles): K2 within 1e-4 of gemv_plain, gemv_quad at one row equal
    to it bit for bit, gemv_bfexp at one row (bfexp_row_kernel) within
    1e-4 of gemv_bfexp_plain."""
    p = _pack(gen, o, k)
    x = torch.randn((1, k), generator=gen, device="cuda").to(torch.bfloat16)
    y = mm.gemv_single(x, p)
    yq, yb = mm.gemv_quad(x, p), mm.gemv_bfexp(x, p)
    ref, refb = mm.gemv_plain(x, p), mm.gemv_bfexp_plain(x, p)
    torch.cuda.synchronize()
    assert y.shape == yq.shape == yb.shape == (1, o)
    assert float((y - ref).abs().max() / ref.abs().max()) <= 1e-4
    assert torch.equal(yq, y)
    assert float((yb - refb).abs().max() / refb.abs().max()) <= 1e-4


def test_k2_x_at_any_offset(gen):
    """K2 stages x by 16-byte loads where x is 16-byte aligned and K a
    multiple of 8, else element by element: a bf16 x at an odd element
    offset gives the aligned copy's output bit for bit."""
    p = _pack(gen, 320, 1088)
    buf = torch.randn((1, 1089), generator=gen, device="cuda").to(
        torch.bfloat16)
    x = buf[:, 1:]
    assert x.is_contiguous() and x.data_ptr() % 16
    y = mm.gemv_single(x, p)
    torch.cuda.synchronize()
    assert torch.equal(y, mm.gemv_single(x.clone(), p))


@pytest.mark.parametrize("o,k", [(12288, 4096), (4096, 4096),
                                 (22016, 4096), (4096, 11008)],
                         ids=["qkv", "o", "gate_up", "down"])
def test_bfexp_one_row_at_7b_linears(gen, o, k):
    """K6-bfexp's one-row kernel (bfexp_row_kernel) at llama2_7b's four
    packed linears: one launch a call, within 1e-4 of max|y| of
    gemv_bfexp_plain (the same bf16 weights; only the f32 summation order
    differs), and the same output again on a second call (fixed-order
    sums)."""
    p = _pack(gen, o, k)
    x = torch.randn((1, k), generator=gen, device="cuda").to(torch.bfloat16)
    n0 = mm.gemv_bfexp.launches
    y = mm.gemv_bfexp(x, p)
    ref = mm.gemv_bfexp_plain(x, p)
    torch.cuda.synchronize()
    assert mm.gemv_bfexp.launches - n0 == 1
    assert y.shape == (1, o)
    assert float((y - ref).abs().max() / ref.abs().max()) <= 1e-4
    assert torch.equal(y, mm.gemv_bfexp(x, p))


def test_bfexp_x_at_any_offset(gen):
    """bfexp_row_kernel gathers x element by element into its slot order:
    a bf16 x at an odd element offset gives the aligned copy's output bit
    for bit."""
    p = _pack(gen, 320, 1088)
    buf = torch.randn((1, 1089), generator=gen, device="cuda").to(
        torch.bfloat16)
    x = buf[:, 1:]
    assert x.is_contiguous() and x.data_ptr() % 16
    y = mm.gemv_bfexp(x, p)
    torch.cuda.synchronize()
    assert torch.equal(y, mm.gemv_bfexp(x.clone(), p))


def test_row_tiles_as_built(gen):
    """The one-row kernels' geometry the built library reports, with the
    blocks per SM the card places gemv_row_kernel and bfexp_row_kernel at,
    is the table the CPU tests hold the K split to
    (tests/test_torch_mxq_matmul.py ROW_TILES)."""
    assert mm._row_tiles() == ((128, 8, 2), (32, 4, 9))


def test_k1_tiles_as_built(gen):
    """The tiles the built K1/K6 library reports, with the blocks per SM
    the card places, are the table the CPU tests hold the tile rule and K
    split to (tests/test_torch_mxq_matmul.py K1_TILES)."""
    assert mm._k1_tiles() == ((8, 128, 2), (32, 64, 2), (128, 128, 1))


@pytest.mark.parametrize("o,k", [(320, 1088), (11008, 4096)])
def test_quantizers_on_the_card_equal_the_cpu(gen, o, k):
    """quantize_pack and mxq_quantize_ptq (both zero variants) on the card
    give the CPU's fields bit for bit: every division by a constant is
    IEEE (a Python divisor made the card multiply by its reciprocal)."""
    from mxq_tpu_torch import scheme
    w = (torch.randn((o, k), generator=gen, device="cuda")
         / math.sqrt(k)).to(torch.bfloat16)
    card, host = packfmt.quantize_pack(w), packfmt.quantize_pack(w.cpu())
    for f in packfmt.FIELDS:
        assert torch.equal(getattr(card, f).cpu(), getattr(host, f)), f
    for round_zero in (False, True):
        card = scheme.mxq_quantize_ptq(w, round_zero=round_zero)
        host = scheme.mxq_quantize_ptq(w.cpu(), round_zero=round_zero)
        for f in card._fields:
            assert torch.equal(getattr(card, f).cpu(), getattr(host, f)), f


@pytest.mark.parametrize("o,k", [(320, 1088), (1024, 4096)])
def test_dequant_kernel_bit_equal(gen, o, k):
    p = _pack(gen, o, k)
    wd2, wd4 = mm.dequant_planes(p)
    r2, r4 = mm.dequant_planes_plain(p)
    torch.cuda.synchronize()
    assert torch.equal(wd2.view(torch.int16), r2.view(torch.int16))
    assert torch.equal(wd4.view(torch.int16), r4.view(torch.int16))


def _edge_positions(s, t=1):
    """Positions at the split edges of a history of s rows (0, 1, 127,
    128, 129, 255, 256 and the last row), each leaving room for t query
    tokens."""
    return sorted({min(p, s - t) for p in (0, 1, 127, 128, 129, 255, 256,
                                           s - 1)})


# the int8 family's head_dims: its templates (64, 128, 256) and, read in
# place at the next template, 80 (16-byte loads), 100 (open_llama_3b: 4-byte
# loads) and 99 (one byte at a time); past 256 the wide path
# (attn_int8_wide.cu) at 257 and 301 (one byte a load), 300 (4 bytes),
# 384, 512 and 1024 (16 bytes)
INT8_WIDE = [(4, 2, 257), (8, 2, 300), (2, 2, 301), (8, 2, 384),
             (8, 2, 512), (4, 1, 1024)]
INT8_DIMS = [(4, 2, 64), (8, 8, 128), (16, 2, 128), (8, 2, 80), (4, 4, 100),
             (2, 2, 99), (8, 1, 256)] + INT8_WIDE


@pytest.mark.parametrize("s", [1, 96, 300, 4096])
@pytest.mark.parametrize("hq,hkv,d", INT8_DIMS)
def test_attention_kernel_matches_plain(gen, hq, hkv, d, s):
    """K4 at histories of 1-4096 rows: ctx within 1e-3 of the plain version
    (expected ~1e-7: no rounding point moves), the written rows
    bit-exact, every other cache byte untouched; at every head_dim of
    INT8_DIMS."""
    L, S = 2, s
    plist = _edge_positions(S)
    B = len(plist)
    cat = dict(generator=gen, device="cuda")
    kc = torch.randint(-127, 128, (L, B, hkv, S, d), dtype=torch.int8, **cat)
    vc = torch.randint(-127, 128, (L, B, hkv, S, d), dtype=torch.int8, **cat)
    ks = (torch.rand((L, B, hkv, S), **cat) * 0.02 + 1e-3).to(torch.bfloat16)
    vs = (torch.rand((L, B, hkv, S), **cat) * 0.02 + 1e-3).to(torch.bfloat16)
    q = torch.randn((B, hq, d), **cat).to(torch.bfloat16)
    kcur = torch.randint(-127, 128, (B, hkv, 1, d), dtype=torch.int8, **cat)
    vcur = torch.randint(-127, 128, (B, hkv, 1, d), dtype=torch.int8, **cat)
    kscur = (torch.rand((B, hkv, 1), **cat) * 0.02 + 1e-3).to(torch.bfloat16)
    vscur = (torch.rand((B, hkv, 1), **cat) * 0.02 + 1e-3).to(torch.bfloat16)
    pos = torch.tensor(plist, dtype=torch.int32, device="cuda")
    kc1, vc1 = kc.clone(), vc.clone()
    ctx, _, _ = a8.int8_decode_attention_fused_write(
        q, kc1, ks, vc1, vs, kcur, kscur, vcur, vscur, 1, pos)
    ref, _, _ = a8.int8_decode_attention_fused_write_plain(
        q, kc, ks, vc, vs, kcur, kscur, vcur, vscur, 1, pos)
    torch.cuda.synchronize()
    assert float((ctx - ref).abs().max() / ref.abs().max()) <= 1e-3
    assert torch.equal(kc1, kc) and torch.equal(vc1, vc)


@pytest.mark.parametrize("s", [96, 300, 4096])
@pytest.mark.parametrize("hq,hkv,d", INT8_DIMS)
def test_attention_flag_kernels_match_plain(gen, hq, hkv, d, s):
    """K4a/K4c (rows <= pos, no current token) and K4b/K4d (rows < pos plus
    the current token, no write) against their plain versions; neither
    changes the cache. Also verify-shaped calls: 5 single-query calls at
    pos .. pos+4, and one multi-query K4a call (q [B, 5, Hq, D], up to
    G * T = 40 query rows per kv head) against them and the plain
    version, in one launch."""
    L, S = 2, s
    plist = _edge_positions(S, 5)
    B = len(plist)
    cat = dict(generator=gen, device="cuda")
    kc = torch.randint(-127, 128, (L, B, hkv, S, d), dtype=torch.int8, **cat)
    vc = torch.randint(-127, 128, (L, B, hkv, S, d), dtype=torch.int8, **cat)
    ks = (torch.rand((L, B, hkv, S), **cat) * 0.02 + 1e-3).to(torch.bfloat16)
    vs = (torch.rand((L, B, hkv, S), **cat) * 0.02 + 1e-3).to(torch.bfloat16)
    q = torch.randn((B, hq, d), **cat).to(torch.bfloat16)
    cur = [torch.randint(-127, 128, (B, hkv, 1, d), dtype=torch.int8, **cat),
           (torch.rand((B, hkv, 1), **cat) * 0.02 + 1e-3).to(torch.bfloat16),
           torch.randint(-127, 128, (B, hkv, 1, d), dtype=torch.int8, **cat),
           (torch.rand((B, hkv, 1), **cat) * 0.02 + 1e-3).to(torch.bfloat16)]
    pos = torch.tensor(plist, dtype=torch.int32, device="cuda")
    kc0, vc0 = kc.clone(), vc.clone()
    qm = torch.randn((B, 5, hq, d), **cat).to(torch.bfloat16)
    before = a8.int8_decode_attention_stacked.launches
    multi = a8.int8_decode_attention_stacked(qm, kc, ks, vc, vs, 1, pos)
    assert a8.int8_decode_attention_stacked.launches == before + 1
    mref = a8.int8_decode_attention_stacked_plain(qm, kc, ks, vc, vs, 1, pos)
    torch.cuda.synchronize()
    assert multi.shape == (B, 5, hq, d)
    assert float((multi - mref).abs().max() / mref.abs().max()) <= 1e-3
    for i in range(5):
        single = a8.int8_decode_attention_stacked(
            qm[:, i].contiguous(), kc, ks, vc, vs, 1, pos + i)
        torch.cuda.synchronize()
        assert float((multi[:, i] - single).abs().max()
                     / single.abs().max()) <= 1e-3
    for i in range(5):
        p = torch.clamp(pos + i, max=S - 1)
        got = a8.int8_decode_attention_stacked(q, kc, ks, vc, vs, 1, p)
        ref = a8.int8_decode_attention_stacked_plain(q, kc, ks, vc, vs, 1, p)
        one = a8.int8_decode_attention(q, kc[0], ks[0], vc[0], vs[0], p)
        ref1 = a8.int8_decode_attention_stacked_plain(q, kc, ks, vc, vs, 0,
                                                      p)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-3
        assert float((one - ref1).abs().max() / ref1.abs().max()) <= 1e-3
    got = a8.int8_decode_attention_cur_folded(q, kc, ks, vc, vs, *cur, 1,
                                              pos)
    ref = a8.int8_decode_attention_cur_folded_plain(q, kc, ks, vc, vs, *cur,
                                                    1, pos)
    one = a8.int8_decode_attention_cur(q, kc[1], ks[1], vc[1], vs[1], *cur,
                                       pos)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-3
    assert torch.equal(one, got)
    assert torch.equal(kc, kc0) and torch.equal(vc, vc0)


# the test shapes, llama2_7b o_proj (N = 4096) and down_proj (K = 11008,
# NBP 176: 11 k-tiles)
@pytest.mark.parametrize("o,k", [(320, 1088), (1024, 4096), (4096, 4096),
                                 (4096, 11008)])
def test_dequant_int8_kernel_matches_plain(gen, o, k):
    """K5's bound and codes equal the plain version's bit for bit (each
    operation rounded once: --fmad=false, IEEE division), and
    mxq_matmul_prefill_a8 through K5 equals it through the plain version."""
    p = _pack(gen, o, k)
    before = mm.dequant_int8_planes.launches
    sw, q = mm.dequant_int8_planes(p)
    assert mm.dequant_int8_planes.launches == before + 1
    rsw, rq = mm.dequant_int8_planes_plain(p)
    torch.cuda.synchronize()
    assert torch.equal(sw, rsw) and torch.equal(q, rq)
    x = torch.randn((512, k), generator=gen, device="cuda")
    y = mm.mxq_matmul_prefill_a8(x, p)
    saved = mm.dequant_int8_planes
    mm.dequant_int8_planes = mm.dequant_int8_planes_plain
    try:
        ref = mm.mxq_matmul_prefill_a8(x, p)
    finally:
        mm.dequant_int8_planes = saved
    torch.cuda.synchronize()
    assert float((y - ref).abs().max() / ref.abs().max()) <= 5e-3


@pytest.mark.parametrize("b", [1, 2, 8, 13, 16, 17, 64, 130, 2048])
@pytest.mark.parametrize("o,k", [(320, 1088), (1024, 4096)])
@pytest.mark.parametrize("nbits", [4, 2])
def test_uniform_kernels_match_plain(gen, nbits, b, o, k):
    """K7 (4-bit) and K8 (2-bit) against bf16(x) @ dequant, at the edges of
    the kernel's row tiles (16, 64, 128 rows) and the 2048-row prefill
    bucket."""
    w = torch.randn((o, k), generator=gen, device="cuda") / math.sqrt(k)
    p = (u4.quantize_pack_u4 if nbits == 4 else u4.quantize_pack_u2)(w)
    x = torch.randn((b, k), generator=gen, device="cuda").to(torch.bfloat16)
    fn = u4.u4_gemv if nbits == 4 else u4.u2_gemv
    y = fn(x, p)
    ref = u4.uniform_matmul_plain(x, p)
    torch.cuda.synchronize()
    assert y.shape == (b, o)
    assert float((y - ref).abs().max() / ref.abs().max()) <= 1e-4


def test_uniform_tiles_as_built(gen):
    """The tiles the built K7/K8 library reports are the table the CPU
    tests of the tile rule and the K split use
    (tests/test_torch_uniform4.py UNIFORM_TILES), and every B up to the
    last tile takes at most two row blocks of its tile."""
    tiles = u4._tiles()
    assert tiles == ((8, 128), (32, 64), (128, 128))
    for b in range(1, 257):
        t = u4._tile(b)
        assert b <= 2 * tiles[t][0] or t == len(tiles) - 1


@pytest.mark.parametrize("g,t", [(8, 9), (1, 65), (64, 2)])
def test_k4a_verify_beyond_64_query_rows(gen, g, t):
    """K4a with G * T > 64 query rows per kv head (llama2_70b's G = 8 at a
    verify of 9 tokens): one launch per chunk of floor(64 / G) tokens,
    within the K4 family's 1e-5 of the plain version, cache untouched."""
    L, S, hkv, d = 2, 300, 2, 128
    plist = _edge_positions(S, t)
    B = len(plist)
    cat = dict(generator=gen, device="cuda")
    kc = torch.randint(-127, 128, (L, B, hkv, S, d), dtype=torch.int8, **cat)
    vc = torch.randint(-127, 128, (L, B, hkv, S, d), dtype=torch.int8, **cat)
    ks = (torch.rand((L, B, hkv, S), **cat) * 0.02 + 1e-3).to(torch.bfloat16)
    vs = (torch.rand((L, B, hkv, S), **cat) * 0.02 + 1e-3).to(torch.bfloat16)
    pos = torch.tensor(plist, dtype=torch.int32, device="cuda")
    q = torch.randn((B, t, g * hkv, d), **cat).to(torch.bfloat16)
    kc0, vc0 = kc.clone(), vc.clone()
    before = a8.int8_decode_attention_stacked.launches
    got = a8.int8_decode_attention_stacked(q, kc, ks, vc, vs, 1, pos)
    launched = a8.int8_decode_attention_stacked.launches - before
    ref = a8.int8_decode_attention_stacked_plain(q, kc, ks, vc, vs, 1, pos)
    torch.cuda.synchronize()
    assert launched == len(a8.launch_plan(g, t)) == -(-t // (64 // g))
    assert got.shape == (B, t, g * hkv, d)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5
    assert torch.equal(kc, kc0) and torch.equal(vc, vc0)


@pytest.mark.parametrize("d", [64, 512])
@pytest.mark.parametrize("hq", [71, 128])
def test_int8_past_64_heads_match_plain(gen, hq, d):
    """The int8 family past 64 query heads per kv head (Falcon-7B's 71
    over one, and 128), at D = 64 (the templates) and 512 (the wide path):
    K4 (one launch per head group: 36 + 35 at 71, 64 + 64 at 128; the
    first writes the current row), K4a as a 5-token verify (one launch
    per token and head group) and K11 on the paged pool, each within 1e-3
    of its plain version with the written bytes equal and no other byte
    changed, its launches counted per ``launch_plan``."""
    cat = dict(generator=gen, device="cuda")
    hkv, s, b = 1, 300, 3
    ng = len(a8.launch_plan(hq, 1))
    codes = lambda *sh: torch.randint(-127, 128, sh, dtype=torch.int8,  # noqa
                                      **cat)
    scales = lambda *sh: (torch.rand(sh, **cat) * 0.02  # noqa: E731
                          + 1e-3).to(torch.bfloat16)
    kc, vc = codes(2, b, hkv, s, d), codes(2, b, hkv, s, d)
    ks, vs = scales(2, b, hkv, s), scales(2, b, hkv, s)
    cur = [codes(b, hkv, 1, d), scales(b, hkv, 1), codes(b, hkv, 1, d),
           scales(b, hkv, 1)]
    q = torch.randn((b, hq, d), **cat).to(torch.bfloat16)
    pos = torch.tensor([0, 129, 290], dtype=torch.int32, device="cuda")
    mine, theirs = (kc.clone(), vc.clone()), (kc.clone(), vc.clone())
    before = a8.int8_decode_attention_fused_write.launches
    ctx = a8.int8_decode_attention_fused_write(
        q, mine[0], ks, mine[1], vs, *cur, 1, pos)[0]
    assert a8.int8_decode_attention_fused_write.launches == before + ng
    ref = a8.int8_decode_attention_fused_write_plain(
        q, theirs[0], ks, theirs[1], vs, *cur, 1, pos)[0]
    torch.cuda.synchronize()
    assert float((ctx - ref).abs().max() / ref.abs().max()) <= 1e-3
    assert all(torch.equal(x, y) for x, y in zip(mine, theirs))
    qv = torch.randn((b, 5, hq, d), **cat).to(torch.bfloat16)
    before = a8.int8_decode_attention_stacked.launches
    got = a8.int8_decode_attention_stacked(qv, kc, ks, vc, vs, 0,
                                           pos.clamp(max=s - 5))
    assert a8.int8_decode_attention_stacked.launches == before + 5 * ng
    ref = a8.int8_decode_attention_stacked_plain(qv, kc, ks, vc, vs, 0,
                                                 pos.clamp(max=s - 5))
    torch.cuda.synchronize()
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-3
    pk = _paged_inputs(gen, [0, 129, 290], hkv, hq, d, 3, 10)
    pool = [pk[n] for n in ("k_pages", "k_scales", "v_pages", "v_scales")]
    pcur = [pk[n] for n in ("kcur", "kscur", "vcur", "vscur")]
    mine, theirs = [x.clone() for x in pool], [x.clone() for x in pool]
    before = a8.int8_paged_decode_attend_update.launches
    ctx = a8.int8_paged_decode_attend_update(pk["q"], *mine, *pcur, pos,
                                             pk["tables"])[0]
    assert a8.int8_paged_decode_attend_update.launches == before + ng
    ref = a8.int8_paged_decode_attend_update_plain(pk["q"], *theirs, *pcur,
                                                   pos, pk["tables"])[0]
    torch.cuda.synchronize()
    assert float((ctx - ref).abs().max() / ref.abs().max()) <= 1e-3
    for x, y in zip(mine, theirs):               # bytes: the NaNs compare
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))


def _paged_inputs(gen, pos, hkv, g, d, pps, lp):
    """Pools of ``lp`` pages, and tables holding shuffled pages up to each
    position's page and the null page 0 after it."""
    b = len(pos)
    cat = dict(generator=gen, device="cuda")
    ps = a8.PAGE_INT8
    pages = lambda: torch.randint(-127, 128, (hkv, lp, ps, d),  # noqa: E731
                                  dtype=torch.int8, **cat)
    scales = lambda *s: (torch.rand(s, **cat) * 0.02  # noqa: E731
                         + 1e-3).to(torch.bfloat16)
    ks, vs = scales(hkv, lp, 1, ps), scales(hkv, lp, 1, ps)
    ks[:, 0] = vs[:, 0] = float("nan")         # the null page is never read
    perm = torch.randperm(lp - 1, generator=gen, device="cuda")[:b * pps] + 1
    tables = perm.reshape(b, pps).to(torch.int32)
    for i, p in enumerate(pos):
        tables[i, p // ps + 1:] = 0
    return dict(q=torch.randn((b, hkv * g, d), **cat).to(torch.bfloat16),
                k_pages=pages(), k_scales=ks, v_pages=pages(), v_scales=vs,
                kcur=torch.randint(-127, 128, (b, hkv, d), dtype=torch.int8,
                                   **cat),
                kscur=scales(b, hkv),
                vcur=torch.randint(-127, 128, (b, hkv, d), dtype=torch.int8,
                                   **cat),
                vscur=scales(b, hkv),
                tables=tables.contiguous())


@pytest.mark.parametrize("pps", [3, 32])
@pytest.mark.parametrize("g,d", [(1, 64), (4, 128), (8, 128), (4, 80),
                                 (2, 100), (1, 99), (8, 256)]
                         + [(hq // hkv, d) for hq, hkv, d in INT8_WIDE])
def test_paged_kernels_match_plain(gen, g, d, pps):
    """K9, K10 and K11 against their plain versions, shuffled tables, a
    NaN null page, histories up to 4096 rows cut at page edges (last pages
    with one valid row: positions 129 and 257 attend one row of their
    page); K11's written rows bit-exact, no other byte changed; head_dims
    80, 100 and 99 read in place at the next template, 256 at its own."""
    hkv = 2
    ps = a8.PAGE_INT8
    plist = [0, 1, 127, 128, 129, 257, 300, pps * ps - 1]
    t = _paged_inputs(gen, plist, hkv, g, d, pps, 1 + len(plist) * pps)
    pos = torch.tensor(plist, dtype=torch.int32, device="cuda")
    pool = [t[k] for k in ("k_pages", "k_scales", "v_pages", "v_scales")]
    cur = [t[k] for k in ("kcur", "kscur", "vcur", "vscur")]
    for fn, plain, args in (
            (a8.int8_paged_decode_attention,
             a8.int8_paged_decode_attention_plain, [pos + 1]),
            (a8.int8_paged_decode_attention_cur,
             a8.int8_paged_decode_attention_cur_plain, cur + [pos])):
        got = fn(t["q"], *pool, *args, t["tables"])
        ref = plain(t["q"], *pool, *args, t["tables"])
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-3
    mine = [p.clone() for p in pool]
    theirs = [p.clone() for p in pool]
    ctx = a8.int8_paged_decode_attend_update(t["q"], *mine, *cur, pos,
                                             t["tables"])[0]
    ref = a8.int8_paged_decode_attend_update_plain(t["q"], *theirs, *cur,
                                                   pos, t["tables"])[0]
    torch.cuda.synchronize()
    assert float((ctx - ref).abs().max() / ref.abs().max()) <= 1e-3
    for a, b in zip(mine, theirs):               # bytes: the NaNs compare
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    changed = sum(int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
                  for a, b in zip(mine, pool))
    assert changed <= 2 * len(plist) * hkv * (d + 2)   # the written rows


def _k12_pool(gen, lens, hkv, g, d, ps, pps, q_dtype):
    """K12's inputs: shuffled tables with the null page 0 past each
    length; pages with NaN in the null page and past each length in its
    last live page (what the kernel reads), the same pages with zeros
    there (what the plain version, which gathers every page, reads)."""
    b, lp = len(lens), 1 + len(lens) * pps
    cat = dict(generator=gen, device="cuda")
    kz = torch.randn((hkv, lp, ps, d), **cat).to(torch.bfloat16)
    vz = torch.randn((hkv, lp, ps, d), **cat).to(torch.bfloat16)
    tables = (torch.randperm(lp - 1, **cat)[:b * pps] + 1).reshape(
        b, pps).to(torch.int32)
    for i, n in enumerate(lens):
        tables[i, -(-n // ps):] = 0
    kp, vp = kz.clone(), vz.clone()
    kp[:, 0] = vp[:, 0] = float("nan")
    kz[:, 0] = vz[:, 0] = 0
    for i, n in enumerate(lens):
        if 0 < n < pps * ps and n % ps:
            last = int(tables[i, n // ps])
            kp[:, last, n % ps:] = vp[:, last, n % ps:] = float("nan")
            kz[:, last, n % ps:] = vz[:, last, n % ps:] = 0
    q = torch.randn((b, hkv * g, d), **cat).to(q_dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, (kp, vp), (kz, vz), lengths, tables


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ps,pps", [(64, 3), (64, 32), (16, 9)])
@pytest.mark.parametrize("g,d,hkv", [(1, 64, 2), (4, 128, 2), (8, 128, 2),
                                     (8, 128, 8), (4, 96, 2), (32, 128, 2),
                                     (4, 100, 2), (2, 98, 2), (1, 99, 2),
                                     (8, 256, 1), (4, 160, 2), (16, 256, 2),
                                     (2, 256, 2), (1, 384, 2), (4, 384, 2),
                                     (8, 384, 1), (1, 512, 2), (4, 512, 2),
                                     (8, 512, 2), (16, 300, 1)])
def test_k12_matches_plain(gen, g, d, hkv, ps, pps, q_dtype):
    """K12 against its plain version: shuffled tables, lengths cut at page,
    tile and split edges (1, 63-65, 127-129, 255-257, the whole table);
    the kernel reads
    a pool with NaN in the null page and past each length in its last
    live page, the plain version (which gathers every page) the same pool
    with zeros there. float32 q: <= 1e-5 of max|ctx| (summation order);
    bf16 q: <= 1e-2 (the output's rounding). Two calls give the same
    bits. D = 96 and 100, 98 and 99 run at 128, the kernel reading the
    pages in place by bulk copies a row, and by copies of 8, 4 and 2
    bytes; G = 32 as two launches of 16 query heads per kv head;
    llama2_70b's heads at (8, 128) with 8 kv heads; D = 256 (Gemma-2B's
    G = 8 over one kv head, and G = 16 as two launches of 8) and 160
    (at 256, read in place); D = 384, 512 and 300 on the wide path (G = 1,
    4 and 8; 16 as two launches of 8; 300 read one element at a time)."""
    lens = [n for n in (1, 63, 64, 65, 127, 128, 129, 255, 256, 257,
                        pps * ps) if n <= pps * ps]
    q, nan, zero, lengths, tables = _k12_pool(gen, lens, hkv, g, d, ps,
                                              pps, q_dtype)
    before = ab.paged_decode_attention.launches
    got = ab.paged_decode_attention(q, *nan, lengths, tables)
    ref = ab.paged_decode_attention_plain(q, *zero, lengths, tables)
    again = ab.paged_decode_attention(q, *nan, lengths, tables)
    torch.cuda.synchronize()
    per = ab.heads_per_launch(ab.kernel_head_dim(d))
    assert ab.paged_decode_attention.launches == before + 2 * -(-g // per)
    assert got.dtype == q_dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    tol = 1e-5 if q_dtype == torch.float32 else 1e-2
    assert float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max()) <= tol


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g", [1, 2])
def test_k12_past_32768_matches_plain(gen, g, q_dtype):
    """K12 at D = 32832, past the q its wide path stages in shared memory:
    one query head a launch, q read in place, against its plain version
    (lengths 1, 63, 65 and 300 over pages of 64 rows, NaN past each
    length) at test_k12_matches_plain's gates; two calls equal."""
    d, lens = 32832, [1, 63, 65, 300]
    q, nan, zero, lengths, tables = _k12_pool(gen, lens, 1, g, d, 64, 5,
                                              q_dtype)
    before = ab.paged_decode_attention.launches
    got = ab.paged_decode_attention(q, *nan, lengths, tables)
    assert ab.paged_decode_attention.launches == before + g
    again = ab.paged_decode_attention(q, *nan, lengths, tables)
    ref = ab.paged_decode_attention_plain(q, *zero, lengths, tables)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and torch.equal(got, again)
    tol = 1e-5 if q_dtype == torch.float32 else 1e-2
    assert float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max()) <= tol


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g,d", [(1, 128), (8, 128), (4, 64), (2, 96),
                                 (8, 256), (4, 512)])
def test_k12_row_bits_independent_of_batch(gen, g, d, q_dtype):
    """A row of 300 rows (two splits, a cut tile) gives the same bits
    alone as row 3 of a batch of other lengths (1, 129, 2000, 64, 2047,
    1000, 5) over the same pages, whose work spreads over every block of
    the grid; a batch row of length 0 gives zeros."""
    ps, pps = 64, 32
    lens = [1, 129, 2000, 300, 64, 2047, 1000, 5]
    q, nan, _, lengths, tables = _k12_pool(gen, lens, 2, g, d, ps, pps,
                                           q_dtype)
    inside = ab.paged_decode_attention(q, *nan, lengths, tables)
    alone = ab.paged_decode_attention(q[3:4].clone(), *nan, lengths[3:4],
                                      tables[3:4].clone())
    lengths[0] = 0
    zeroed = ab.paged_decode_attention(q, *nan, lengths, tables)
    torch.cuda.synchronize()
    assert torch.equal(alone[0], inside[3])
    assert torch.equal(zeroed[1:], inside[1:])
    assert not bool(zeroed[0].any())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 128, 129, 200, 255, 257,
                               513, 1000])
@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 64), (8, 8, 128), (16, 2, 128),
                                      (8, 2, 80), (4, 4, 96), (8, 1, 256),
                                      (4, 2, 192), (4, 4, 100), (2, 2, 98),
                                      (1, 1, 99)])
def test_k13_matches_plain(gen, hq, hkv, d, t, dtype):
    """K13 against its plain version, with q, k, v as the fused qkv
    projection's strided slices and k, v 7 rows longer than q (a cache
    whose rows past T are never read): bf16 <= 2e-2 of max|ctx| (the
    probabilities rounded to bf16 against the running max, the plain
    version's after normalizing), float32 <= 1e-4 (bf16 hi + lo split
    products); the same bits on a second call. T straddles the 128-row
    items, the bf16 kernel's 128-key tiles and the float32 kernel's 64-key
    ones; D = 80, 96, 98, 99 and 100 run at 128, 192 at 256, zeros past D
    in the tiles (bf16 rows read in place by TMA at 80, 96 and 192, by
    cp.async of 8 bytes at 100 and of 4 at 98, zero-padded copies at 99;
    float32 on the split pass's planes), the context written at width D;
    G = 8 at (16, 2) and at Gemma-2B's (8, 1, 256), whose tiles are 64
    keys (bf16) and 32 (float32)."""
    b = 2
    qkv = torch.randn((b, t + 7, (hq + 2 * hkv) * d), generator=gen,
                      device="cuda").to(dtype)
    q = qkv[:, :t, :hq * d].reshape(b, t, hq, d)
    k = qkv[..., hq * d:(hq + hkv) * d].reshape(b, t + 7, hkv, d)
    v = qkv[..., (hq + hkv) * d:].reshape(b, t + 7, hkv, d)
    before = ab.flash_prefill_attention.launches
    got = ab.flash_prefill_attention(q, k, v)
    again = ab.flash_prefill_attention(q, k, v)
    ref = ab.flash_prefill_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert ab.flash_prefill_attention.launches == before + 2
    assert got.dtype == dtype and got.shape == (b, t, hq, d)
    assert torch.equal(got, again)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [1, 63, 65, 100, 128, 129, 257, 1000])
@pytest.mark.parametrize("d", [128, 80, 384])
def test_k13_reads_no_row_past_t(gen, d, t, dtype):
    """K13 over k, v whose rows past T are NaN gives the bits it gives
    with zeros there, all finite: no key row >= T is read (the tensor
    maps end at T, so TMA fills the tail with zeros; at float32 the split
    pass splits the first T rows only)."""
    q, k, v = _qkv(gen, 2, t, 16, 2, d, dtype)
    kn, vn, kz, vz = k.clone(), v.clone(), k.clone(), v.clone()
    kn[:, t:] = vn[:, t:] = float("nan")
    kz[:, t:] = vz[:, t:] = 0
    got = ab.flash_prefill_attention(q, kn, vn)
    ref = ab.flash_prefill_attention(q, kz, vz)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, ref)


def _qkv(gen, b, t, hq, hkv, d, dtype):
    """q, k, v as the fused qkv projection's strided slices, k and v 7
    rows longer than q (a cache whose rows past T are never read)."""
    qkv = torch.randn((b, t + 7, (hq + 2 * hkv) * d), generator=gen,
                      device="cuda").to(dtype)
    return (qkv[:, :t, :hq * d].reshape(b, t, hq, d),
            qkv[..., hq * d:(hq + hkv) * d].reshape(b, t + 7, hkv, d),
            qkv[..., (hq + hkv) * d:].reshape(b, t + 7, hkv, d))


def _grad_errs(got, ref):
    """Each gradient's max |got - ref| over its max |ref|. With one key
    (T = 1) dQ and dK are zero in exact arithmetic (p = 1 and o = v, so
    dS = p (dP - di) = 0) and their max is rounding noise: there they are
    measured over max|dV| (= max|dO|) instead."""
    scale = [float(r.float().abs().max()) for r in ref]
    if ref[0].shape[1] == 1:
        scale[0] = scale[1] = scale[2]
    return [float((g.float() - r.float()).abs().max()) / m
            for g, r, m in zip(got, ref, scale)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 128, 129, 200, 255, 257,
                               513, 1000, 1025])
@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 64), (8, 8, 128), (16, 2, 128),
                                      (8, 2, 80), (4, 4, 96), (8, 1, 256),
                                      (4, 2, 192), (4, 4, 100), (2, 2, 98),
                                      (1, 1, 99), (8, 2, 256), (2, 1, 250)])
def test_k13_bwd_matches_plain(gen, hq, hkv, d, t, dtype):
    """K13-bwd against its plain version on the same lse (K13's), q, k, v
    the fused projection's strided slices and dO a transposed view: each
    gradient within 2e-2 of its max at bf16 (P and dS rounded to bf16 as
    upstream does, from exp(s - lse) recomputed in another order), 1e-4 at
    float32 (the split products, K13-f32's gate); the same bits on a
    second call, one launch counted per call, dK and dV zero past row T.
    T straddles the 128-row items and the ring's tiles (bf16 64 rows,
    float32 32); D = 80, 96, 98, 99 and 100 run at 128 (bf16 read in
    place as K13 reads it, dO first copied into contiguous rows; float32
    on the split pass's planes), 192 and 250 at 256, whose items are 64
    rows, its ring's tiles 64 rows (bf16) and 16 (float32); the gradients
    written at width D. At bf16 and the 256 template T = 1025 gives the
    dK/dV items an odd number of key tiles, paired with split heads
    (Hq 8 over 1 or 2 kv heads: 4 or 2 splits, see
    test_k13_bwd_d256_plan_is_the_cpu_tests'), and D = 250 is read by
    cp.async."""
    b = 2
    q, k, v = _qkv(gen, b, t, hq, hkv, d, dtype)
    do = torch.randn((b, hq, t, d), generator=gen, device="cuda").to(
        dtype).transpose(1, 2)
    o, lse = ab.flash_attention_forward(q, k, v)
    before = ab.flash_attention_backward.launches
    got = ab.flash_attention_backward(q, k, v, o, lse, do)
    again = ab.flash_attention_backward(q, k, v, o, lse, do)
    ref = ab.flash_attention_bwd_plain(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert ab.flash_attention_backward.launches == before + 2
    for g, a, r in zip(got, again, ref):
        assert g.dtype == dtype and g.shape == r.shape
        assert torch.equal(g, a) and bool(torch.isfinite(g).all())
    for g in got[1:]:
        assert not bool(g[:, t:].any())
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert max(_grad_errs(got, ref)) <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [96, 100])
def test_k13_neighbour_heads_nan_same_bits(gen, d, dtype):
    """K13 and K13-bwd read only their head's d columns: with every head
    but one of the fused qkv row NaN (q, k and v; o and dO too for the
    backward), that head's context, dQ, dK and dV are finite and the bits
    a run with zeros there gives (D = 96 read by TMA, 100 by cp.async,
    both at the 128 template: a tile's columns past D are zeros, never a
    neighbour's values)."""
    b, t, h, keep = 2, 200, 4, 1
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda").to(
        dtype)
    do = torch.randn((b, t, h, d), generator=gen, device="cuda").to(dtype)
    others = [i for i in range(h) if i != keep]

    def run(fill):
        x = qkv.clone()
        x.view(b, t, 3, h, d)[:, :, :, others] = fill
        q, k, v = (x[..., i * h * d:(i + 1) * h * d].view(b, t, h, d)
                   for i in range(3))
        ctx, lse = ab.flash_attention_forward(q, k, v)
        o, dof = ctx.clone(), do.clone()
        o[:, :, others] = dof[:, :, others] = fill
        grads = ab.flash_attention_backward(q, k, v, o, lse, dof)
        return [x[:, :, keep] for x in (ctx, *grads)]
    nan, zero = run(float("nan")), run(0.0)
    torch.cuda.synchronize()
    for a, z in zip(nan, zero):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, z)


@pytest.mark.parametrize("d,route", [(96, "tma"), (100, "cp_async")])
def test_k13_between_templates_makes_no_copy(gen, d, route):
    """K13 and K13-bwd at bf16 and D between the templates read q, k, v,
    o and dO in place and write the context and the gradients at width D:
    one call of each under torch.profiler (q, k, v the fused projection's
    slices, k and v longer than T) runs no pad and no copy, on the host
    or the card, only the kernels (and the zeroing of dK's and dV's rows
    past T)."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v = _qkv(gen, 1, 256, 4, 4, d, torch.bfloat16)
    do = torch.randn((1, 256, 4, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    assert ab.load_route(d, (q, k, v)) == route
    o, lse = ab.flash_attention_forward(q, k, v)
    assert ab.load_route(d, (q, k, v, o, do)) == route
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ab.flash_prefill_attention(q, k, v)
        ab.flash_attention_forward(q, k, v)
        ab.flash_attention_backward(q, k, v, o, lse, do)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert any("flash_wgmma_kernel" in n for n in names)
    assert any("dkv_wgmma_kernel" in n for n in names)
    assert not [n for n in names if "pad" in n or "copy" in n], names


def _split_heads_case(gen, dtype):
    """llama2_70b's G = 8 at T = 512: 4 key tiles x 8 kv heads give the
    dK/dV kernel fewer items than the card has SMs, so each kv head's
    query heads are split over blocks (the library reports the split, the
    same at both types)."""
    import ctypes

    from mxq_tpu_torch import _build
    sizes = (ctypes.c_longlong * 4)()
    assert _build.load("flash_attn_bwd").flash_attn_bwd_scratch(
        1, 512, 64, 8, 128, int(dtype == torch.float32), sizes) == 0
    assert sizes[2] > 1
    q, k, v = _qkv(gen, 1, 512, 64, 8, 128, dtype)
    do = torch.randn((1, 512, 64, 128), generator=gen, device="cuda").to(
        dtype)
    o, lse = ab.flash_attention_forward(q, k, v)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k13_bwd_split_heads_matches_plain(gen, dtype):
    """K13-bwd on the split-and-sum path (G = 8, T = 512) against its
    plain version, each gradient within the gate of
    test_k13_bwd_matches_plain (bf16 2e-2, float32 1e-4) of its max,
    finite, dK and dV zero past row T."""
    args = _split_heads_case(gen, dtype)
    got = ab.flash_attention_backward(*args)
    ref = ab.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.shape == r.shape and bool(torch.isfinite(g).all())
    for g in got[1:]:
        assert not bool(g[:, 512:].any())
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert max(_grad_errs(got, ref)) <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k13_bwd_split_heads_same_bits(gen, dtype):
    """Three calls on the split-and-sum path give the same bits: the last
    block of each key tile sums the partials in split order, whichever
    block finishes last, and leaves its ticket at 0 for the next call."""
    args = _split_heads_case(gen, dtype)
    first = ab.flash_attention_backward(*args)
    for _ in range(2):
        again = ab.flash_attention_backward(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_k13_bwd_d256_plan_is_the_cpu_tests(gen):
    """The dK/dV plan the library picks at bf16 and the 256 template on
    this card (``flash_attn_bwd_scratch``: splits out[2], pairs out[3]) is
    ``flash_bwd_plan.bwd_plan_d256``'s, the plan the CPU tests emulate,
    with the scratch it sizes (lse and di, and the partials where heads
    are split),
    at Gemma-2B's widths (T = 2048: pairs and 8 splits; 512), the odd key
    tiles of T = 1025 and 16 kv heads; the float32 path pairs no key
    tiles."""
    import ctypes

    from flash_bwd_plan import bwd_plan_d256
    from mxq_tpu_torch import _build
    lib = _build.load("flash_attn_bwd")
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    sizes = (ctypes.c_longlong * 4)()
    for b, t, hq, hkv in [(1, 2048, 8, 1), (1, 512, 8, 1), (2, 1025, 8, 2),
                          (2, 1025, 8, 1), (1, 2048, 16, 16),
                          (1, 257, 8, 1)]:
        assert lib.flash_attn_bwd_scratch(b, t, hq, hkv, 256, 0, sizes) == 0
        pairs, splits = bwd_plan_d256(b, t, hq, hkv, sms)
        assert (bool(sizes[3]), sizes[2]) == (pairs, splits)
        tp = -(-t // 64) * 64
        parts = 2 * splits * b * hkv * tp * 256 if splits > 1 else 0
        assert sizes[0] == 2 * b * hq * tp + parts
        assert lib.flash_attn_bwd_scratch(b, t, hq, hkv, 256, 1, sizes) == 0
        assert sizes[3] == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [1, 63, 65, 129, 513, 1000])
def test_k13_bwd_reads_no_row_past_t(gen, t, dtype):
    """K13-bwd over k, v whose rows past T are NaN gives the bits it gives
    with zeros there, all finite (dK and dV zero past T): no key row >= T
    is read, at G = 8 and D = 96 (float32: the split pass splits the first
    T rows only, zeros past D)."""
    q, k, v = _qkv(gen, 2, t, 16, 2, 96, dtype)
    do = torch.randn((2, t, 16, 96), generator=gen, device="cuda").to(dtype)
    kn, vn, kz, vz = k.clone(), v.clone(), k.clone(), v.clone()
    kn[:, t:] = vn[:, t:] = float("nan")
    kz[:, t:] = vz[:, t:] = 0
    o, lse = ab.flash_attention_forward(q, kz, vz)
    got = ab.flash_attention_backward(q, kn, vn, o, lse, do)
    ref = ab.flash_attention_backward(q, kz, vz, o, lse, do)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert bool(torch.isfinite(g).all()) and torch.equal(g, r)


def test_head_dim_past_256_refused(gen):
    """D = 384 on the card (the name is the test's from when the wrappers
    refused it): every attention wrapper (K4, K4a, K4b, K9, K10, K11,
    K12, K13, K13-bwd) launches its wide kernel once, counted on its own
    counter, and matches its plain version within its gate (int8 1e-3,
    K12 and K13 bf16 1e-2 and 2e-2)."""
    cat = dict(generator=gen, device="cuda")
    d, b, hkv, hq, s = 384, 2, 2, 4, 256
    q = torch.randn((b, hq, d), **cat).to(torch.bfloat16)
    codes = lambda *sh: torch.randint(-127, 128, sh, dtype=torch.int8,  # noqa
                                      **cat)
    scales = lambda *sh: (torch.rand(sh, **cat) * 0.02  # noqa: E731
                          + 1e-3).to(torch.bfloat16)
    kc, vc = codes(1, b, hkv, s, d), codes(1, b, hkv, s, d)
    ks, vs = scales(1, b, hkv, s), scales(1, b, hkv, s)
    cur = [codes(b, hkv, 1, d), scales(b, hkv, 1), codes(b, hkv, 1, d),
           scales(b, hkv, 1)]
    pos = torch.tensor([3, 200], dtype=torch.int32, device="cuda")
    pk = _paged_inputs(gen, [3, 200], hkv, hq // hkv, d, 2, 5)
    pool = [pk[n] for n in ("k_pages", "k_scales", "v_pages", "v_scales")]
    pcur = [pk[n] for n in ("kcur", "kscur", "vcur", "vscur")]
    bpages = torch.randn((hkv, 5, 16, d), **cat).to(torch.bfloat16)
    btables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32,
                           device="cuda")
    # q, k and v apart: with q = k the probabilities are nearly one-hot
    # and dQ, dK cancel to rounding noise
    qkv = _qkv(gen, 1, 128, 2, 2, d, torch.bfloat16)
    do = torch.randn((1, 128, 2, d), **cat).to(torch.bfloat16)
    o, lse = ab.flash_attention_forward_plain(*qkv)
    cases = [
        (a8.int8_decode_attention_fused_write, 1e-3, lambda f: f(
            q, kc.clone(), ks, vc.clone(), vs, *cur, 0, pos)[0],
         a8.int8_decode_attention_fused_write_plain),
        (a8.int8_decode_attention_stacked, 1e-3, lambda f: f(
            q, kc, ks, vc, vs, 0, pos),
         a8.int8_decode_attention_stacked_plain),
        (a8.int8_decode_attention_cur_folded, 1e-3, lambda f: f(
            q, kc, ks, vc, vs, *cur, 0, pos),
         a8.int8_decode_attention_cur_folded_plain),
        (a8.int8_paged_decode_attention, 1e-3, lambda f: f(
            pk["q"], *pool, pos + 1, pk["tables"]),
         a8.int8_paged_decode_attention_plain),
        (a8.int8_paged_decode_attention_cur, 1e-3, lambda f: f(
            pk["q"], *pool, *pcur, pos, pk["tables"]),
         a8.int8_paged_decode_attention_cur_plain),
        (a8.int8_paged_decode_attend_update, 1e-3, lambda f: f(
            pk["q"], *[t.clone() for t in pool], *pcur, pos,
            pk["tables"])[0],
         a8.int8_paged_decode_attend_update_plain),
        (ab.paged_decode_attention, 1e-2, lambda f: f(
            q, bpages, bpages, torch.tensor([5, 32], dtype=torch.int32,
                                            device="cuda"), btables),
         ab.paged_decode_attention_plain),
        (ab.flash_prefill_attention, 2e-2, lambda f: f(*qkv),
         ab.flash_prefill_attention_plain),
        (ab.flash_attention_backward, 2e-2, lambda f: f(*qkv, o, lse, do),
         ab.flash_attention_bwd_plain)]
    for fn, gate, call, plain in cases:
        before = fn.launches
        got = call(fn)
        assert fn.launches == before + 1, fn.__name__
        want = call(plain)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs = _grad_errs(got, want)
        assert max(errs) <= gate, (fn.__name__, errs)


@pytest.mark.parametrize("write", [False, True])
@pytest.mark.parametrize("hq,hkv,d", INT8_WIDE)
def test_int8_wide_same_bits(gen, hq, hkv, d, write):
    """The int8 wide path gives the same bits on a second call: K4 (the
    current row written) or K4b, K4a at a verify's 5 tokens, and K11 or
    K10 on the paged pool (the splits combined in order by the last
    block of each (batch, kv head), the chunks' partial contexts
    independent of which block ran when)."""
    cat = dict(generator=gen, device="cuda")
    s, b = 700, 3
    kc = torch.randint(-127, 128, (1, b, hkv, s, d), dtype=torch.int8, **cat)
    vc = torch.randint(-127, 128, (1, b, hkv, s, d), dtype=torch.int8, **cat)
    ks = (torch.rand((1, b, hkv, s), **cat) * 0.02 + 1e-3).to(torch.bfloat16)
    vs = (torch.rand((1, b, hkv, s), **cat) * 0.02 + 1e-3).to(torch.bfloat16)
    cur = [torch.randint(-127, 128, (b, hkv, 1, d), dtype=torch.int8, **cat),
           (torch.rand((b, hkv, 1), **cat) * 0.02 + 1e-3).to(torch.bfloat16),
           torch.randint(-127, 128, (b, hkv, 1, d), dtype=torch.int8, **cat),
           (torch.rand((b, hkv, 1), **cat) * 0.02 + 1e-3).to(torch.bfloat16)]
    q = torch.randn((b, hq, d), **cat).to(torch.bfloat16)
    qv = torch.randn((b, 5, hq, d), **cat).to(torch.bfloat16)
    pos = torch.tensor([0, 129, 690], dtype=torch.int32, device="cuda")
    pk = _paged_inputs(gen, [0, 129, 690], hkv, hq // hkv, d, 6, 19)
    pool = [pk[n] for n in ("k_pages", "k_scales", "v_pages", "v_scales")]
    pcur = [pk[n] for n in ("kcur", "kscur", "vcur", "vscur")]
    if write:
        dense = lambda: a8.int8_decode_attention_fused_write(  # noqa: E731
            q, kc.clone(), ks, vc.clone(), vs, *cur, 0, pos)[0]
        paged = lambda: a8.int8_paged_decode_attend_update(  # noqa: E731
            pk["q"], *[t.clone() for t in pool], *pcur, pos,
            pk["tables"])[0]
    else:
        dense = lambda: a8.int8_decode_attention_cur_folded(  # noqa: E731
            q, kc, ks, vc, vs, *cur, 0, pos)
        paged = lambda: a8.int8_paged_decode_attention_cur(  # noqa: E731
            pk["q"], *pool, *pcur, pos, pk["tables"])
    verify = lambda: a8.int8_decode_attention_stacked(  # noqa: E731
        qv, kc, ks, vc, vs, 0, pos.clamp(max=s - 5))
    for fn in (dense, paged, verify):
        first, again = fn(), fn()
        torch.cuda.synchronize()
        assert bool(torch.isfinite(first).all())
        assert torch.equal(first, again)


# K13 and K13-bwd's wide path: G = 1 and 4, T at the tiles' edges and
# llama2's 512 and 2048; clusters of 2 (300: a last range of 44 columns,
# bf16 rows read from copies padded to 304; 384, 512), 3 (640) and 4
# (1024) blocks, and in the forward 2304 (groups of 8 ranges and 1)
K13_WIDE = [(4, 4, 384), (8, 2, 384), (4, 4, 512), (8, 2, 512),
            (4, 4, 1024), (8, 2, 1024), (4, 2, 300), (8, 2, 300),
            (4, 4, 640), (8, 2, 640)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [1, 65, 200, 512, 2048])
@pytest.mark.parametrize("hq,hkv,d", K13_WIDE + [(4, 2, 2304)])
def test_k13_wide_matches_plain(gen, hq, hkv, d, t, dtype):
    """K13's wide path against its plain version on the fused qkv
    projection's strided slices (k, v 7 rows longer than q), at the gates
    of test_k13_matches_plain (bf16 2e-2, float32 1e-4); the same bits on
    a second call, one launch a call; its lse the plain version's within
    1e-4, and the context the bits it has without lse."""
    q, k, v = _qkv(gen, 1, t, hq, hkv, d, dtype)
    before = ab.flash_prefill_attention.launches
    got = ab.flash_prefill_attention(q, k, v)
    again = ab.flash_prefill_attention(q, k, v)
    out, lse = ab.flash_attention_forward(q, k, v)
    ref, ref_lse = ab.flash_attention_forward_plain(q, k, v)
    torch.cuda.synchronize()
    assert ab.flash_prefill_attention.launches == before + 3
    assert got.dtype == dtype and got.shape == (1, t, hq, d)
    assert torch.equal(got, again) and torch.equal(got, out)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max()) <= tol
    assert float((lse - ref_lse).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [1, 65, 200, 512, 2048])
@pytest.mark.parametrize("hq,hkv,d", K13_WIDE)
def test_k13_bwd_wide_matches_plain(gen, hq, hkv, d, t, dtype):
    """K13-bwd's wide path against its plain version on K13's lse, q, k,
    v strided slices and dO a transposed view, at the gates of
    test_k13_bwd_matches_plain (bf16 2e-2, float32 1e-4 of each
    gradient's max); the same bits on a second call, one launch a call,
    dK and dV zero past row T; and FlashAttention under autograd reaching
    it (one K13 and one K13-bwd launch)."""
    q, k, v = _qkv(gen, 1, t, hq, hkv, d, dtype)
    do = torch.randn((1, hq, t, d), generator=gen, device="cuda").to(
        dtype).transpose(1, 2)
    o, lse = ab.flash_attention_forward(q, k, v)
    before = ab.flash_attention_backward.launches
    got = ab.flash_attention_backward(q, k, v, o, lse, do)
    again = ab.flash_attention_backward(q, k, v, o, lse, do)
    ref = ab.flash_attention_bwd_plain(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert ab.flash_attention_backward.launches == before + 2
    for g, a, r in zip(got, again, ref):
        assert g.dtype == dtype and g.shape == r.shape
        assert torch.equal(g, a) and bool(torch.isfinite(g).all())
    for g in got[1:]:
        assert not bool(g[:, t:].any())
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert max(_grad_errs(got, ref)) <= tol
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    wrappers = (ab.flash_prefill_attention, ab.flash_attention_backward)
    counts = [f.launches for f in wrappers]
    grads = torch.autograd.grad(ab.FlashAttention.apply(*leaves), leaves,
                                do)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(wrappers, counts)] == [1, 1]
    assert all(torch.equal(g, r) for g, r in zip(grads, got))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [300, 512])
def test_k13_wide_batch_rows_same_bits_alone(gen, d, dtype):
    """K13 and K13-bwd's wide path over a batch of 3 (T = 200, 8 heads
    over 2 kv heads): within their gates of the plain versions, and each
    batch row's context, lse and gradients the same bits as that row
    alone (a cluster's item is one (rows, head, batch row))."""
    q, k, v = _qkv(gen, 3, 200, 8, 2, d, dtype)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    out, lse = ab.flash_attention_forward(q, k, v)
    grads = ab.flash_attention_backward(q, k, v, out, lse, do)
    ref, ref_lse = ab.flash_attention_forward_plain(q, k, v)
    gref = ab.flash_attention_bwd_plain(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((out.float() - ref.float()).abs().max()
                 / ref.float().abs().max()) <= tol
    assert max(_grad_errs(grads, gref)) <= tol
    for b in range(3):
        one = [x[b:b + 1].clone() for x in (q, k, v, do)]
        o1, l1 = ab.flash_attention_forward(*one[:3])
        g1 = ab.flash_attention_backward(*one[:3], out[b:b + 1].clone(),
                                         lse[b:b + 1].clone(), one[3])
        torch.cuda.synchronize()
        assert torch.equal(o1, out[b:b + 1]) and torch.equal(l1, lse[b:b + 1])
        assert all(torch.equal(x, y[b:b + 1]) for x, y in zip(g1, grads))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("copied", ["kv", "q_do"])
def test_k13_wide_column_groups_same_bits(gen, copied, dtype):
    """Past 2048 columns (D = 2304: a group of 8 ranges and one of 1) each
    column group's cluster computes S and dP itself, and block 0 of
    either group sums ranges 0 and 8. Where the operand an output's last
    256 columns are made from copies its first 256 (k and v: the context
    and dQ; q and dO: dK and dV) while the others differ there (so the
    two ranges' partial sums differ and their order shows), those
    columns equal the first 256's bits: every group holds the same S, dP,
    m and l. All within the gates of the plain versions (T = 200, 4
    heads over 2)."""
    d, t = 2304, 200
    q, k, v, do = (torch.randn((1, t, h, d), generator=gen, device="cuda")
                   .to(dtype) for h in (4, 2, 2, 4))
    same = (k, v) if copied == "kv" else (q, do)
    for x in same:
        x[..., 2048:] = x[..., :256]
    out, lse = ab.flash_attention_forward(q, k, v)
    grads = ab.flash_attention_backward(q, k, v, out, lse, do)
    ref, ref_lse = ab.flash_attention_forward_plain(q, k, v)
    gref = ab.flash_attention_bwd_plain(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((out.float() - ref.float()).abs().max()
                 / ref.float().abs().max()) <= tol
    assert float((lse - ref_lse).abs().max()) <= 1e-4
    assert max(_grad_errs(grads, gref)) <= tol
    for x in ((out, grads[0]) if copied == "kv" else grads[1:]):
        assert torch.equal(x[..., 2048:], x[..., :256])


@pytest.mark.parametrize("d", [1, 64, 80, 96, 98, 100, 128, 192, 255, 256])
def test_k13_split_pass_bit_equal(gen, d):
    """The float32 path's split pass against its plain version bit for
    bit (hi = bf16(x), lo = bf16(x - hi), zeros past D in the kernels'
    width), on q sliced from a fused qkv tensor 7 rows longer than q
    with values over six decades: 16-byte loads where D and the strides
    allow (D % 4 == 0), one float at a time otherwise (D = 1, 98)."""
    w = ab.kernel_head_dim(d)
    qkv = torch.randn((2, 84, 10 * d), generator=gen, device="cuda")
    qkv *= torch.exp(3 * torch.randn(qkv.shape, generator=gen,
                                     device="cuda"))
    q = qkv[:, :77, :6 * d].reshape(2, 77, 6, d)
    got = ab.flash_split(q, w)
    want = ab.flash_split_plain(q, w)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        assert g.shape == (2, 77, 6, w)
        assert torch.equal(g.view(torch.int16), r.view(torch.int16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [1, 65, 513])
def test_k13_lse_keeps_the_output(gen, t, dtype):
    """K13 writing its row log-sum-exp gives the output bits it gives
    without, and that lse is the plain version's within 1e-4 (the masked
    scores' logsumexp: values of a few units, f32 sums in another
    order)."""
    q, k, v = _qkv(gen, 2, t, 16, 2, 128, dtype)
    out, lse = ab.flash_attention_forward(q, k, v)
    plain = ab.flash_prefill_attention(q, k, v)
    _, ref = ab.flash_attention_forward_plain(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    assert lse.shape == (2, 16, t) and lse.dtype == torch.float32
    assert float((lse - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_autograd_equals_plain_backward(gen, dtype):
    """torch.autograd.grad through FlashAttention (K13 forward, K13-bwd
    backward) against the plain backward on the same lse, at the gates of
    test_k13_bwd_matches_plain; one K13 and one K13-bwd launch."""
    q, k, v = (x.detach().requires_grad_()
               for x in _qkv(gen, 2, 200, 16, 2, 128, dtype))
    do = torch.randn((2, 200, 16, 128), generator=gen, device="cuda").to(
        dtype)
    wrappers = (ab.flash_prefill_attention, ab.flash_attention_backward)
    before = [f.launches for f in wrappers]
    out = ab.FlashAttention.apply(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert [f.launches - n for f, n in zip(wrappers, before)] == [1, 1]
    o, lse = ab.flash_attention_forward(q.detach(), k.detach(), v.detach())
    ref = ab.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                       o, lse, do)
    torch.cuda.synchronize()
    assert torch.equal(out.detach(), o)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert max(_grad_errs(got, ref)) <= tol


@pytest.mark.parametrize("name", ["sym8", "sym4", "sym8_layerwise",
                                  "sym8_ref3d", "asym4", "mxq_qat", "mx1",
                                  "kv_int8", "act_int8"])
def test_fake_quants_on_the_card_equal_the_cpu(gen, name):
    """The QAT fake-quants (the training and eval-ppl forward's
    ``w_bits``, ``a_bits`` and ``kv_bits``) and the int8 KV and activation
    quantizers on the card give the CPU's outputs bit for bit at (256,
    4096): every division by a constant is IEEE (a Python divisor made the
    card multiply by its reciprocal)."""
    from mxq_tpu_torch import scheme
    from mxq_tpu_torch.serving import kvcache

    fns = {"sym8": lambda x: scheme.sym_fake_quant(x, 8),
           "sym4": lambda x: scheme.sym_fake_quant(x, 4),
           "sym8_layerwise": lambda x: scheme.sym_fake_quant(
               x, 8, layerwise=True),
           "sym8_ref3d": lambda x: scheme.sym_fake_quant_ref3d(
               x.reshape(2, 128, 4096), 8),
           "asym4": lambda x: scheme.asym_fake_quant(x, 4),
           "mxq_qat": scheme.mxq_fake_quant_qat,
           "mx1": scheme.mx1_fake_quant_qat,
           "kv_int8": lambda x: kvcache.quantize_kv(x, 128),
           "act_int8": mm._act_quant_rows}
    x = torch.randn((256, 4096), generator=gen, device="cuda")
    card, host = fns[name](x), fns[name](x.cpu())
    if not isinstance(card, tuple):
        card, host = (card,), (host,)
    for c, h in zip(card, host):
        assert torch.equal(c.cpu(), h)


@pytest.fixture(scope="module")
def llama7b_2():
    """llama2_7b's widths at 2 layers, packed, random weights from seed 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import dataclasses

    from mxq_tpu_torch.models import llama
    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(),
                              num_hidden_layers=2)
    params = llama.quantize_params_packed(
        llama.init_params(cfg, 0, torch.bfloat16, "cuda"), cfg,
        device="cuda")
    return cfg, params


@pytest.fixture(scope="module")
def llama_d96_2():
    """llama2_7b's widths with hidden 3072 over its 32 heads (head_dim 96),
    2 layers, packed, random weights from seed 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import dataclasses

    from mxq_tpu_torch.models import llama
    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(),
                              num_hidden_layers=2, hidden_size=3072)
    assert cfg.head_dim == 96
    params = llama.quantize_params_packed(
        llama.init_params(cfg, 0, torch.bfloat16, "cuda"), cfg,
        device="cuda")
    return cfg, params


def test_paged_bf16_engine_at_head_dim_96(llama_d96_2, monkeypatch):
    """PagedEngine's bf16 pool at head_dim 96: every K12 launch reads the
    engine's own pages (their storage, 96 wide) and q at its width 96, so
    no copy of the pool or of q is made; the decode chunks replayed as CUDA
    graphs give the greedy tokens and K12 launches of the same run op by
    op."""
    import numpy as np

    from mxq_tpu_torch.serving import graphs, paged
    cfg, params = llama_d96_2
    seen = []
    launch = ab._paged_launch

    def spy(q, k_pages, v_pages, *rest):
        seen.append((k_pages.untyped_storage().data_ptr(),
                     v_pages.untyped_storage().data_ptr(),
                     k_pages.shape[-1], q.shape[-1]))
        return launch(q, k_pages, v_pages, *rest)
    monkeypatch.setattr(ab, "_paged_launch", spy)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
               for _ in range(6)]
    runs = {}
    for mode in ("graphs", "eager"):
        if mode == "eager":
            monkeypatch.setattr(graphs.ChunkRunner, "run",
                                graphs.ChunkRunner.eager)
        before = ab.paged_decode_attention.launches
        e = paged.PagedEngine(params, cfg, num_slots=4, total_pages=17,
                              page_size=64, max_len=256, kv_bits=32,
                              device="cuda")
        reqs = [e.submit(p, max_new_tokens=12) for p in prompts]
        e.run()
        torch.cuda.synchronize()
        pool = (e.pool.k_pages.untyped_storage().data_ptr(),
                e.pool.v_pages.untyped_storage().data_ptr())
        assert seen and all(x == (*pool, 96, 96) for x in seen)
        seen.clear()
        runs[mode] = ([list(map(int, r.generated)) for r in reqs],
                      ab.paged_decode_attention.launches - before)
    assert runs["graphs"] == runs["eager"] and runs["graphs"][1] > 0


def _drive(kind, cfg, params):
    """One engine of ``kind`` over six 40-token prompts (a 16-token
    pattern repeated for the speculative run): its tokens and its runner."""
    import numpy as np

    from mxq_tpu_torch.serving import engine as eng
    from mxq_tpu_torch.serving import paged, spec
    rng = np.random.default_rng(0)
    pattern = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    prompts = ([np.roll(np.tile(pattern, 3)[:40], i) for i in range(6)]
               if kind == "spec" else
               [rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
                for _ in range(6)])
    if kind == "paged":
        e = paged.PagedEngine(params, cfg, num_slots=4, total_pages=9,
                              max_len=256, kv_bits=8, device="cuda")
    elif kind == "paged_bf16":          # K12 inside the captured chunk
        e = paged.PagedEngine(params, cfg, num_slots=4, total_pages=17,
                              page_size=64, max_len=256, kv_bits=32,
                              device="cuda")
    else:
        e = eng.Engine(params, cfg, eng.EngineConfig(
            num_slots=1 if kind == "slot1" else 4, max_len=256,
            prefill_buckets=(128,)), device="cuda")
    reqs = [e.submit(p, max_new_tokens=12) for p in prompts]
    if kind == "spec":
        spec.run_spec_pipelined(e, auto_disable=False)
    else:
        e.run()
    torch.cuda.synchronize()
    return [list(map(int, r.generated)) for r in reqs], e._graphs


@pytest.mark.parametrize("kind", ["slot4", "slot1", "paged", "spec",
                                  "paged_bf16"])
def test_replayed_chunks_equal_eager(llama7b_2, kind, monkeypatch):
    """The engines' decode chunks replayed as CUDA graphs give the greedy
    tokens and the kernel launches of the same run made op by op (the
    runner's eager path), at llama2_7b's widths and 2 layers."""
    from mxq_tpu_torch.serving import graphs
    runs = {}
    for mode in ("graphs", "eager"):
        if mode == "eager":
            monkeypatch.setattr(graphs.ChunkRunner, "run",
                                graphs.ChunkRunner.eager)
        for f in graphs.kernel_wrappers():
            f.launches = 0
        tokens, runner = _drive(kind, *llama7b_2)
        runs[mode] = (tokens, [f.launches for f in graphs.kernel_wrappers()],
                      dict(runner.replays))
    (tokens, launches, replays), (want, want_launches, _) = (
        runs["graphs"], runs["eager"])
    assert tokens == want
    assert launches == want_launches and sum(launches) > 0
    assert replays and all(n > 0 for n in replays.values())
    if kind == "paged_bf16":
        k12 = graphs.kernel_wrappers().index(ab.paged_decode_attention)
        assert launches[k12] > 0
