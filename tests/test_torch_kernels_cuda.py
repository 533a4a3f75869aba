"""K1-K6, K4a-K4d, K7, K8 and K9-K11 on the card against their plain
PyTorch versions at small shapes (the one-row kernels also at
llama2_7b down's K of 11008, the attention kernels at histories of up to
4096 rows, cut at their 128-row split edges), and the quantizers on the
card against the CPU (the PTQ packer, the QAT fake-quants, the int8 KV
and activation quantizers). Needs a CUDA device and nvcc (marker
``cuda``); skips elsewhere. Run on the H100 with
``python -m pytest -m cuda tests/test_torch_kernels_cuda.py``;
``chip_smoke.py`` holds the same kernels at llama2_7b's shapes."""

import math

import pytest
import torch

from mxq_tpu_torch import packfmt
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


@pytest.mark.parametrize("s", [1, 96, 300, 4096])
@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 64), (8, 8, 128), (16, 2, 128)])
def test_attention_kernel_matches_plain(gen, hq, hkv, d, s):
    """K4 at histories of 1-4096 rows: ctx within 1e-3 of the plain version
    (expected ~1e-7: no rounding point moves), the written rows
    bit-exact, every other cache byte untouched."""
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
@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 64), (8, 8, 128), (16, 2, 128)])
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
    assert launched == len(a8.token_chunks(g, t)) == -(-t // (64 // g))
    assert got.shape == (B, t, g * hkv, d)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5
    assert torch.equal(kc, kc0) and torch.equal(vc, vc0)


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
@pytest.mark.parametrize("g,d", [(1, 64), (4, 128), (8, 128)])
def test_paged_kernels_match_plain(gen, g, d, pps):
    """K9, K10 and K11 against their plain versions, shuffled tables, a
    NaN null page, histories up to 4096 rows cut at page edges (last pages
    with one valid row: positions 129 and 257 attend one row of their
    page); K11's written rows bit-exact, no other byte changed."""
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
