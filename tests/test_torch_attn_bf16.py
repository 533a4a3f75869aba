"""K12 (bf16 paged decode attention) and K13 (causal attention from
position 0) on the CPU, where their wrappers take the plain versions,
against mxq_tpu from numpy seeds:

- K12's plain version against ``mxq_tpu.serving.paged._paged_attend_reference``
  over a folded bf16 pool of 64-row pages, tables shuffled with the null
  page past each length: with q in float32 within 1e-5 of max|ctx| (the
  f32 result before any bf16 cast: only summation order differs), with q
  in bf16 within one bf16 ulp of each element (the same f32 result, cast);
- K13's plain version inside the port's attention (``attn_impl="flash"``)
  against ``mxq_tpu.models.llama.attention``'s einsum path at the tiny
  preset, the contexts o_proj receives within 1e-5 of max|ctx| (f32
  weights: both sides compute in f32, summation order aside), and the
  port's packed forward against JAX's within 1e-2 of max|logit| (the gate
  of test_torch_llama.py: packed products round activations to bf16);
- ``_rows``, which decides which views K13's tensor maps read in place,
  and ``load_route``, how K13 and K13-bwd read bf16 rows between the
  templates (TMA, cp.async or zero-padded copies);
- on the CPU neither route launches a kernel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mxq_tpu.models import llama as jl
from mxq_tpu.serving import paged as jpg
from mxq_tpu_torch.models import llama as tl
from mxq_tpu_torch.ops import attn_bf16 as ab
from mxq_tpu_torch.serving import paged as tpg
from torch_port_helpers import port_params, rel, to_torch

BF = ml_dtypes.bfloat16
PS = 64                                  # bf16 pages (cli serve --kv_bits 32)
PPS = 4
LENGTHS = [1, 63, 64, 65, PPS * PS]      # full: every page of the table


def _pool(rng, hkv, g, d):
    """q [B, Hq, D] f32, pages [Hkv, LP, 64, D] bf16 (LP = 1 + B * PPS, the
    null page 0 first), lengths [B], shuffled physical tables with the null
    page past each length's last page."""
    b = len(LENGTHS)
    lp = 1 + b * PPS
    k = rng.standard_normal((hkv, lp, PS, d)).astype(np.float32).astype(BF)
    v = rng.standard_normal((hkv, lp, PS, d)).astype(np.float32).astype(BF)
    q = rng.standard_normal((b, hkv * g, d)).astype(np.float32)
    tables = (rng.permutation(lp - 1)[:b * PPS] + 1).reshape(b, PPS)
    for i, n in enumerate(LENGTHS):
        tables[i, -(-n // PS):] = 0
    return q, k, v, np.array(LENGTHS, np.int32), tables.astype(np.int32)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_k12_plain_matches_jax_reference_past_32768(q_dtype):
    """K12 past the q its wide path stages in shared memory (D = 32832 >
    WIDE_Q_FLOATS): one query head a launch, and its plain version
    against ``_paged_attend_reference`` (one head, two pages of 4 rows,
    lengths 3 and 8) within 1e-5 (float32 q) or, bf16 q, one bf16 ulp of
    max|ctx| (the two sum 32832 products in another order, and a context
    of a few rows can cancel to far below its largest element)."""
    d, ps = 32832, 4
    assert ab.heads_per_launch(ab.kernel_head_dim(d)) == 1
    rng = np.random.default_rng(d)
    k = rng.standard_normal((1, 5, ps, d)).astype(np.float32).astype(BF)
    v = rng.standard_normal((1, 5, ps, d)).astype(np.float32).astype(BF)
    q = rng.standard_normal((2, 1, d)).astype(np.float32)
    if q_dtype == "bfloat16":
        q = q.astype(BF)
    lengths = np.array([3, 8], np.int32)
    tables = np.array([[3, 0], [1, 4]], np.int32)
    want = to_torch(jpg._paged_attend_reference(*map(jnp.asarray, (
        q, k, v, lengths, tables))))
    got = ab.paged_decode_attention(*map(to_torch, (q, k, v, lengths,
                                                    tables)))
    assert got.dtype == want.dtype and got.shape == want.shape == (2, 1, d)
    assert rel(got, want) <= (1e-5 if q_dtype == "float32" else 2 ** -8)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,d", [(1, 64), (4, 64), (1, 128), (4, 128),
                                 (1, 96), (4, 100), (1, 99), (32, 64)])
def test_k12_plain_matches_jax_reference(g, d, q_dtype):
    """Also at head_dims the kernel reads at a wider template (96-100)
    and at more query heads per kv head than one launch takes (G = 32):
    the reference's jnp route takes every shape."""
    q, k, v, lengths, tables = _pool(np.random.default_rng(d + g), 2, g, d)
    if q_dtype == "bfloat16":
        q = q.astype(BF)
    want = jpg._paged_attend_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        jnp.asarray(tables))
    got = ab.paged_decode_attention_plain(
        to_torch(q), to_torch(k), to_torch(v), to_torch(lengths),
        to_torch(tables))
    want = to_torch(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if q_dtype == "float32":
        assert rel(got, want) <= 1e-5
    else:
        # one bf16 ulp of each element: 2^-7 of its power of two
        ulp = torch.exp2(torch.floor(torch.log2(want.float().abs()
                                                .clamp_min(1e-30))) - 7)
        assert bool(((got.float() - want.float()).abs() <= ulp).all())


def test_paged_attend_routes_bf16_pool_to_k12_plain_on_cpu():
    """``paged_attend`` on a bf16 pool on the CPU is K12's plain version
    (the kernel needs the card), bit for bit."""
    q, k, v, lengths, tables = _pool(np.random.default_rng(5), 2, 4, 128)
    args = [to_torch(a) for a in (q, k, v, lengths, tables)]
    assert torch.equal(tpg.paged_attend(*args),
                       ab.paged_decode_attention_plain(*args))


def _dense_models(kv_heads, seed=0, packed=False, **cfg):
    jcfg = jl.LlamaConfig.tiny(num_key_value_heads=kv_heads, **cfg)
    tcfg = dataclasses.replace(
        tl.LlamaConfig.tiny(num_key_value_heads=kv_heads, **cfg),
        attn_impl="flash")
    params = jl.init_params(jcfg, jax.random.PRNGKey(seed))
    if packed:
        params = jl.quantize_params_packed(params, jcfg)
    return jcfg, tcfg, params, port_params(params)


def _k13_against_jax_attention(monkeypatch, kv_heads, t, **cfg):
    """Layer 0's attention on the same f32 input: what o_proj receives on
    each side, JAX's einsum path against the port's K13 route (its plain
    version on the CPU), within 1e-5 of max|ctx|."""
    jcfg, tcfg, jp, tp = _dense_models(kv_heads, seed=kv_heads, **cfg)
    ids = np.random.default_rng(t).integers(0, 512, (2, t)).astype(np.int32)
    x = jp["embed_tokens"][jnp.asarray(ids)]
    h = jl.rms_norm(x, jp["layers"]["input_layernorm"][0], jcfg.rms_norm_eps)
    pos = jnp.broadcast_to(jnp.arange(t)[None], (2, t))
    jcos, jsin = jl.rope_tables(jcfg, pos)
    jlayer = {k: jax.tree_util.tree_map(lambda a: a[0], v)
              for k, v in jp["layers"].items()}
    tlayer = tl.layer_view(tp, 0)
    tcos, tsin = tl.rope_tables(tcfg, torch.arange(t)[None].expand(2, t))
    seen = {}
    for name, mod in (("jax", jl), ("port", tl)):
        inner = mod.quant_linear

        def record(xx, w, cfg, *rest, _inner=inner, _name=name):
            seen.setdefault(_name, []).append(xx)
            return _inner(xx, w, cfg, *rest)
        monkeypatch.setattr(mod, "quant_linear", record)
    calls = []
    plain = ab.flash_prefill_attention_plain
    monkeypatch.setattr(ab, "flash_prefill_attention_plain",
                        lambda *a: calls.append(1) or plain(*a))
    jl.attention(h, jlayer, jcfg, jcos, jsin, jl.causal_mask(t))
    tl.attention(to_torch(h), tlayer, tcfg, tcos, tsin, tl.causal_mask(t))
    assert calls == [1]
    ctx_j, ctx_t = to_torch(seen["jax"][-1]), seen["port"][-1]
    assert ctx_t.dtype == torch.float32 and ctx_t.shape == ctx_j.shape
    assert rel(ctx_t, ctx_j) <= 1e-5


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_k13_plain_matches_jax_attention(monkeypatch, kv_heads, t):
    _k13_against_jax_attention(monkeypatch, kv_heads, t)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_k13_plain_matches_jax_attention_head_dim_96(monkeypatch, kv_heads):
    """The same at head_dim 96 (hidden 384 over 4 heads), a D the kernels
    run at their 128 template."""
    _k13_against_jax_attention(monkeypatch, kv_heads, 128, hidden_size=384)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_flash_forward_matches_jax(kv_heads):
    """The packed tiny model's forward at 128 tokens, the port through K13
    (``attn_impl="flash"``: its plain version on the CPU), JAX through its
    einsum path."""
    jcfg, tcfg, jp, tp = _dense_models(kv_heads, seed=7, packed=True)
    ids = np.random.default_rng(3).integers(0, 512, (2, 128)).astype(np.int32)
    lj, _ = jl.forward(jp, jnp.asarray(ids), jcfg)
    lt, _ = tl.forward(tp, ids, tcfg, device="cpu")
    assert rel(lt, lj) <= 1e-2


def test_k13_plain_reads_only_the_first_t_key_rows():
    """k, v of S > T rows (a cache) give the result of their first T rows:
    the causal mask from position 0 never reaches row T."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((2, 96, 4, 64), (2, 160, 2, 64), (2, 160, 2, 64)))
    assert torch.equal(
        ab.flash_prefill_attention_plain(q, k, v),
        ab.flash_prefill_attention_plain(q, k[:, :96], v[:, :96]))


def _views(case):
    """A [B=2, T=5, H=4, D=64] view of a larger tensor: (view, read in
    place by K13)."""
    b, t, h, d = 2, 5, 4, 64
    if case == "qkv_bf16" or case == "qkv_f32":   # q of the fused qkv
        dtype = torch.bfloat16 if case == "qkv_bf16" else torch.float32
        x = torch.randn(b, t, 3 * h * d).to(dtype)
        return x[..., h * d:2 * h * d].view(b, t, h, d), True
    x = torch.randn(b * t * h * d + 64).to(torch.bfloat16)
    if case == "transposed":                      # [B, H, T, D] storage
        return x[:b * t * h * d].view(b, h, t, d).transpose(1, 2), False
    if case == "start":                           # 2 bytes off 16
        return x[1:1 + b * t * h * d].view(b, t, h, d), False
    if case == "token_stride":                    # h d + 4 elements
        return x.as_strided((b, t, h, d), (t * (h * d + 4), h * d + 4, d,
                                           1)), False
    return x.as_strided((b, t, h, d), (t * h * d + 4, h * d, d, 1)), False


@pytest.mark.parametrize("case", ["qkv_bf16", "qkv_f32", "transposed",
                                  "start", "token_stride", "batch_stride"])
def test_rows_reads_aligned_views_in_place(case):
    """``_rows``, the precondition of K13's tensor maps: heads and D
    contiguous, the start and the batch and token strides 16-byte aligned
    (the fused qkv projection's slices) are read in place; any other view
    (transposed, or a start or a stride off 16 bytes) is copied into
    contiguous rows with its values."""
    x, in_place = _views(case)
    y = ab._rows(x)
    if in_place:
        assert y is x
    else:
        assert y.is_contiguous() and y.data_ptr() != x.data_ptr()
        assert torch.equal(y, x)


def _fused(d, hq, hkv, start=0):
    """q, k, v [2, 5, H, d] bf16 as the slices of one fused qkv row, its
    storage starting ``start`` elements into an allocation."""
    n = 2 * 5 * (hq + 2 * hkv) * d
    x = torch.zeros(n + start, dtype=torch.bfloat16)[start:].view(
        2, 5, (hq + 2 * hkv) * d)
    return (x[..., :hq * d].view(2, 5, hq, d),
            x[..., hq * d:(hq + hkv) * d].view(2, 5, hkv, d),
            x[..., (hq + hkv) * d:].view(2, 5, hkv, d))


@pytest.mark.parametrize("d,hq,hkv,start,route,load", [
    (80, 4, 2, 0, "tma", 0), (96, 4, 4, 0, "tma", 0),
    (192, 2, 1, 0, "tma", 0), (128, 4, 4, 0, "tma", 0),
    (100, 4, 4, 0, "cp_async", 8), (100, 1, 1, 0, "cp_async", 8),
    (98, 2, 2, 0, "cp_async", 4), (96, 4, 4, 4, "cp_async", 8),
    (99, 1, 1, 0, "copy", 0), (96, 4, 4, 1, "copy", 0),
    (100, 4, 4, 1, "copy", 0)])
def test_load_route(d, hq, hkv, start, route, load):
    """How K13 and K13-bwd read bf16 rows between the templates: by TMA
    where D % 8 == 0 and every slice of the fused qkv row starts and steps
    on 16 bytes (80, 96, 192, and the templates); by cp.async where D is
    even and they are 4-byte aligned, 8 bytes a copy where D % 4 == 0 and
    they are 8-byte aligned (open_llama_3b's 100; 96 off 16 bytes by 8),
    else 4 (98: k starts 392 bytes in); zero-padded copies at the template
    width for an odd D (99) and a view one element off 16 bytes. The
    routes that read in place hand the tensors on as they are, with the
    true D as the kernels' head_dim."""
    tensors = _fused(d, hq, hkv, start)
    assert ab.load_route(d, tensors) == route
    w = ab.kernel_head_dim(d)
    got, dk, code = ab._bf16_loads(d, w, tensors)
    assert code == load
    if route == "copy":
        assert dk == w
        for g, x in zip(got, tensors):
            assert g.shape == x.shape[:-1] + (w,) and g.is_contiguous()
            assert torch.equal(g[..., :d], x) and not bool(g[..., d:].any())
    else:
        assert dk == d and all(g is x for g, x in zip(got, tensors))
        assert code == (ab.cp_async_bytes(d, tensors)
                        if route == "cp_async" else 0)


@pytest.mark.parametrize("d,route", [(96, "tma"), (100, "cp_async"),
                                     (99, "copy")])
def test_load_route_copies_a_transposed_view_into_rows(d, route):
    """dO as a transposed view ([B, H, T, D] storage): its heads and D
    are not contiguous, so it alone is copied into contiguous rows of
    width D, and the call then reads every tensor in place (a copy at the
    template width only where D is odd)."""
    q, k, v = _fused(d, 4, 4)
    do = torch.randn(2, 4, 5, d).to(torch.bfloat16).transpose(1, 2)
    assert ab.load_route(d, (q, k, v, do)) == "copy"
    got, dk, _ = ab._bf16_loads(d, ab.kernel_head_dim(d), (q, k, v, do))
    assert ab.load_route(dk, got) == ("tma" if route == "copy" else route)
    assert torch.equal(got[3][..., :d], do)
    if route != "copy":
        assert dk == d and all(g is x for g, x in zip(got[:3], (q, k, v)))


def _tile_at(r, c, rows):
    """``csrc/flash_split.cuh`` tile_at: element offset of (row r, column
    c) of a [rows][W] bf16 tile as TMA's 128-byte swizzle lays it."""
    return ((c >> 6) * rows * 64 + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3)
            + (c & 7))


@pytest.mark.parametrize("w,rows,g,d", [
    (128, 128, 8, 100), (128, 64, 8, 100), (128, 128, 4, 98),
    (128, 64, 4, 98), (64, 128, 8, 36), (64, 64, 4, 50),
    (256, 64, 8, 196), (256, 32, 4, 250), (256, 32, 8, 132)])
def test_cp_rows_emulation_fills_the_tma_layout(w, rows, g, d):
    """The producer's cp.async of bf16 rows (``cp_rows_g``: thread t keeps
    column (t % (W / E)) E, E = G / 2 elements a copy, and steps 128 E / W
    rows a pass) emulated in numpy over 128 threads: every element of the
    [rows][W] tile is written exactly once, and the tile holds, in TMA's
    swizzled layout, the rows of a head of d columns (of a fused row of 3
    heads, the neighbours' columns never copied) with zeros past d and
    past T."""
    e = g // 2
    per_row = w // e
    rs = 128 // per_row
    t_rows = rows - 3                      # the last 3 rows past T
    src = np.arange(1, rows * 3 * d + 1, dtype=np.int64).reshape(rows, 3, d)
    tile = np.zeros(rows * w, np.int64)
    writes = np.zeros(rows * w, np.int64)
    for t in range(128):
        c, r0 = t % per_row * e, t // per_row
        for r in range(r0, rows, rs):
            ok = c < d and r < t_rows
            for k in range(e):
                at = _tile_at(r, c, rows) + k
                tile[at] = src[r, 1, c + k] if ok else 0
                writes[at] += 1
    assert bool((writes == 1).all())
    want = np.zeros(rows * w, np.int64)
    for r in range(t_rows):
        for c in range(d):
            want[_tile_at(r, c, rows)] = src[r, 1, c]
    assert np.array_equal(tile, want)


def test_cpu_calls_launch_nothing():
    before = [f.launches for f in ab.KERNELS.values()]
    q, k, v, lengths, tables = _pool(np.random.default_rng(1), 2, 1, 128)
    args = [to_torch(a) for a in (q, k, v, lengths, tables)]
    ab.paged_decode_attention(*args)
    tpg.paged_attend(*args)
    x = torch.randn(1, 128, 4, 64)
    ab.flash_prefill_attention(x, x[:, :, :2], x[:, :, 2:])
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), attn_impl="flash")
    tl._attend_step(cfg, None, None, None, torch.float32, 0, x, x, x)
    assert [f.launches for f in ab.KERNELS.values()] == before



def _pad(x, w):
    return ab.pad_head_dim(x, w)


@pytest.mark.parametrize("d", [80, 96, 100])
def test_padded_plain_versions_equal_unpadded(d):
    """What the wrappers do on the card for a head_dim D that is not 64 or
    128, run through the plain versions: K12, K13 (with and without its
    lse) and K13-bwd at the kernels' width (128) on zero-padded copies of
    their inputs, with 1/sqrt(D) of the true D, give after slicing back to
    D the plain versions' results on the unpadded tensors, within 1e-6 of
    each result's max (f32: the padded sums only add exact zeros, so only
    the einsums' order of summation may differ), and zero padded columns
    of dQ, dK and dV."""
    w = ab.kernel_head_dim(d)
    assert w == 128
    rng = np.random.default_rng(d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((2, 130, 4, d), (2, 133, 2, d),
                               (2, 133, 2, d), (2, 130, 4, d)))
    ctx = ab.flash_prefill_attention_plain(q, k, v)
    got = ab.flash_prefill_attention_plain(_pad(q, w), _pad(k, w),
                                           _pad(v, w), head_dim=d)
    assert rel(got[..., :d], ctx) <= 1e-6
    assert not bool(got[..., d:].any())
    o, lse = ab.flash_attention_forward_plain(q, k, v)
    po, plse = ab.flash_attention_forward_plain(
        _pad(q, w), _pad(k, w), _pad(v, w), head_dim=d)
    assert rel(po[..., :d], o) <= 1e-6 and rel(plse, lse) <= 1e-6
    want = ab.flash_attention_bwd_plain(q, k, v, o, lse, do)
    grads = ab.flash_attention_bwd_plain(
        *(_pad(x, w) for x in (q, k, v, o)), lse, _pad(do, w), head_dim=d)
    for g, r in zip(grads, want):
        assert g.shape[:-1] == r.shape[:-1]
        assert rel(g[..., :d], r) <= 1e-6
        assert not bool(g[..., d:].any())
    qd, kp, vp, lengths, tables = _pool(rng, 2, 4, d)
    args = [to_torch(a) for a in (qd, kp, vp, lengths, tables)]
    ref = ab.paged_decode_attention_plain(*args)
    padded = ab.paged_decode_attention_plain(
        *(_pad(a, w) for a in args[:3]), *args[3:], head_dim=d)
    assert rel(padded[..., :d], ref) <= 1e-6


@pytest.mark.parametrize("d,w", [(80, 128), (96, 128), (100, 128),
                                 (33, 64), (64, 64), (128, 128), (129, 256),
                                 (160, 256), (192, 256), (256, 256),
                                 (257, 257), (300, 300), (384, 384),
                                 (512, 512), (1024, 1024)])
def test_shape_checks_take_every_head_dim_up_to_128(d, w):
    """K12's and K13's checks (K13-bwd's is K13's) take every D (the name
    is the test's from when the limit was 128) and give the width the
    kernels run it at: the next template up to 256, D itself past it (the
    wide path: ``is_wide``, 8 query heads a K12 launch, float32 planes of
    whole 64-column slices); D = 0 is refused; K12 past the q its wide
    path stages (WIDE_Q_FLOATS) takes one query head a launch."""
    q, k = torch.zeros(1, 4, 8, d), torch.zeros(1, 4, 2, d)
    assert ab._flash_check("K13", q, k, k) == w
    qp, kp, vp, lengths, tables = (to_torch(a) for a in _pool(
        np.random.default_rng(0), 2, 4, d))
    assert ab._paged_check(qp, kp, vp, lengths, tables) == 4
    assert ab.kernel_head_dim(d) == w
    assert ab.is_wide(w) == (d > 256)
    assert ab.heads_per_launch(w) == (16 if w <= 128 else 8)
    if d > 256:
        assert ab.plane_width(d) == -(-d // 64) * 64
        assert ab.plane_width(d) % ab.WIDE_SLICE == 0
        assert ab.wide_width(d) % 8 == 0 and d <= ab.wide_width(d) < d + 8
    with pytest.raises(ValueError, match="head_dim >= 1"):
        ab.kernel_head_dim(0)
    big = ab.WIDE_Q_FLOATS + 1
    assert ab.heads_per_launch(big) == 1
    pages = torch.zeros((1, 2, 1, big), dtype=torch.bfloat16)
    assert ab._paged_check(torch.zeros((1, 1, big)), pages, pages,
                           torch.ones(1, dtype=torch.int32),
                           torch.ones((1, 1), dtype=torch.int32)) == 1
