"""Head dims past the two the kernels were first written for, on the CPU,
where the wrappers take their plain versions, against mxq_tpu from numpy
seeds:

- the int8 family (K4, K4a-K4d, K9-K11) at D = 80, 100 (open_llama_3b)
  and 256 (Gemma-2B's attention) against mxq_tpu's dequantize-then-attend
  oracle ``int8_decode_attention_reference``: the history alone, the
  current token out of cache (spliced into the oracle's cache) and the
  paged pool (gathered into a dense cache), within 1e-3 of max|ctx| (the
  plain versions round p * v_scale to bf16 as the kernels do, the oracle
  does not; measured 3.4e-4 to 5.3e-4);
- K12's plain version against ``_paged_attend_reference`` at D = 192 and
  256 (float32 q within 1e-5 of max|ctx|, bf16 q within one bf16 ulp);
- K13's and K13-bwd's plain versions, through the port's attention with
  ``attn_impl="flash"`` under autograd, against mxq_tpu's attention on
  its XLA path (``attn_impl="xla"``) and ``jax.grad`` at D = 256 with one
  kv head (G = 2), float32 (output 1e-5 of its max, gradient 1e-4) and
  bfloat16 (2e-2: the probabilities and dS rounded at other points);
- greedy tokens of the slot Engine (int8 and bf16 caches) and of the
  PagedEngine (int8 and bf16 pools) equal mxq_tpu's token for token at
  D = 100 (hidden 1600 over 16 heads) and D = 256 (hidden 512 over 2
  heads, 1 kv head);
- the int8 wrappers' checks take every D, pick the code load the rows'
  alignment allows, and name the wide path's library past 256 (D > 256
  itself: ``test_torch_wide_head_dims.py``).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mxq_tpu.models import llama as jl
from mxq_tpu.ops import attn_int8 as ja8
from mxq_tpu.serving import engine as jeng
from mxq_tpu.serving import paged as jpg
from mxq_tpu_torch.models import llama as tl
from mxq_tpu_torch.ops import attn_bf16 as ab
from mxq_tpu_torch.ops import attn_int8 as ta8
from mxq_tpu_torch.serving import engine as teng
from mxq_tpu_torch.serving import paged as tpg
from torch_port_helpers import port_params, rel, to_torch

BF = ml_dtypes.bfloat16
PS8 = ta8.PAGE_INT8
INT8_GATE = 1e-3


# ---------------------------------------------------------------------------
# the int8 family against the dequantize-then-attend oracle
# ---------------------------------------------------------------------------


def _int8_inputs(d, seed, b=3, hq=8, hkv=2, s=300, layers=2):
    rng = np.random.default_rng(seed)
    codes = lambda *sh: rng.integers(-127, 128, sh).astype(np.int8)  # noqa
    scales = lambda *sh: (rng.random(sh) * 0.02 + 1e-3).astype(BF)  # noqa
    return dict(
        q=rng.standard_normal((b, hq, d)).astype(np.float32).astype(BF),
        kc=codes(layers, b, hkv, s, d), vc=codes(layers, b, hkv, s, d),
        ks=scales(layers, b, hkv, s), vs=scales(layers, b, hkv, s),
        kcur=codes(b, hkv, 1, d), vcur=codes(b, hkv, 1, d),
        kscur=scales(b, hkv, 1), vscur=scales(b, hkv, 1),
        pos=np.array([0, 130, s - 1][:b], np.int32))


def _oracle(q, kc, ks, vc, vs, pos):
    """mxq_tpu's oracle over one layer ([B, Hkv, S, D] codes), rows <=
    pos, as a CPU tensor."""
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    return to_torch(ja8.int8_decode_attention_reference(
        f32(q), jnp.asarray(kc), f32(ks), jnp.asarray(vc), f32(vs),
        jnp.asarray(pos)))


@pytest.mark.parametrize("d", [80, 100, 256])
def test_int8_dense_plain_matches_jax_oracle(d):
    """K4a/K4c over rows <= pos; K4b/K4d and K4 (the current token out of
    cache) against the oracle over the cache with the current row and its
    scales spliced in at pos; K4's written code rows are the current
    token's, every other byte untouched."""
    a = _int8_inputs(d, seed=d)
    t = {k: to_torch(v) for k, v in a.items()}
    idx, pos = 1, a["pos"]
    want = _oracle(a["q"], a["kc"][idx], a["ks"][idx], a["vc"][idx],
                   a["vs"][idx], pos)
    got = ta8.int8_decode_attention_stacked(t["q"], t["kc"], t["ks"],
                                            t["vc"], t["vs"], idx, t["pos"])
    assert got.shape == want.shape and rel(got, want) <= INT8_GATE
    rows = np.arange(len(pos))
    kc, vc = a["kc"][idx].copy(), a["vc"][idx].copy()
    ks, vs = a["ks"][idx].copy(), a["vs"][idx].copy()
    kc[rows, :, pos] = a["kcur"][:, :, 0]
    vc[rows, :, pos] = a["vcur"][:, :, 0]
    ks[rows, :, pos] = a["kscur"][:, :, 0]
    vs[rows, :, pos] = a["vscur"][:, :, 0]
    spliced = _oracle(a["q"], kc, ks, vc, vs, pos)
    cur = [t[k] for k in ("kcur", "kscur", "vcur", "vscur")]
    folded = ta8.int8_decode_attention_cur_folded(
        t["q"], t["kc"], t["ks"], t["vc"], t["vs"], *cur, idx, t["pos"])
    assert rel(folded, spliced) <= INT8_GATE
    kcw, vcw = t["kc"].clone(), t["vc"].clone()
    ctx, kout, vout = ta8.int8_decode_attention_fused_write(
        t["q"], kcw, t["ks"], vcw, t["vs"], *cur, idx, t["pos"])
    assert kout is kcw and vout is vcw
    assert torch.equal(ctx, folded)
    assert torch.equal(kcw[idx], torch.from_numpy(kc))
    assert torch.equal(vcw[idx], torch.from_numpy(vc))
    assert torch.equal(kcw[0], t["kc"][0]) and torch.equal(vcw[0], t["vc"][0])


@pytest.mark.parametrize("d", [80, 100, 256])
def test_int8_paged_plain_matches_jax_oracle(d):
    """K9 over rows < lengths, K10 and K11 with the current token, on a
    pool of 128-row pages under shuffled tables (the null page 0 past each
    position's page), against the oracle over each sequence's pages
    gathered into a dense cache (K10/K11: the current row spliced in);
    K11 writes the current code row and scales at the position's page."""
    rng = np.random.default_rng(d + 1)
    b, hkv, hq, pps = 3, 2, 8, 3
    lp = 1 + b * pps
    pos = np.array([0, 129, pps * PS8 - 1], np.int32)
    codes = lambda *sh: rng.integers(-127, 128, sh).astype(np.int8)  # noqa
    scales = lambda *sh: (rng.random(sh) * 0.02 + 1e-3).astype(BF)  # noqa
    kp, vp = codes(hkv, lp, PS8, d), codes(hkv, lp, PS8, d)
    ks, vs = scales(hkv, lp, 1, PS8), scales(hkv, lp, 1, PS8)
    kcur, vcur = codes(b, hkv, d), codes(b, hkv, d)
    kscur, vscur = scales(b, hkv), scales(b, hkv)
    tables = (rng.permutation(lp - 1)[:b * pps] + 1).reshape(b, pps)
    for i, p in enumerate(pos):
        tables[i, p // PS8 + 1:] = 0
    tables = tables.astype(np.int32)
    q = rng.standard_normal((b, hq, d)).astype(np.float32).astype(BF)

    def dense(kp, ks, vp, vs):         # [B, Hkv, pps * 128, D] and scales
        g = lambda x: x[:, tables].transpose(1, 0, 2, 3, 4)  # noqa: E731
        return (g(kp).reshape(b, hkv, -1, d), g(ks).reshape(b, hkv, -1),
                g(vp).reshape(b, hkv, -1, d), g(vs).reshape(b, hkv, -1))
    t = [to_torch(x) for x in (q, kp, ks, vp, vs)]
    tab, tpos = to_torch(tables), to_torch(pos)
    kcd, ksd, vcd, vsd = dense(kp, ks, vp, vs)
    got = ta8.int8_paged_decode_attention(*t, tpos + 1, tab)
    assert rel(got, _oracle(q, kcd, ksd, vcd, vsd, pos)) <= INT8_GATE
    # the current token spliced in at pos: the oracle's cache and K11's
    # pool after the write
    rows = np.arange(b)
    page, off = tables[rows, pos // PS8], pos % PS8
    kpw, vpw, ksw, vsw = kp.copy(), vp.copy(), ks.copy(), vs.copy()
    kpw[:, page, off] = kcur.transpose(1, 0, 2)
    vpw[:, page, off] = vcur.transpose(1, 0, 2)
    ksw[:, page, 0, off] = kscur.T
    vsw[:, page, 0, off] = vscur.T
    want = _oracle(q, *dense(kpw, ksw, vpw, vsw), pos)
    cur = [to_torch(x) for x in (kcur, kscur, vcur, vscur)]
    k10 = ta8.int8_paged_decode_attention_cur(*t, *cur, tpos, tab)
    assert rel(k10, want) <= INT8_GATE
    pool = [x.clone() for x in t[1:]]
    k11 = ta8.int8_paged_decode_attend_update(t[0], *pool, *cur, tpos, tab)
    assert torch.equal(k11[0], k10)
    for mine, theirs in zip(pool, (kpw, ksw, vpw, vsw)):
        assert torch.equal(mine.view(torch.uint8) if mine.dtype == torch.int8
                           else mine.view(torch.int16),
                           torch.from_numpy(theirs.view(
                               np.uint8 if theirs.dtype == np.int8
                               else np.int16)))


@pytest.mark.parametrize("d", [1, 33, 64, 80, 99, 100, 128, 160, 255, 256,
                               257, 300, 384, 512, 1024])
def test_int8_checks_take_every_head_dim_up_to_256(d):
    """K4's and K9-K11's checks take every D (the name is the test's from
    when the limit was 256) and choose the code load the kernels make: 16
    bytes at the templates (64, 128, 256) and where D % 16 == 0, else 4
    bytes where D % 4 == 0, else one; D <= 256 runs the templates'
    libraries, D > 256 the wide path's (``attn_int8_wide``)."""
    t = _int8_inputs(d, seed=0, s=8)
    t = {k: to_torch(v) for k, v in t.items()}
    q = t["q"]
    ta8._check_k4("K4", q, t["kc"], t["ks"], t["vc"], t["vs"], None, t["pos"])
    pages = torch.zeros((2, 3, PS8, d), dtype=torch.int8)
    pscales = torch.zeros((2, 3, 1, PS8), dtype=torch.bfloat16)
    tables = torch.zeros((3, 2), dtype=torch.int32)
    vec = ta8._check_paged("K9", q, pages, pscales, pages, pscales,
                           t["pos"], tables, None)
    want = 16 if d % 16 == 0 else 4 if d % 4 == 0 else 1
    assert vec == want
    assert ta8.code_load_bytes("K4", d, [t["kc"][1], t["vc"][1]]) == want
    wide = d > 256
    assert ta8.kernel_entry(d, paged=False) == (
        ("attn_int8_wide", "attn_int8_wide") if wide
        else ("attn_int8", "attn_int8"))
    assert ta8.kernel_entry(d, paged=True) == (
        ("attn_int8_wide", "paged_attn_int8_wide") if wide
        else ("paged_attn_int8", "paged_attn_int8"))
    # a code tensor starting one byte in takes one-byte loads at every D
    # off the templates, the wide path's included
    if d not in ta8.TILE_DIMS:
        buf = torch.zeros(PS8 * d + 1, dtype=torch.int8)
        assert ta8.code_load_bytes("K4", d, [buf[1:]]) == 1


def test_code_load_bytes_follows_the_rows_alignment():
    """A row at D bytes from the last starts as aligned as D and the
    tensor's start allow: a view one byte in takes one-byte loads; at a
    template width an unaligned start is refused (the kernels' 16-byte
    loads)."""
    buf = torch.zeros(4096 + 16, dtype=torch.int8)
    base = buf[(-buf.data_ptr()) % 16:]
    assert ta8.code_load_bytes("K4", 80, [base]) == 16
    assert ta8.code_load_bytes("K4", 100, [base]) == 4
    assert ta8.code_load_bytes("K4", 100, [base[4:]]) == 4
    assert ta8.code_load_bytes("K4", 100, [base[2:]]) == 1
    assert ta8.code_load_bytes("K4", 80, [base[4:]]) == 4
    with pytest.raises(ValueError, match="16-byte"):
        ta8.code_load_bytes("K4", 256, [base[4:]])


# ---------------------------------------------------------------------------
# K12, K13 and K13-bwd at D > 128
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,d", [(8, 256), (2, 192), (1, 256)])
def test_k12_plain_matches_jax_reference_past_128(g, d, q_dtype):
    """K12's plain version against ``_paged_attend_reference`` on a folded
    bf16 pool of 64-row pages, tables shuffled with the null page past
    each length (1, 63-65 and the whole table)."""
    rng = np.random.default_rng(d + g)
    lens, ps, pps, hkv = [1, 63, 64, 65, 256], 64, 4, 2
    b, lp = len(lens), 1 + len(lens) * 4
    k = rng.standard_normal((hkv, lp, ps, d)).astype(np.float32).astype(BF)
    v = rng.standard_normal((hkv, lp, ps, d)).astype(np.float32).astype(BF)
    q = rng.standard_normal((b, hkv * g, d)).astype(np.float32)
    if q_dtype == "bfloat16":
        q = q.astype(BF)
    tables = (rng.permutation(lp - 1)[:b * pps] + 1).reshape(b, pps)
    for i, n in enumerate(lens):
        tables[i, -(-n // ps):] = 0
    lengths, tables = np.array(lens, np.int32), tables.astype(np.int32)
    want = to_torch(jpg._paged_attend_reference(*map(jnp.asarray, (
        q, k, v, lengths, tables))))
    got = ab.paged_decode_attention(*map(to_torch, (q, k, v, lengths,
                                                    tables)))
    assert got.dtype == want.dtype and got.shape == want.shape
    if q_dtype == "float32":
        assert rel(got, want) <= 1e-5
    else:
        ulp = torch.exp2(torch.floor(torch.log2(want.float().abs()
                                                .clamp_min(1e-30))) - 7)
        assert bool(((got.float() - want.float()).abs() <= ulp).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k13_and_bwd_plain_match_jax_xla_attention_d256(dtype):
    """A layer's attention at hidden 512 over 2 heads and 1 kv head (D =
    256, G = 2), 160 tokens from position 0: the port through K13's plain
    version under autograd (``attn_impl="flash"``: FlashAttention, whose
    backward is K13-bwd's plain version) against mxq_tpu's einsum path
    (``attn_impl="xla"``), the output and the gradient of sum(out * c)
    with respect to the layer's input."""
    kw = dict(hidden_size=512, num_attention_heads=2, num_key_value_heads=1,
              intermediate_size=512)
    jcfg = jl.LlamaConfig.tiny(attn_impl="xla", **kw)
    tcfg = tl.LlamaConfig.tiny(attn_impl="flash", **kw)
    assert tcfg.head_dim == 256
    jp = jl.init_params(jcfg, jax.random.PRNGKey(3))
    tp = port_params(jp)
    jt, tt = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    jlayer = {k: jax.tree_util.tree_map(lambda a: a[0].astype(jt), v)
              for k, v in jp["layers"].items()}
    tlayer = {k: v.to(tt) for k, v in tl.layer_view(tp, 0).items()}
    b, t = 2, 160
    rng = np.random.default_rng(9)
    x = rng.standard_normal((b, t, 512)).astype(np.float32)
    c = rng.standard_normal((b, t, 512)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(t)[None], (b, t))
    jcos, jsin = jl.rope_tables(jcfg, pos)
    tcos, tsin = tl.rope_tables(tcfg, torch.arange(t)[None].expand(b, t))

    def jout(h):
        return jl.attention(h, jlayer, jcfg, jcos, jsin,
                            jl.causal_mask(t))[0]
    xj = jnp.asarray(x).astype(jt)
    oj = jout(xj)
    gj = jax.grad(lambda h: jnp.sum(jout(h).astype(jnp.float32)
                                    * jnp.asarray(c)))(xj)
    xt = to_torch(np.asarray(xj.astype(jnp.float32))).to(tt) \
        .requires_grad_()
    ot = tl.attention(xt, tlayer, tcfg, tcos, tsin, tl.causal_mask(t))
    (ot.float() * torch.from_numpy(c)).sum().backward()
    out_gate, grad_gate = (1e-5, 1e-4) if dtype == "float32" else (2e-2,
                                                                   2e-2)
    assert ot.dtype == tt and xt.grad.dtype == tt
    assert rel(ot.detach(), to_torch(np.asarray(oj.astype(jnp.float32)))) \
        <= out_gate
    assert rel(xt.grad, to_torch(np.asarray(gj.astype(jnp.float32)))) \
        <= grad_gate


# ---------------------------------------------------------------------------
# Engine and PagedEngine tokens at D = 100 and 256
# ---------------------------------------------------------------------------

# (hidden, heads, kv heads): D = 100 (open_llama_3b's, hidden 1600 the
# least width that 64 and 100 divide) and D = 256 at Gemma-2B's one kv head
WIDTHS = {100: (1600, 16, 16), 256: (512, 2, 1)}
PROMPTS = [np.arange(5, dtype=np.int32) + 7,
           np.arange(9, dtype=np.int32) + 40]
NEW = 4
MODES = ("slot8", "slot32", "paged8", "paged32")


def _config(mod, d):
    hidden, heads, kv = WIDTHS[d]
    return mod.LlamaConfig(vocab_size=512, hidden_size=hidden,
                           intermediate_size=1024, num_hidden_layers=2,
                           num_attention_heads=heads, num_key_value_heads=kv,
                           max_position_embeddings=256)


def _generate(mod, eng_mod, params, cfg, mode, **kw):
    if mode.startswith("slot"):
        e = eng_mod.Engine(params, cfg, eng_mod.EngineConfig(
            num_slots=2, max_len=64, prefill_buckets=(16,),
            kv_quant=mode == "slot8"), **kw)
    else:
        kv = int(mode[5:])
        e = mod.PagedEngine(params, cfg, num_slots=2, total_pages=16,
                            page_size=PS8 if kv == 8 else 16,
                            max_len=256 if kv == 8 else 64,
                            prefill_bucket=16, kv_bits=kv, **kw)
    reqs = [e.submit(p, max_new_tokens=NEW) for p in PROMPTS]
    assert len(e.run()) == len(reqs)
    return [list(map(int, r.generated)) for r in reqs]


@pytest.fixture(scope="module")
def wide_models():
    """Per D: the packed model on both sides and JAX's greedy tokens in
    each mode (the JAX engines on the CPU take seconds each)."""
    out = {}
    for d in WIDTHS:
        cfg = _config(jl, d)
        jp = jl.quantize_params_packed(
            jl.init_params(cfg, jax.random.PRNGKey(d)), cfg)
        want = {m: _generate(jpg, jeng, jp, cfg, m) for m in MODES}
        out[d] = (port_params(jp), want)
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", sorted(WIDTHS))
def test_engine_tokens_equal_jax_at_head_dim(wide_models, d, mode):
    """slot8/slot32: the slot Engine with the int8 cache (K4's plain
    version) and the bf16 cache; paged8/paged32: the PagedEngine with the
    int8 pool (K11's) and the bf16 pool (K12's): greedy tokens equal
    mxq_tpu's, token for token."""
    tp, want = wide_models[d]
    cfg = _config(tl, d)
    assert cfg.head_dim == d
    got = _generate(tpg, teng, tp, cfg, mode, device="cpu")
    assert got == want[mode]
    assert [len(g) for g in got] == [NEW] * len(PROMPTS)
