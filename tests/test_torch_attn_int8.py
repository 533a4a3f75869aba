"""The int8 KV cache and decode attention of mxq_tpu_torch against mxq_tpu:
quantization codes and scales exactly, and K4's plain version (what the
wrapper runs on CPU tensors) against JAX's fused-write kernel in interpret
mode at ctx rel <= 1e-5, with the written rows equal and every other cache
byte untouched. The plain versions of K4a-K4d (no current token, or no
write) against JAX's int8_decode_attention, _stacked, _cur and _cur_folded
in interpret mode at rel <= 1e-6: the same f32 math with the same bf16
roundings, summed in another order. K4a with T query tokens per sequence
(the speculative verify in one call) against T single-query calls, and
``llama.decode_slots``' verify through it against the per-query loop it
replaces."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxq_tpu.ops import attn_int8 as ja8
from mxq_tpu.serving import kvcache as jkv
from mxq_tpu_torch.models import llama as tl
from mxq_tpu_torch.ops import attn_int8 as ta8
from mxq_tpu_torch.serving import kvcache as tkv
from torch_port_helpers import bits, rel, to_torch

import ml_dtypes

L, B, HQ, HKV, S, D = 2, 2, 4, 2, 32, 64


def _inputs(seed=0, positions=(0, 31), hq=HQ, hkv=HKV, b=B):
    rng = np.random.default_rng(seed)
    bf = ml_dtypes.bfloat16
    codes = lambda *s: rng.integers(-127, 128, s).astype(np.int8)  # noqa
    return dict(
        q=rng.standard_normal((b, hq, D)).astype(np.float32),
        kc=codes(L, b, hkv, S, D), vc=codes(L, b, hkv, S, D),
        ks=(rng.random((L, b, hkv, S)) * 0.02 + 0.001).astype(bf),
        vs=(rng.random((L, b, hkv, S)) * 0.02 + 0.001).astype(bf),
        kcur=codes(b, hkv, 1, D), vcur=codes(b, hkv, 1, D),
        kscur=(rng.random((b, hkv, 1)) * 0.02 + 0.001).astype(bf),
        vscur=(rng.random((b, hkv, 1)) * 0.02 + 0.001).astype(bf),
        positions=np.asarray(positions, np.int32))


def test_quantize_kv_headmajor_exact():
    x = np.random.default_rng(1).standard_normal((2, 5, 3, 64)).astype(
        np.float32) * 3
    x[0, 0, 0] = 0.0                       # an all-zero row: scale 0
    cj, sj = jkv.quantize_kv_headmajor(jnp.asarray(x))
    ct, st = tkv.quantize_kv_headmajor(torch.from_numpy(x))
    assert ct.shape == (2, 3, 5, 64) and st.shape == (2, 3, 5)
    assert torch.equal(ct, to_torch(cj))
    assert torch.equal(bits(st), bits(to_torch(sj)))
    np.testing.assert_array_equal(
        tkv.dequantize_kv(ct, st[..., None], 64, torch.float32).numpy(),
        np.asarray(jkv.dequantize_kv(cj, sj[..., None], 64, jnp.float32)))


def test_cache_update_and_read_layer_match_jax():
    rng = np.random.default_rng(2)
    k = rng.standard_normal((2, 4, 3, 64)).astype(np.float32)
    v = rng.standard_normal((2, 4, 3, 64)).astype(np.float32)
    jc = {n: c[0] for n, c in jkv.init_quant_cache(1, 2, 16, 3, 64).items()}
    tc = {n: c[0] for n, c in tkv.init_quant_cache(
        1, 2, 16, 3, 64, device="cpu").items()}
    jc = jkv.cache_update_layer(jc, jnp.asarray(k), jnp.asarray(v), 5)
    tkv.cache_update_layer(tc, torch.from_numpy(k), torch.from_numpy(v), 5)
    for n in tc:
        assert torch.equal(bits(tc[n]), bits(to_torch(jc[n]))), n
    for a, b in zip(tkv.cache_read_layer(tc, dtype=torch.float32),
                    jkv.cache_read_layer(jc, dtype=jnp.float32)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        tkv.cache_update_layer(tc, torch.from_numpy(k), torch.from_numpy(v),
                               13)


@pytest.mark.parametrize("hq,hkv,positions", [
    (HQ, HKV, (0, 31)),            # GQA; no history and the last row
    (4, 4, (7, 30)),               # MHA
])
def test_fused_write_plain_matches_jax(hq, hkv, positions):
    a = _inputs(hq=hq, hkv=hkv, positions=positions)
    t = {k: to_torch(v) for k, v in a.items()}
    kc0, vc0 = t["kc"].clone(), t["vc"].clone()
    for idx in range(L):
        cj, kcj, vcj = ja8.int8_decode_attention_fused_write(
            jnp.asarray(a["q"]), jnp.asarray(a["kc"]),
            jnp.asarray(a["ks"]), jnp.asarray(a["vc"]),
            jnp.asarray(a["vs"]), jnp.asarray(a["kcur"]),
            jnp.asarray(a["kscur"]), jnp.asarray(a["vcur"]),
            jnp.asarray(a["vscur"]), jnp.int32(idx),
            jnp.asarray(a["positions"]))
        kc, vc = kc0.clone(), vc0.clone()
        ct, kc2, vc2 = ta8.int8_decode_attention_fused_write(
            t["q"], kc, t["ks"], vc, t["vs"], t["kcur"], t["kscur"],
            t["vcur"], t["vscur"], idx, t["positions"])
        assert kc2 is kc and vc2 is vc          # written in place
        assert ct.shape == (B, hq, D) and ct.dtype == torch.float32
        assert rel(ct, cj) <= 1e-5, idx
        assert torch.equal(kc, to_torch(kcj)) and torch.equal(
            vc, to_torch(vcj)), idx
        # rows other than (idx, b, :, positions[b]) are untouched
        rows = torch.arange(B)
        pos = t["positions"].long()
        kc[idx, rows, :, pos] = kc0[idx, rows, :, pos]
        vc[idx, rows, :, pos] = vc0[idx, rows, :, pos]
        assert torch.equal(kc, kc0) and torch.equal(vc, vc0)


def test_fused_write_equals_write_then_attend_oracle():
    """Attending the history plus the out-of-cache current token equals
    splicing the current row in and running the dequantize-then-attend
    oracle (up to the bf16 rounding of p*v_scale)."""
    a = _inputs(seed=3, positions=(5, 20))
    t = {k: to_torch(v) for k, v in a.items()}
    idx, rows, pos = 1, torch.arange(B), t["positions"].long()
    kc, vc = t["kc"].clone(), t["vc"].clone()
    ctx, _, _ = ta8.int8_decode_attention_fused_write(
        t["q"], kc, t["ks"], vc, t["vs"], t["kcur"], t["kscur"], t["vcur"],
        t["vscur"], idx, t["positions"])
    ks, vs = t["ks"][idx].clone(), t["vs"][idx].clone()
    ks[rows, :, pos] = t["kscur"][:, :, 0]
    vs[rows, :, pos] = t["vscur"][:, :, 0]
    q = t["q"].to(torch.bfloat16).float()
    ref = ta8.int8_decode_attention_reference(q, kc[idx], ks, vc[idx], vs,
                                              t["positions"])
    refj = ja8.int8_decode_attention_reference(
        jnp.asarray(q.numpy()), jnp.asarray(kc[idx].numpy()),
        jnp.asarray(ks.float().numpy()), jnp.asarray(vc[idx].numpy()),
        jnp.asarray(vs.float().numpy()), jnp.asarray(a["positions"]))
    assert rel(ref, refj) <= 1e-5
    assert rel(ctx, ref) <= 1e-2


def test_decode_attend_update_contract():
    a = _inputs(seed=4, positions=(3, 9))
    t = {k: to_torch(v) for k, v in a.items()}
    cache = {"k_codes": t["kc"], "k_scale": t["ks"], "v_codes": t["vc"],
             "v_scale": t["vs"]}
    ctx, out, pend = ta8.decode_attend_update(
        cache, t["q"], t["kcur"], t["kscur"], t["vcur"], t["vscur"], 0,
        t["positions"])
    assert out is cache and ctx.shape == (B, HQ, D)
    assert pend[0] is t["kscur"] and pend[1] is t["vscur"]
    assert torch.equal(cache["k_codes"][0, 1, :, 9], t["kcur"][1, :, 0])


def _jnp(t):
    return {k: jnp.asarray(v) for k, v in t.items()}


def test_k4a_k4c_plain_match_jax():
    """K4a (one layer) and K4c (a layer of the stack): rows <= pos, no
    current token. GQA; one row, and every row."""
    hq, hkv = HQ, HKV
    a = _inputs(seed=6, hq=hq, hkv=hkv, positions=(0, 31))
    j, t = _jnp(a), {k: to_torch(v) for k, v in a.items()}
    for idx in range(L):
        want = ja8.int8_decode_attention(
            j["q"], j["kc"][idx], j["ks"][idx], j["vc"][idx], j["vs"][idx],
            j["positions"])
        got = ta8.int8_decode_attention(
            t["q"], t["kc"][idx], t["ks"][idx], t["vc"][idx], t["vs"][idx],
            t["positions"])
        assert got.shape == (B, hq, D) and got.dtype == torch.float32
        assert rel(got, want) <= 1e-6, idx
        want_st = ja8.int8_decode_attention_stacked(
            j["q"], j["kc"], j["ks"], j["vc"], j["vs"], jnp.int32(idx),
            j["positions"])
        got_st = ta8.int8_decode_attention_stacked(
            t["q"], t["kc"], t["ks"], t["vc"], t["vs"], idx, t["positions"])
        assert rel(got_st, want_st) <= 1e-6, idx
        assert torch.equal(got_st, got)
    # against the dequantize-then-attend oracle: the bf16 rounding of
    # p * v_scale apart, the same attention
    q = t["q"].to(torch.bfloat16).float()
    ref = ta8.int8_decode_attention_reference(
        q, t["kc"][1], t["ks"][1], t["vc"][1], t["vs"][1], t["positions"])
    assert rel(got, ref) <= 1e-2


def test_k4b_k4d_plain_match_jax():
    """K4b (one layer) and K4d (a layer of the stack): rows < pos plus the
    current token, nothing written; the same ctx as K4's. MHA."""
    a = _inputs(seed=7, hq=4, hkv=4, positions=(7, 30))
    j, t = _jnp(a), {k: to_torch(v) for k, v in a.items()}
    cur_j = (j["kcur"], j["kscur"], j["vcur"], j["vscur"])
    cur_t = (t["kcur"], t["kscur"], t["vcur"], t["vscur"])
    kc0, vc0 = t["kc"].clone(), t["vc"].clone()
    for idx in range(L):
        want = ja8.int8_decode_attention_cur(
            j["q"], j["kc"][idx], j["ks"][idx], j["vc"][idx], j["vs"][idx],
            *cur_j, j["positions"])
        got = ta8.int8_decode_attention_cur(
            t["q"], t["kc"][idx], t["ks"][idx], t["vc"][idx], t["vs"][idx],
            *cur_t, t["positions"])
        assert rel(got, want) <= 1e-6, idx
        want_f = ja8.int8_decode_attention_cur_folded(
            j["q"], j["kc"], j["ks"], j["vc"], j["vs"], *cur_j,
            jnp.int32(idx), j["positions"])
        got_f = ta8.int8_decode_attention_cur_folded(
            t["q"], t["kc"], t["ks"], t["vc"], t["vs"], *cur_t, idx,
            t["positions"])
        assert rel(got_f, want_f) <= 1e-6, idx
        assert torch.equal(got_f, got)
        assert torch.equal(t["kc"], kc0) and torch.equal(t["vc"], vc0)
        k4, _, _ = ta8.int8_decode_attention_fused_write(
            t["q"], kc0.clone(), t["ks"], vc0.clone(), t["vs"], *cur_t, idx,
            t["positions"])
        assert torch.equal(got_f, k4)


def test_k4a_after_writing_equals_k4():
    """Writing the current token's row and scale, then attending rows <=
    pos with K4a, gives K4's ctx (the int8 codes are exact in bf16): the
    identity a speculative verify relies on."""
    a = _inputs(seed=8, positions=(4, 19))
    t = {k: to_torch(v) for k, v in a.items()}
    idx, rows, pos = 1, torch.arange(B), t["positions"].long()
    kc, vc = t["kc"].clone(), t["vc"].clone()
    ks, vs = t["ks"].clone(), t["vs"].clone()
    k4, _, _ = ta8.int8_decode_attention_fused_write(
        t["q"], kc, ks, vc, vs, t["kcur"], t["kscur"], t["vcur"],
        t["vscur"], idx, t["positions"])
    ks[idx, rows, :, pos] = t["kscur"][:, :, 0]
    vs[idx, rows, :, pos] = t["vscur"][:, :, 0]
    k4a = ta8.int8_decode_attention_stacked(t["q"], kc, ks, vc, vs, idx,
                                            t["positions"])
    assert rel(k4a, k4) <= 1e-6


def test_cpu_call_launches_nothing():
    a = _inputs(seed=5)
    t = {k: to_torch(v) for k, v in a.items()}
    before = {k: f.launches for k, f in ta8.KERNELS.items()}
    ta8.int8_decode_attention_fused_write(
        t["q"], t["kc"], t["ks"], t["vc"], t["vs"], t["kcur"], t["kscur"],
        t["vcur"], t["vscur"], 0, t["positions"])
    ta8.int8_decode_attention(t["q"], t["kc"][0], t["ks"][0], t["vc"][0],
                              t["vs"][0], t["positions"])
    ta8.int8_decode_attention_cur_folded(
        t["q"], t["kc"], t["ks"], t["vc"], t["vs"], t["kcur"], t["kscur"],
        t["vcur"], t["vscur"], 1, t["positions"])
    ta8.int8_decode_attention_stacked(
        torch.stack([t["q"]] * 3, dim=1), t["kc"], t["ks"], t["vc"],
        t["vs"], 0, t["positions"])
    assert {k: f.launches for k, f in ta8.KERNELS.items()} == before


@pytest.mark.parametrize("hq,hkv,positions", [
    (HQ, HKV, (0, 26)),            # GQA; the first row, and the last
    (4, 4, (13, 3)),               # MHA
])
def test_k4a_multi_query_equals_single_queries(hq, hkv, positions):
    """K4a with q [B, T, Hq, D] (query t over rows <= pos + t) equals T
    single-query calls at positions + t bit for bit, and JAX's
    int8_decode_attention_stacked per query (interpret mode) to 1e-6."""
    t_q = 5
    a = _inputs(seed=9, hq=hq, hkv=hkv, positions=positions)
    qm = np.random.default_rng(10).standard_normal(
        (B, t_q, hq, D)).astype(np.float32)
    t = {k: to_torch(v) for k, v in a.items()}
    j = _jnp(a)
    q = torch.from_numpy(qm)
    got = ta8.int8_decode_attention_stacked(q, t["kc"], t["ks"], t["vc"],
                                            t["vs"], 1, t["positions"])
    assert got.shape == (B, t_q, hq, D) and got.dtype == torch.float32
    one = ta8.int8_decode_attention(q, t["kc"][1], t["ks"][1], t["vc"][1],
                                    t["vs"][1], t["positions"])
    assert torch.equal(one, got)
    for i in range(t_q):
        single = ta8.int8_decode_attention_stacked(
            q[:, i].contiguous(), t["kc"], t["ks"], t["vc"], t["vs"], 1,
            t["positions"] + i)
        assert torch.equal(got[:, i], single), i
        want = ja8.int8_decode_attention_stacked(
            jnp.asarray(qm[:, i]), j["kc"], j["ks"], j["vc"], j["vs"],
            jnp.int32(1), j["positions"] + i)
        assert rel(got[:, i], want) <= 1e-6, i


@pytest.mark.parametrize("g", [1, 8, 64])
@pytest.mark.parametrize("t_q", [1, 9, 65])
def test_k4a_token_chunks_cover_t_once(g, t_q):
    """K4a's launches for G * T > QMAX = 64 query rows per kv head:
    floor(64 / G) tokens a launch, the chunks covering the T tokens once,
    in order; the plain version applied per chunk at positions + its first
    token equals the whole call bit for bit. G > 64 is refused."""
    chunks = ta8.token_chunks(g, t_q)
    assert [i for t0, n in chunks for i in range(t0, t0 + n)] \
        == list(range(t_q))
    assert all(1 <= n and g * n <= ta8.QMAX for _, n in chunks)
    assert len(chunks) == -(-t_q // (ta8.QMAX // g))
    rng = np.random.default_rng(g + t_q)
    s, b, hkv = 96, 2, 1
    kc = torch.from_numpy(rng.integers(-127, 128, (1, b, hkv, s, D))
                          .astype(np.int8))
    vc = torch.from_numpy(rng.integers(-127, 128, (1, b, hkv, s, D))
                          .astype(np.int8))
    ks = torch.from_numpy(rng.random((1, b, hkv, s)) * 0.02 + 1e-3).to(
        torch.bfloat16)
    vs = torch.from_numpy(rng.random((1, b, hkv, s)) * 0.02 + 1e-3).to(
        torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((b, t_q, g * hkv, D)).astype(
        np.float32))
    pos = torch.tensor([0, s - t_q], dtype=torch.int32)
    whole = ta8.int8_decode_attention_stacked_plain(q, kc, ks, vc, vs, 0,
                                                    pos)
    parts = torch.cat([ta8.int8_decode_attention_stacked_plain(
        q[:, t0:t0 + n], kc, ks, vc, vs, 0, pos + t0) for t0, n in chunks],
        dim=1)
    assert torch.equal(parts, whole)
    with pytest.raises(ValueError):
        ta8.token_chunks(ta8.QMAX + 1, 1)


def test_decode_slots_verify_is_one_k4a_call_per_layer(monkeypatch):
    """The T=5 verify of ``llama.decode_slots`` on the tiny packed model with
    an int8 cache: one K4a call per layer, and logits and cache equal bit
    for bit to the loop it replaced (one K4a call per query token)."""
    cfg = tl.LlamaConfig.tiny(num_key_value_heads=2)
    params = tl.quantize_params_packed(
        tl.init_params(cfg, 0, device="cpu"), cfg, device="cpu")
    b, s, t_q = 3, 32, 5
    rng = np.random.default_rng(11)
    shape = (cfg.num_hidden_layers, b, 2, s, cfg.head_dim)
    cache = {"k_codes": rng.integers(-127, 128, shape).astype(np.int8),
             "v_codes": rng.integers(-127, 128, shape).astype(np.int8),
             "k_scale": (rng.random(shape[:-1]) * 0.02 + 1e-3).astype(
                 ml_dtypes.bfloat16),
             "v_scale": (rng.random(shape[:-1]) * 0.02 + 1e-3).astype(
                 ml_dtypes.bfloat16)}
    c1 = {k: to_torch(v) for k, v in cache.items()}
    c2 = {k: v.clone() for k, v in c1.items()}
    ids = torch.from_numpy(rng.integers(0, 512, (b, t_q)).astype(np.int32))
    pos = torch.tensor([0, 9, s - t_q], dtype=torch.int32)

    def per_query(idx, q, k, v):
        """decode_slots' T > 1 step before one call took every query."""
        rows = torch.arange(b)[:, None]
        posmat = pos.long()[:, None] + torch.arange(t_q)
        kc, ksc = tkv.quantize_kv_headmajor(k)
        vc, vsc = tkv.quantize_kv_headmajor(v)
        for name, val in (("k_codes", kc), ("k_scale", ksc),
                          ("v_codes", vc), ("v_scale", vsc)):
            c2[name][idx][rows, :, posmat] = val.transpose(1, 2)
        return torch.stack([ta8.int8_decode_attention_stacked(
            q[:, i], c2["k_codes"], c2["k_scale"], c2["v_codes"],
            c2["v_scale"], idx, pos + i) for i in range(t_q)], dim=1)

    before = tl.decode_step(params, ids, cfg, pos, per_query)
    calls = []
    k4a = ta8.int8_decode_attention_stacked

    def counting(q, *args):
        calls.append(tuple(q.shape))
        return k4a(q, *args)

    monkeypatch.setattr(ta8, "int8_decode_attention_stacked", counting)
    now = tl.decode_slots(params, ids, cfg, c1, pos)
    assert calls == [(b, t_q, cfg.num_attention_heads, cfg.head_dim)] \
        * cfg.num_hidden_layers
    assert torch.equal(now, before)
    for name in c1:
        assert torch.equal(bits(c1[name]), bits(c2[name])), name
