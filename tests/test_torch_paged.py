"""The port's paged serving (device="cpu", the plain kernel versions)
against mxq_tpu's, from numpy seeds at the tiny preset:

- PagedPool accounting and the prefix index under one scripted sequence;
- the pool writes, scatters and gathers, bit-equal;
- the plain K9/K10/K11 against JAX's kernels in interpret mode (ctx rel
  <= 1e-3; the pools K11 writes bit-equal outside the null page, where the
  TPU kernel parks its idle write windows);
- one paged decode step, and PagedEngine greedy tokens token for token,
  with slot reuse, prefix caching and admit rollback; cli serve --paged.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mxq_tpu.models import llama as jl
from mxq_tpu.ops import attn_int8 as ja8
from mxq_tpu.serving import kvcache as jkv
from mxq_tpu.serving import paged as jpg
from mxq_tpu_torch import weights
from mxq_tpu_torch.models import llama as tl
from mxq_tpu_torch.ops import attn_int8 as ta8
from mxq_tpu_torch.serving import kvcache as tkv
from mxq_tpu_torch.serving import paged as tpg
from torch_port_helpers import bits, port_params, rel, to_torch

JCFG = jl.LlamaConfig.tiny()
TCFG = tl.LlamaConfig.tiny()
BF = ml_dtypes.bfloat16
PS8 = ta8.PAGE_INT8


def _pools(total_pages=10, page_size=16, max_len=64, kv_bits=32, slots=3):
    jp = jpg.PagedPool.create(JCFG, num_slots=slots, total_pages=total_pages,
                              page_size=page_size, max_len=max_len,
                              kv_bits=kv_bits)
    tp = tpg.PagedPool.create(TCFG, num_slots=slots, total_pages=total_pages,
                              page_size=page_size, max_len=max_len,
                              kv_bits=kv_bits, device="cpu")
    return jp, tp


def _same_accounting(jp, tp):
    jp._lazy_prefix_state()
    np.testing.assert_array_equal(tp.page_tables, jp.page_tables)
    np.testing.assert_array_equal(tp.lengths, jp.lengths)
    np.testing.assert_array_equal(tp.refs, jp.refs)
    assert tp.free_pages == jp.free_pages
    assert tp.prefix_index == jp.prefix_index
    assert tp.page_key == jp.page_key


def test_pool_accounting_and_prefix_index_match_jax():
    """One scripted sequence of ensure_capacity / acquire_cached /
    register_prefix / release (with prefix reuse, cannibalization of a
    cached page and exhaustion) leaves both pools' books equal."""
    jp, tp = _pools()

    def attach(pool, slot, j, h):
        p = pool.acquire_cached(h)
        if p is not None:
            pool.page_tables[slot, j] = p
        return p

    script = [
        lambda p: p.ensure_capacity(0, 40),
        lambda p: p.register_prefix(b"h1", int(p.page_tables[0, 0])),
        lambda p: p.register_prefix(b"h2", int(p.page_tables[0, 1])),
        lambda p: p.register_prefix(b"h1", 9),        # first entry stays
        lambda p: p.ensure_capacity(1, 20),
        lambda p: attach(p, 2, 0, b"h1"),             # refs 2
        lambda p: attach(p, 2, 1, b"nope"),           # miss
        lambda p: p.release(0),                       # h2's page freed
        lambda p: attach(p, 2, 1, b"h2"),             # back from free list
        lambda p: p.ensure_capacity(2, 64),
        lambda p: p.ensure_capacity(1, 64),           # takes what is left
        lambda p: p.release(2),
        lambda p: p.ensure_capacity(0, 64),           # cannibalizes h1/h2
    ]
    for step, fn in enumerate(script):
        assert fn(tp) == fn(jp), step
        _same_accounting(jp, tp)
    for pool in (jp, tp):
        with pytest.raises(RuntimeError, match="exhausted"):
            pool.ensure_capacity(2, 64)
    _same_accounting(jp, tp)
    for slot in range(3):
        tp.release(slot)
        jp.release(slot)
    _same_accounting(jp, tp)


def _random_pool(rng, jp, tp):
    """Random pool content, the same on both sides."""
    def fill(pages):
        if isinstance(pages, dict):
            return {"codes": rng.integers(-127, 128, pages["codes"].shape)
                    .astype(np.int8),
                    "scales": (rng.random(pages["scales"].shape) * 0.02
                               + 1e-3).astype(BF)}
        return rng.standard_normal(pages.shape).astype(BF)
    k, v = fill(jp.k_pages), fill(jp.v_pages)
    jp.k_pages = jax.tree.map(jnp.asarray, k)
    jp.v_pages = jax.tree.map(jnp.asarray, v)
    weights.pool_from_numpy(tp, k, v)


def _same_pool(jpages, tpages):
    pairs = ([(jpages[n], tpages[n]) for n in ("codes", "scales")]
             if isinstance(tpages, dict) else [(jpages, tpages)])
    for j, t in pairs:
        assert torch.equal(bits(t), bits(to_torch(j)))


@pytest.mark.parametrize("kv_bits", [32, 8])
def test_write_scatter_gather_bit_equal(kv_bits):
    rng = np.random.default_rng(kv_bits)
    ps = 16 if kv_bits == 32 else PS8
    jp, tp = _pools(total_pages=6, page_size=ps, max_len=4 * ps,
                    kv_bits=kv_bits)
    _random_pool(rng, jp, tp)
    l, kvh, d = 2, TCFG.num_key_value_heads, TCFG.head_dim
    # write_tokens, one token per slot in every layer
    k = rng.standard_normal((3, kvh, d)).astype(np.float32)
    v = rng.standard_normal((3, kvh, d)).astype(np.float32)
    pids, offs = np.array([1, 4, 2], np.int32), np.array([0, 5, ps - 1],
                                                        np.int32)
    for idx in range(l):
        jp.k_pages, jp.v_pages = jpg.write_tokens(
            jp.k_pages, jp.v_pages, jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(pids), jnp.asarray(offs), layer_idx=jnp.int32(idx),
            pages_per_layer=6)
        out = tpg.write_tokens(tp.k_pages, tp.v_pages, torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(pids),
                               torch.from_numpy(offs), layer_idx=idx,
                               pages_per_layer=6)
        assert out[0] is tp.k_pages and out[1] is tp.v_pages
    _same_pool(jp.k_pages, tp.k_pages)
    _same_pool(jp.v_pages, tp.v_pages)
    # a prefill chunk of two pages at row offset ps, scattered and gathered
    t = 2 * ps
    buf = rng.standard_normal((l, 1, 3 * ps, kvh, d)).astype(BF)
    dest = np.array([3, 5], np.int32)
    table = np.array([1, 3, 5, 0], np.int32)
    if kv_bits == 8:
        jp.k_pages = jpg._scatter_quant(jp.k_pages, jnp.asarray(buf), t, ps,
                                        jnp.asarray(dest), 6, offset=ps)
        tpg._scatter_quant(tp.k_pages, to_torch(buf), t, ps,
                           torch.from_numpy(dest), 6, offset=ps)
        _same_pool(jp.k_pages, tp.k_pages)
    for pages in ("k_pages", "v_pages"):
        gj = jpg._gather_dense(getattr(jp, pages), jnp.asarray(table), l,
                               kvh, d, ps, 6)
        gt = tpg._gather_dense(getattr(tp, pages), torch.from_numpy(table),
                               l, kvh, d, ps, 6)
        assert gt.shape == (l, 1, 4 * ps, kvh, d)
        assert torch.equal(bits(gt), bits(to_torch(gj)))


@pytest.mark.parametrize("kv_bits", [32, 8])
def test_paged_attend_matches_jax(kv_bits):
    """paged_attend over the folded pool with physical tables: K9 on the
    int8 pool, the gather-and-mask reference on the bf16 pool."""
    rng = np.random.default_rng(3 + kv_bits)
    ps = 16 if kv_bits == 32 else PS8
    jp, tp = _pools(total_pages=6, page_size=ps, max_len=2 * ps,
                    kv_bits=kv_bits)
    _random_pool(rng, jp, tp)
    q = rng.standard_normal((3, TCFG.num_attention_heads,
                             TCFG.head_dim)).astype(np.float32)
    tables = np.array([[7, 8], [9, 0], [10, 11]], np.int32)   # layer 1
    lengths = np.array([ps + 5, 1, 2 * ps], np.int32)
    oj = jpg.paged_attend(jnp.asarray(q), jp.k_pages, jp.v_pages,
                          jnp.asarray(lengths), jnp.asarray(tables))
    ot = tpg.paged_attend(torch.from_numpy(q), tp.k_pages, tp.v_pages,
                          torch.from_numpy(lengths), torch.from_numpy(tables))
    assert ot.shape == q.shape and ot.dtype == torch.float32
    assert rel(ot, oj) <= 1e-3


def _kernel_inputs(seed, g, d, plist, hkv=2, pps=3, lp=24):
    """Shuffled physical tables (null page 0 past each position's page)."""
    rng = np.random.default_rng(seed)
    b = len(plist)
    scales = lambda *s: (rng.random(s) * 0.02 + 1e-3).astype(BF)  # noqa
    codes = lambda *s: rng.integers(-127, 128, s).astype(np.int8)  # noqa
    tables = (rng.permutation(lp - 1)[:b * pps] + 1).reshape(b, pps)
    for i, p in enumerate(plist):
        tables[i, p // PS8 + 1:] = 0
    return dict(q=rng.standard_normal((b, hkv * g, d)).astype(np.float32),
                kp=codes(hkv, lp, PS8, d), ks=scales(hkv, lp, 1, PS8),
                vp=codes(hkv, lp, PS8, d), vs=scales(hkv, lp, 1, PS8),
                kcur=codes(b, hkv, d), kscur=scales(b, hkv),
                vcur=codes(b, hkv, d), vscur=scales(b, hkv),
                pos=np.asarray(plist, np.int32),
                tables=tables.astype(np.int32))


@pytest.mark.parametrize("g,d", [(1, 64), (4, 64), (1, 128), (4, 128)])
def test_plain_paged_kernels_match_jax(g, d):
    """K9, K10, K11 plain vs mxq_tpu's (interpret mode) at positions 0, 1,
    127, 128 and the last row; K11's written pools bit-equal."""
    a = _kernel_inputs(g * d, g, d, [0, 1, 127, 128, 3 * PS8 - 1])
    t = {k: to_torch(v) for k, v in a.items()}
    pool_j = [jnp.asarray(a[k]) for k in ("kp", "ks", "vp", "vs")]
    cur_j = [jnp.asarray(a[k]) for k in ("kcur", "kscur", "vcur", "vscur")]
    pool_t = [t[k] for k in ("kp", "ks", "vp", "vs")]
    cur_t = [t[k] for k in ("kcur", "kscur", "vcur", "vscur")]
    q, pos, tab = jnp.asarray(a["q"]), jnp.asarray(a["pos"]), \
        jnp.asarray(a["tables"])
    j9 = ja8.int8_paged_decode_attention(q, *pool_j, pos + 1, tab)
    t9 = ta8.int8_paged_decode_attention(t["q"], *pool_t, t["pos"] + 1,
                                         t["tables"])
    assert rel(t9, j9) <= 1e-3
    j10 = ja8.int8_paged_decode_attention_cur(q, *pool_j, *cur_j, pos, tab)
    t10 = ta8.int8_paged_decode_attention_cur(t["q"], *pool_t, *cur_t,
                                              t["pos"], t["tables"])
    assert rel(t10, j10) <= 1e-3
    j11 = ja8.int8_paged_decode_attend_update(
        q, *pool_j, *cur_j, pos, tab, jnp.zeros(len(a["pos"]), jnp.int32))
    mine = [p.clone() for p in pool_t]
    t11 = ta8.int8_paged_decode_attend_update(t["q"], *mine, *cur_t,
                                              t["pos"], t["tables"])
    assert t11[0].shape == t["q"].shape and t11[0].dtype == torch.float32
    assert all(x is y for x, y in zip(t11[1:], mine))       # in place
    assert rel(t11[0], j11[0]) <= 1e-3
    for jw, tw in zip(j11[1:], mine):
        assert torch.equal(bits(tw[:, 1:]), bits(to_torch(jw)[:, 1:]))
    # and the port leaves the null page alone
    for before, after in zip(pool_t, mine):
        assert torch.equal(bits(after[:, 0]), bits(before[:, 0]))


def test_k11_plain_is_write_then_k9_and_skips_the_null_page():
    a = _kernel_inputs(7, 4, 128, [0, 5, 128, 200, 383])
    t = {k: to_torch(v) for k, v in a.items()}
    pool = [t[k] for k in ("kp", "ks", "vp", "vs")]
    cur = [t[k] for k in ("kcur", "kscur", "vcur", "vscur")]
    for p in (pool[1], pool[3]):
        p[:, 0] = float("nan")                 # the null page's scales
    fused = [p.clone() for p in pool]
    ctx = ta8.int8_paged_decode_attend_update(t["q"], *fused, *cur, t["pos"],
                                              t["tables"])[0]
    ta8._paged_write_plain(*pool, *cur, t["pos"], t["tables"])
    ref = ta8.int8_paged_decode_attention(t["q"], *pool, t["pos"] + 1,
                                          t["tables"])
    assert bool(torch.isfinite(ctx).all())
    assert rel(ctx, ref) <= 1e-2          # bf16(p * v_scale) rounding points
    for x, y in zip(fused, pool):
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))


def test_cpu_calls_launch_nothing():
    a = _kernel_inputs(3, 1, 64, [4, 9])
    t = {k: to_torch(v) for k, v in a.items()}
    fns = [ta8.KERNELS[k] for k in ("K9", "K10", "K11")]
    before = [f.launches for f in fns]
    pool = [t[k] for k in ("kp", "ks", "vp", "vs")]
    cur = [t[k] for k in ("kcur", "kscur", "vcur", "vscur")]
    ta8.int8_paged_decode_attention(t["q"], *pool, t["pos"], t["tables"])
    ta8.int8_paged_decode_attention_cur(t["q"], *pool, *cur, t["pos"],
                                        t["tables"])
    ta8.int8_paged_decode_attend_update(t["q"], *pool, *cur, t["pos"],
                                        t["tables"])
    assert [f.launches for f in fns] == before


@pytest.fixture(scope="module")
def packed():
    """The tiny packed model on both sides."""
    jp = jl.quantize_params_packed(jl.init_params(JCFG, jax.random.PRNGKey(0)),
                                   JCFG)
    return jp, port_params(jp)


@pytest.mark.parametrize("kv_bits", [32, 8])
def test_paged_decode_step_matches_jax(packed, kv_bits):
    """One decode step for 3 slots from one random pool state. Logits rel
    measured 1.7e-3 (bf16 pool) and 5.9e-3 (int8 pool, where a K/V value
    on a rounding boundary can also take the neighbouring code): queue 3's
    bf16-activation gap, gate 1e-2; the greedy tokens agree."""
    jparams, tparams = packed
    rng = np.random.default_rng(11)
    ps = 16 if kv_bits == 32 else PS8
    jp, tp = _pools(total_pages=8, page_size=ps, max_len=2 * ps,
                    kv_bits=kv_bits)
    _random_pool(rng, jp, tp)
    tables = np.array([[1, 2], [3, 0], [5, 6]], np.int32)
    pos = np.array([ps + 3, 7, 2 * ps - 1], np.int32)
    toks = rng.integers(0, 512, (3, 1)).astype(np.int32)
    pids = tables[np.arange(3), pos // ps]
    args = (toks, pos, pos + 1, tables, pids, pos % ps)
    lj, _, _ = jpg.paged_decode_step(jparams, jp.k_pages, jp.v_pages,
                                     *map(jnp.asarray, args), JCFG)
    lt, tk, _ = tpg.paged_decode_step(tparams, tp.k_pages, tp.v_pages,
                                      *map(torch.from_numpy,
                                           (toks, pos, tables)), TCFG)
    assert tk is tp.k_pages and lt.shape == (3, 512)
    assert rel(lt, lj) <= 1e-2
    assert (lt.argmax(-1).numpy() == np.asarray(lj).argmax(-1)).all()


@pytest.mark.parametrize("kv_bits", [32, 8])
def test_forward_one_token_with_cache_is_decode_slots(packed, kv_bits):
    """``llama.forward``'s one-token step over a slot cache is
    ``llama.decode_slots`` at row ``cache_pos`` of every slot (equal logits
    and caches), and agrees with JAX's forward from the same prompt
    (rel <= 1e-2, queue 3's bf16-activation gap)."""
    jparams, tparams = packed
    b, t0, s = 2, 5, 16
    ids = np.random.default_rng(12).integers(0, 512, (b, t0 + 1)).astype(
        np.int32)
    if kv_bits == 8:
        shape = (JCFG.num_hidden_layers, b, s, JCFG.num_key_value_heads,
                 JCFG.head_dim)
        jc = jkv.init_quant_cache(*shape)
        tc = tkv.init_quant_cache(*shape, device="cpu")
    else:
        jc = jl.init_cache(JCFG, b, s)
        tc = tl.init_cache(TCFG, b, s, device="cpu")
    _, jc = jl.forward(jparams, jnp.asarray(ids[:, :t0]), JCFG, caches=jc,
                       cache_pos=0)
    tl.forward(tparams, ids[:, :t0], TCFG, caches=tc, cache_pos=0,
               device="cpu")
    twin = {k: v.clone() for k, v in tc.items()}
    lj, _ = jl.forward(jparams, jnp.asarray(ids[:, t0:]), JCFG, caches=jc,
                       cache_pos=t0)
    lt, _ = tl.forward(tparams, ids[:, t0:], TCFG, caches=tc, cache_pos=t0,
                       device="cpu")
    ld = tl.decode_slots(tparams, torch.from_numpy(ids[:, t0:]), TCFG, twin,
                         torch.full((b,), t0, dtype=torch.int32))
    assert torch.equal(lt, ld)
    assert all(torch.equal(tc[k], twin[k]) for k in tc)
    assert rel(lt, lj) <= 1e-2


def _margin(tparams, prompt, common):
    """top-1 minus top-2 logit of the port's no-cache forward at the first
    token where two greedy runs part."""
    ids = np.concatenate([prompt, np.asarray(common, np.int32)])[None]
    logits, _ = tl.forward(tparams, ids, TCFG, device="cpu")
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


def _requests():
    """Five requests through two slots: 0 and 3 share their first 132
    tokens, 4 repeats 0 exactly (prefix hits on both pools), 1 and 2 are
    short."""
    rng = np.random.default_rng(5)
    base = rng.integers(1, 512, 150).astype(np.int32)
    other = base.copy()
    other[132:] = rng.integers(1, 512, 18)
    return [(base, 5), (rng.integers(1, 512, 9).astype(np.int32), 7),
            (rng.integers(1, 512, 20).astype(np.int32), 3), (other, 6),
            (base.copy(), 5)]


def _serve(mod, params, cfg, kv_bits, on_engine=None, **kw):
    e = mod.PagedEngine(params, cfg, num_slots=2, total_pages=40,
                        page_size=16, max_len=256, prefill_bucket=64,
                        kv_bits=kv_bits, **kw)
    if on_engine is not None:
        on_engine(e)
    hits = []
    acquire = e.pool.acquire_cached

    def counted(h):
        p = acquire(h)
        hits.append(p is not None)
        return p
    e.pool.acquire_cached = counted
    reqs = [e.submit(p, max_new_tokens=n) for p, n in _requests()]
    done = e.run()
    assert len(done) == len(reqs)
    assert (e.pool.page_tables == 0).all() and not e.pool.refs.any()
    return e, [list(r.generated) for r in reqs], sum(hits)


@pytest.fixture(scope="module")
def jax_runs(packed):
    jparams, _ = packed
    return {kv: _serve(jpg, jparams, JCFG, kv)[1:] for kv in (32, 8)}


@pytest.mark.parametrize("kv_bits", [32, 8])
def test_paged_engine_greedy_tokens_equal_jax(packed, jax_runs, kv_bits,
                                              monkeypatch):
    """Tokens token for token, equal prefix-cache hits, every page back in
    the pool; on the int8 pool every decode write lands on a page that
    only its own sequence holds (refcount 1)."""
    _, tparams = packed
    want, want_hits = jax_runs[kv_bits]
    writes = []
    engine = {}
    k11 = ta8.int8_paged_decode_attend_update

    def checked(q, kp, ks, vp, vs, kc, kss, vc, vss, positions, tables):
        pool = engine["e"].pool
        ppl = pool.pages_per_layer
        for b, p in enumerate(positions.tolist()):
            if p // PS8 < tables.shape[1]:
                page = int(tables[b, p // PS8]) % ppl
                if page:
                    writes.append(int(pool.refs[page]))
        return k11(q, kp, ks, vp, vs, kc, kss, vc, vss, positions, tables)
    monkeypatch.setattr(ta8, "int8_paged_decode_attend_update", checked)
    e, got, hits = _serve(tpg, tparams, TCFG, kv_bits, device="cpu",
                          on_engine=lambda e: engine.update(e=e))
    for (prompt, _), g, w in zip(_requests(), got, want):
        if g != w:
            i = next(i for i, (x, y) in enumerate(zip(g, w)) if x != y)
            pytest.fail(f"tokens part at {i}: port {g}, JAX {w}; logit "
                        f"margin {_margin(tparams, prompt, g[:i]):.3g}")
    assert hits == want_hits and hits == e.stats()["prefix_pages_hit"] > 0
    assert got[4] == got[0]
    if kv_bits == 8:
        assert writes and set(writes) == {1}
    st = e.stats()
    assert st["requests_finished"] == 5
    assert st["tokens_generated"] == sum(n for _, n in _requests())


def test_admit_rollback_on_pool_exhaustion_matches_jax(packed):
    """Request 2 shares request 1's two prefix pages but cannot get its
    tail page: the admit raises, the slot's table is cleared, the refs
    return to request 1's, and the request is queued again, on both
    sides."""
    jparams, tparams = packed
    prompt = (np.arange(36, dtype=np.int32) % 50) + 3
    books = []
    for mod, params, cfg, kw in ((jpg, jparams, JCFG, {}),
                                 (tpg, tparams, TCFG, {"device": "cpu"})):
        e = mod.PagedEngine(params, cfg, num_slots=2, total_pages=4,
                            page_size=16, max_len=48, prefill_bucket=16,
                            **kw)
        r1 = e.submit(prompt, max_new_tokens=2)
        e._admit([])
        assert e.slot_req[0] is r1
        r2 = e.submit(prompt, max_new_tokens=2)
        with pytest.raises(RuntimeError, match="exhausted"):
            e._admit([])
        assert e.queue == [r2] and (e.pool.page_tables[1] == 0).all()
        books.append((e.pool.page_tables.copy(), e.pool.refs.copy(),
                      list(e.pool.free_pages), r1.generated))
    for a, b in zip(*books):
        np.testing.assert_array_equal(a, b)


def test_cli_serve_paged_on_cpu():
    from mxq_tpu_torch import cli
    base = ["serve", "--device", "cpu", "--preset", "tiny", "--packed",
            "--slots", "2", "--max_len", "256", "--requests", "3",
            "--max_new_tokens", "3", "--paged"]
    for kv in ("8", "32"):
        out = cli.main(base + ["--kv_bits", kv])
        assert out["requests"] == 3 and out["tokens"] == 9
        assert out["stats"]["requests_finished"] == 3
    for extra in (["--spec_decode"], ["--kv_bits", "4"]):
        with pytest.raises(SystemExit):
            cli.main(base + extra)


def test_paged_entry_points_default_to_cuda(packed):
    """Without a CUDA device, the pool and the engine called without a
    device raise instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    _, tparams = packed
    with pytest.raises(RuntimeError, match="CUDA"):
        tpg.PagedPool.create(TCFG, num_slots=1, total_pages=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpg.PagedEngine(tparams, TCFG, num_slots=1, total_pages=2)
