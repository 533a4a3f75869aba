"""Head dims past 256, the wide path's, on the CPU, where the wrappers take
their plain versions, against mxq_tpu from numpy seeds (synthetic widths:
no public Llama configuration has D > 256, but mxq_tpu takes any D):

- the int8 family (K4, K4a-K4d, K9-K11) at D = 300, 384 and 512 against
  mxq_tpu's dequantize-then-attend oracle: the history alone, the current
  token spliced in, and the paged pool (1e-3 of max|ctx|, the gate at D
  <= 256: the plain versions round p * v_scale to bf16, the oracle not);
- K12's plain version against ``_paged_attend_reference`` at D = 384 and
  512, float32 and bf16 q;
- K13 and K13-bwd through the port's attention (``attn_impl="flash"``,
  autograd) against mxq_tpu's XLA path and ``jax.grad`` at D = 384 and
  512, G = 2, with the D = 256 test's gates;
- numpy-free torch emulations of each wide kernel's schedule (the int8
  scores summed over 256-column chunks in chunk order, the context per
  column chunk; K12's scores over all of D in every 128-column chunk and
  its ordered split combine; K13's and K13-bwd's thread-block clusters,
  a block per 256-column range, the scores (and dP) summed over the
  cluster's partials in rank order and shared by every block, each
  block's range of the output, past 2048 columns in groups of 8 ranges)
  equal to the plain versions within 1e-6 (K13-bwd's emulation within
  1e-6 of the plain version's formulas in float64, and the plain version
  within 2e-6 of them);
- greedy tokens of the slot Engine and the PagedEngine (int8 and bf16
  caches and pools) equal mxq_tpu's at D = 512 (hidden 1024 over 2
  heads, 1 kv head, 2 layers).
The same functions at D <= 256 are in ``test_torch_head_dims.py``, whose
checks this file runs at the wide D.
"""

import math

import jax
import numpy as np
import pytest
import torch

import test_torch_head_dims as hd
from mxq_tpu.models import llama as jl
from mxq_tpu.serving import engine as jeng
from mxq_tpu.serving import paged as jpg
from mxq_tpu_torch.models import llama as tl
from mxq_tpu_torch.ops import attn_bf16 as ab
from mxq_tpu_torch.ops import attn_int8 as ta8
from mxq_tpu_torch.serving import engine as teng
from mxq_tpu_torch.serving import paged as tpg
from torch_port_helpers import port_params, rel

WIDE = [300, 384, 512]
CHUNK_GATE = 1e-6
RANGE = 256     # columns of a block's range (flash_attn_wide.cu's DR)
CLUSTER = 8     # blocks of a cluster at most (its CMAX)
# flash_attention_bwd_plain's float32 gradients from the same formulas in
# float64, over each gradient's max (measured at most 1.83e-6, at D = 640)
PLAIN_BWD_GATE = 2e-6


# ---------------------------------------------------------------------------
# the plain versions against mxq_tpu at the wide D
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", WIDE)
def test_int8_dense_plain_matches_jax_oracle_wide(d):
    """K4a/K4c, K4b/K4d and K4 against the oracle (the current row
    spliced in), K4's written rows, at D = 300, 384 and 512."""
    hd.test_int8_dense_plain_matches_jax_oracle(d)


@pytest.mark.parametrize("d", WIDE)
def test_int8_paged_plain_matches_jax_oracle_wide(d):
    """K9, K10 and K11 on the paged pool against the oracle over the
    gathered pages, K11's written rows and scales, at D = 300, 384 and
    512."""
    hd.test_int8_paged_plain_matches_jax_oracle(d)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [384, 512])
def test_k12_plain_matches_jax_reference_wide(d, q_dtype):
    """K12's plain version against ``_paged_attend_reference`` (float32 q
    within 1e-5, bf16 q within one ulp), G = 2 over 2 kv heads."""
    hd.test_k12_plain_matches_jax_reference_past_128(2, d, q_dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [384, 512])
def test_k13_and_bwd_plain_match_jax_xla_attention_wide(d, dtype):
    """A layer's attention at hidden 2D over 2 heads and 1 kv head (G =
    2), 160 tokens from position 0: the port through K13's plain version
    under autograd (K13-bwd's plain version as its backward) against
    mxq_tpu's einsum path, the output and the input's gradient, with the
    gates of the D = 256 test (float32 1e-5 and 1e-4, bf16 2e-2)."""
    jax_np = jax.numpy
    kw = dict(hidden_size=2 * d, num_attention_heads=2,
              num_key_value_heads=1, intermediate_size=512)
    jcfg = jl.LlamaConfig.tiny(attn_impl="xla", **kw)
    tcfg = tl.LlamaConfig.tiny(attn_impl="flash", **kw)
    assert tcfg.head_dim == d
    jp = jl.init_params(jcfg, jax.random.PRNGKey(d))
    tp = port_params(jp)
    jt, tt = (jax_np.float32, torch.float32) if dtype == "float32" \
        else (jax_np.bfloat16, torch.bfloat16)
    jlayer = {k: jax.tree_util.tree_map(lambda a: a[0].astype(jt), v)
              for k, v in jp["layers"].items()}
    tlayer = {k: v.to(tt) for k, v in tl.layer_view(tp, 0).items()}
    b, t, width = 2, 160, 2 * d
    rng = np.random.default_rng(d)
    x = rng.standard_normal((b, t, width)).astype(np.float32)
    c = rng.standard_normal((b, t, width)).astype(np.float32)
    pos = jax_np.broadcast_to(jax_np.arange(t)[None], (b, t))
    jcos, jsin = jl.rope_tables(jcfg, pos)
    tcos, tsin = tl.rope_tables(tcfg, torch.arange(t)[None].expand(b, t))

    def jout(h):
        return jl.attention(h, jlayer, jcfg, jcos, jsin,
                            jl.causal_mask(t))[0]
    xj = jax_np.asarray(x).astype(jt)
    oj = jout(xj)
    gj = jax.grad(lambda h: jax_np.sum(jout(h).astype(jax_np.float32)
                                       * jax_np.asarray(c)))(xj)
    xt = torch.from_numpy(np.asarray(xj.astype(jax_np.float32))).to(tt) \
        .requires_grad_()
    ot = tl.attention(xt, tlayer, tcfg, tcos, tsin, tl.causal_mask(t))
    (ot.float() * torch.from_numpy(c)).sum().backward()
    out_gate, grad_gate = (1e-5, 1e-4) if dtype == "float32" else (2e-2,
                                                                   2e-2)
    assert ot.dtype == tt and xt.grad.dtype == tt
    assert rel(ot.detach(), np.asarray(oj.astype(jax_np.float32))) \
        <= out_gate
    assert rel(xt.grad, np.asarray(gj.astype(jax_np.float32))) <= grad_gate


# ---------------------------------------------------------------------------
# the wide kernels' schedules, emulated, against the unchunked plain versions
# ---------------------------------------------------------------------------


def _chunks(d, c):
    return [(c0, min(c0 + c, d)) for c0 in range(0, d, c)]


@pytest.mark.parametrize("cur", [False, True])
@pytest.mark.parametrize("d", [257, 300, 512])
def test_int8_wide_schedule_equals_plain(d, cur):
    """The int8 wide path (``attn_int8_wide.cu``): each score is the sum
    of its 256-column chunks' dot products in chunk order, then times
    k_scale / sqrt(D); the probabilities (max, exp, bf16(p * v_scale)) of
    the whole row; the context per 256-column chunk. Against
    ``_attend_plain`` (K4a's and K4b's plain math) within 1e-6 of
    max|ctx|."""
    gen = torch.Generator().manual_seed(d)
    b, hkv, g, s = 2, 2, 4, 300
    q = torch.randn((b, hkv, g, d), generator=gen).to(torch.bfloat16)
    kc = torch.randint(-127, 128, (b, hkv, s, d), generator=gen,
                       dtype=torch.int8)
    vc = torch.randint(-127, 128, (b, hkv, s, d), generator=gen,
                       dtype=torch.int8)
    ks = (torch.rand((b, hkv, s), generator=gen) * 0.02 + 1e-3).to(
        torch.bfloat16)
    vs = (torch.rand((b, hkv, s), generator=gen) * 0.02 + 1e-3).to(
        torch.bfloat16)
    pos = torch.tensor([5, 290], dtype=torch.int32)
    curt = None
    if cur:
        curt = (torch.randint(-127, 128, (b, hkv, 1, d), generator=gen,
                              dtype=torch.int8),
                (torch.rand((b, hkv, 1), generator=gen) * 0.02 + 1e-3)
                .to(torch.bfloat16),
                torch.randint(-127, 128, (b, hkv, 1, d), generator=gen,
                              dtype=torch.int8),
                (torch.rand((b, hkv, 1), generator=gen) * 0.02 + 1e-3)
                .to(torch.bfloat16))
    want = ta8._attend_plain(q, kc, ks, vc, vs, pos, curt)
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    dots = torch.zeros((b, hkv, g, s))
    dcur = torch.zeros((b, hkv, g, 1))
    for c0, c1 in _chunks(d, ta8.WIDE_CHUNK):
        dots = dots + torch.einsum("bhgd,bhsd->bhgs", qf[..., c0:c1],
                                   kc[..., c0:c1].float())
        if cur:
            dcur = dcur + torch.einsum("bhgd,bhsd->bhgs", qf[..., c0:c1],
                                       curt[0][..., c0:c1].float())
    st = dots * (ks.float() * scale)[:, :, None, :]
    kpos = torch.arange(s)[None, None, None, :]
    pp = pos[:, None, None, None]
    st = torch.where(kpos < pp if cur else kpos <= pp, st, ta8.NEG)
    m = st.amax(-1, keepdim=True)
    if cur:
        stc = dcur * (curt[1].float() * scale)[:, :, None, :]
        m = torch.maximum(m, stc)
    p = torch.exp(st - m)
    den = p.sum(-1, keepdim=True)
    pv = (p * vs.float()[:, :, None, :]).to(torch.bfloat16).float()
    ctx = torch.cat([torch.einsum("bhgs,bhsd->bhgd", pv,
                                  vc[..., c0:c1].float())
                     for c0, c1 in _chunks(d, ta8.WIDE_CHUNK)], -1)
    if cur:
        pc = torch.exp(stc - m)
        den = den + pc
        ctx = ctx + (pc * curt[3].float()[:, :, None, :]).to(
            torch.bfloat16).float() * curt[2].float()
    assert rel(ctx / den, want) <= CHUNK_GATE


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [300, 512])
def test_k12_wide_schedule_equals_plain(d, q_dtype):
    """K12's wide path (``paged_attn_bf16_wide.cu``): per 256-row split
    and 128-column chunk, the split's scores over all of D (the same in
    every chunk), its max and sum, the chunk's partial context; the
    splits combined in order (exp(m_j - M) weights). Against
    ``paged_decode_attention_plain`` within 1e-6 of max|ctx| (f32, before
    the cast to q's type)."""
    gen = torch.Generator().manual_seed(d + 1)
    b, hkv, g, ps, pps = 2, 2, 2, 64, 9
    lens = [1, 513]
    lp = 1 + b * pps
    kp = torch.randn((hkv, lp, ps, d), generator=gen).to(torch.bfloat16)
    vp = torch.randn((hkv, lp, ps, d), generator=gen).to(torch.bfloat16)
    q = torch.randn((b, hkv * g, d), generator=gen).to(q_dtype)
    tables = (torch.randperm(lp - 1, generator=gen)[:b * pps] + 1).reshape(
        b, pps).to(torch.int32)
    lengths = torch.tensor(lens, dtype=torch.int32)
    want = ab.paged_decode_attention_plain(q.float(), kp, vp, lengths,
                                           tables)
    got = torch.zeros_like(want)
    for i, n in enumerate(lens):
        rows = torch.arange(n)
        pages = tables[i, rows // ps].long()
        k = kp[:, pages, rows % ps].float()            # [Hkv, n, D]
        v = vp[:, pages, rows % ps].float()
        qf = q[i].float().reshape(hkv, g, d)
        sc = torch.einsum("hgd,hnd->hgn", qf, k) / math.sqrt(d)
        parts = []
        for r0 in range(0, n, 256):
            s = sc[..., r0:r0 + 256]
            m = s.amax(-1, keepdim=True)
            e = torch.exp(s - m)
            ctx = torch.cat([torch.einsum("hgn,hnd->hgd", e,
                                          v[:, r0:r0 + 256, c0:c1])
                             for c0, c1 in _chunks(d, ab.WIDE_CHUNK)], -1)
            parts.append((m, e.sum(-1, keepdim=True), ctx))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        num = sum(torch.exp(m - mx) * c for m, _, c in parts)
        den = sum(torch.exp(m - mx) * l for m, l, _ in parts)
        got[i] = (num / den).reshape(hkv * g, d)
    assert rel(got, want) <= CHUNK_GATE


def _flash_inputs(gen, t, hq, hkv, d):
    return (torch.randn((1, t, hq, d), generator=gen),
            torch.randn((1, t, hkv, d), generator=gen),
            torch.randn((1, t, hkv, d), generator=gen))


def _clusters(d):
    """K13's and K13-bwd's wide schedule at head_dim d
    (``flash_attn_wide.cu``'s ``set_ranges``): a block per RANGE columns,
    at most CLUSTER a cluster, past that groups of CLUSTER ranges; per
    column group, per block (cluster rank) the ranges its partial walks
    (rank, rank + CLUSTER, ... in that order in every group) and its
    output range (None past the last range)."""
    nr = -(-d // RANGE)
    c = min(nr, CLUSTER)
    ng = -(-nr // c)
    groups = []
    for g in range(ng):
        blocks = []
        for r in range(c):
            out = g * c + r if g * c + r < nr else None
            blocks.append((list(range(r, nr, c)), out))
        groups.append(blocks)
    return groups


def _wg_cols(rg, wg, d):
    """The columns of warpgroup wg (two per block, 128 columns each) of
    range rg, cut at d (empty past it)."""
    c0 = rg * RANGE + wg * RANGE // 2
    return slice(c0, max(c0, min(c0 + RANGE // 2, d)))


def _summed(a, b, blocks, d):
    """a [R, D] . b [N, D]^T as a cluster sums it: each (block, warpgroup)
    a partial over its columns of the block's ranges, a block's two
    partials added into the block's sum, the block sums added in rank
    order; every block gets these bits."""
    total = None
    for own, _ in blocks:
        parts = []
        for wg in (0, 1):
            part = torch.zeros((a.shape[0], b.shape[0]))
            for rg in own:
                c = _wg_cols(rg, wg, d)
                part = part + a[:, c] @ b[:, c].T
            parts.append(part)
        block = parts[0] + parts[1]
        total = block if total is None else total + block
    return total


def _out_cols(blocks, d):
    """The columns each block of a group writes."""
    return [slice(out * RANGE, min((out + 1) * RANGE, d))
            for _, out in blocks if out is not None]


@pytest.mark.parametrize("d", [300, 512, 640, 2304])
def test_k13_wide_schedule_equals_plain(d):
    """K13's wide path (``flash_attn_wide.cu``, float32 arithmetic): an
    item per (64 query rows, head), a cluster of a block per 256-column
    range (two per block at 640 and less: a partial last range; past 2048
    groups of 8 ranges, each group's cluster summing over every range);
    per 64-key tile up to the diagonal S summed over the cluster: each
    block's two warpgroup partials into a block sum, the block sums in
    rank order, the same S in every block,
    the causal mask, the online softmax (running max and sum), each
    block's range of O rescaled and += P V[:, range]; O / l at the end,
    and lse = m + log l from group 0. Against
    ``flash_attention_forward_plain`` (context and lse) within 1e-6."""
    gen = torch.Generator().manual_seed(d + 2)
    t, hq, hkv = 150, 4, 2
    q, k, v = _flash_inputs(gen, t, hq, hkv, d)
    want, want_lse = ab.flash_attention_forward_plain(q, k, v)
    out = torch.zeros_like(want)
    lse = torch.zeros_like(want_lse)
    scale = 1.0 / math.sqrt(d)
    for h in range(hq):
        kh = h // (hq // hkv)
        for q0 in range(0, t, 64):
            rows = torch.arange(q0, min(q0 + 64, t))
            qi = q[0, rows, h]
            for g, blocks in enumerate(_clusters(d)):
                m = torch.full((len(rows), 1), -math.inf)
                l = torch.zeros((len(rows), 1))
                o = torch.zeros((len(rows), d))
                for k0 in range(0, min(q0 + 64, t), 64):
                    keys = torch.arange(k0, min(k0 + 64, t))
                    s = _summed(qi, k[0, keys, kh], blocks, d) * scale
                    s = torch.where(keys[None] <= rows[:, None], s,
                                    -math.inf)
                    mn = torch.maximum(m, s.amax(-1, keepdim=True))
                    alpha = torch.exp(m - mn)
                    p = torch.exp(s - mn)
                    l = l * alpha + p.sum(-1, keepdim=True)
                    for c in _out_cols(blocks, d):
                        o[:, c] = o[:, c] * alpha + p @ v[0, keys, kh, c]
                    m = mn
                for c in _out_cols(blocks, d):
                    out[0, rows, h, c] = o[:, c] / l
                if g == 0:
                    lse[0, h, rows] = (m + torch.log(l))[:, 0]
    assert rel(out, want) <= CHUNK_GATE
    assert float((lse - want_lse).abs().max()) <= CHUNK_GATE * float(
        want_lse.abs().max())


@pytest.mark.parametrize("d", [300, 512, 640, 2304])
def test_k13_bwd_wide_schedule_equals_plain(d):
    """K13-bwd's wide path (float32 arithmetic): di = rowsum(o . dO) over
    all of D; a dQ item per (64 query rows, head), its cluster's blocks
    over D's 256-column ranges (past 2048 a cluster per group of 8
    ranges), per 32-key tile S and dP summed over the
    cluster (each block's two warpgroup partials, then the block sums in
    rank order), dS = P (dP - di) / sqrt(D), each block's range of dQ += dS K[:, range]; a dK/dV item
    per (64 keys, kv head) walks the kv head's query heads in order and
    the 32-row query tiles from the diagonal on, S^T and dP^T summed the
    same way, each block's range of dV += P^T dO[:, range] and of dK +=
    dS^T Q[:, range]. The emulation and ``flash_attention_bwd_plain``
    are each held to the plain version's formulas in float64: the
    emulation within CHUNK_GATE of each gradient's max, the plain version
    within PLAIN_BWD_GATE (its S and dP over all of D in one product; at
    D = 640 it is 1.83e-6 of max|dQ| from the float64 values, at 512
    1.10e-6, where the emulation is at most 7.8e-7)."""
    gen = torch.Generator().manual_seed(d + 3)
    t, hq, hkv, n = 150, 4, 2, 32
    g = hq // hkv
    q, k, v = _flash_inputs(gen, t, hq, hkv, d)
    do = torch.randn((1, t, hq, d), generator=gen)
    o, lse = ab.flash_attention_forward_plain(q, k, v)
    want = ab.flash_attention_bwd_plain(q, k, v, o, lse, do)
    scale = 1.0 / math.sqrt(d)
    di = (o * do).sum(-1)[0]                          # [T, Hq]
    dq, dk, dv = (torch.zeros_like(x) for x in want)
    groups = [(blocks, _out_cols(blocks, d)) for blocks in _clusters(d)]

    def probs(h, qrows, keys, s, dp):
        p = torch.exp(s * scale - lse[0, h, qrows][:, None])
        p = torch.where(keys[None] <= qrows[:, None], p, 0.0)
        return p, p * (dp - di[qrows, h][:, None]) * scale
    for h in range(hq):
        for q0 in range(0, t, 64):
            rows = torch.arange(q0, min(q0 + 64, t))
            acc = torch.zeros((len(rows), d))
            for blocks, outs in groups:
                for k0 in range(0, min(q0 + 64, t), n):
                    keys = torch.arange(k0, min(k0 + n, t))
                    kk, vv = k[0, keys, h // g], v[0, keys, h // g]
                    _, ds = probs(h, rows, keys,
                                  _summed(q[0, rows, h], kk, blocks, d),
                                  _summed(do[0, rows, h], vv, blocks, d))
                    for c in outs:
                        acc[:, c] = acc[:, c] + ds @ kk[:, c]
            dq[0, rows, h] = acc
    for kh in range(hkv):
        for k0 in range(0, t, 64):
            keys = torch.arange(k0, min(k0 + 64, t))
            ak = torch.zeros((len(keys), d))
            av = torch.zeros((len(keys), d))
            for blocks, outs in groups:
                for h in range(kh * g, kh * g + g):
                    for q0 in range(k0, t, n):
                        rows = torch.arange(q0, min(q0 + n, t))
                        qq, dd = q[0, rows, h], do[0, rows, h]
                        st = _summed(k[0, keys, kh], qq, blocks, d)
                        dpt = _summed(v[0, keys, kh], dd, blocks, d)
                        p, ds = probs(h, rows, keys, st.T, dpt.T)
                        for c in outs:
                            av[:, c] = av[:, c] + p.T @ dd[:, c]
                            ak[:, c] = ak[:, c] + ds.T @ qq[:, c]
            dk[0, keys, kh] = ak
            dv[0, keys, kh] = av
    for got, ref, exact in zip((dq, dk, dv), want,
                               _bwd_float64(q, k, v, o, lse, do)):
        assert rel(got, exact) <= CHUNK_GATE
        assert rel(ref, exact) <= PLAIN_BWD_GATE


def _bwd_float64(q, k, v, o, lse, do):
    """``flash_attention_bwd_plain``'s formulas in float64 (dq, dk, dv)."""
    t, hq, d = q.shape[1], q.shape[2], q.shape[3]
    hkv = k.shape[2]
    g = hq // hkv
    qd, kd, vd, od, dod = (x[0].double() for x in (q, k, v, o, do))
    kr, vr = kd.repeat_interleave(g, 1), vd.repeat_interleave(g, 1)
    i = torch.arange(t)
    s = torch.einsum("thd,shd->hts", qd, kr) / math.sqrt(d)
    s = s.masked_fill(i[None, :] > i[:, None], -math.inf)
    p = torch.exp(s - lse[0].double()[..., None])
    di = (od * dod).sum(-1).T
    ds = p * (torch.einsum("thd,shd->hts", dod, vr) - di[..., None]) \
        / math.sqrt(d)
    dq = torch.einsum("hts,shd->thd", ds, kr)
    dk = torch.einsum("hts,thd->shd", ds, qd).view(t, hkv, g, d).sum(2)
    dv = torch.einsum("hts,thd->shd", p, dod).view(t, hkv, g, d).sum(2)
    return (dq[None].float(), dk[None].float(), dv[None].float())


# ---------------------------------------------------------------------------
# Engine and PagedEngine tokens at D = 512
# ---------------------------------------------------------------------------


def _config(mod):
    return mod.LlamaConfig(vocab_size=512, hidden_size=1024,
                           intermediate_size=1024, num_hidden_layers=2,
                           num_attention_heads=2, num_key_value_heads=1,
                           max_position_embeddings=256)


@pytest.fixture(scope="module")
def model_512():
    """The packed model on both sides and JAX's greedy tokens in each of
    test_torch_head_dims' modes."""
    cfg = _config(jl)
    jp = jl.quantize_params_packed(
        jl.init_params(cfg, jax.random.PRNGKey(512)), cfg)
    want = {m: hd._generate(jpg, jeng, jp, cfg, m) for m in hd.MODES}
    return port_params(jp), want


@pytest.mark.parametrize("mode", hd.MODES)
def test_engine_tokens_equal_jax_at_head_dim_512(model_512, mode):
    """slot8/slot32: the slot Engine with the int8 cache (K4's plain
    version) and the bf16 cache; paged8/paged32: the PagedEngine with the
    int8 pool (K11's) and the bf16 pool (K12's): greedy tokens equal
    mxq_tpu's, token for token, at D = 512."""
    tp, want = model_512
    cfg = _config(tl)
    assert cfg.head_dim == 512
    got = hd._generate(tpg, teng, tp, cfg, mode, device="cpu")
    assert got == want[mode]
    assert [len(x) for x in got] == [hd.NEW] * len(hd.PROMPTS)
