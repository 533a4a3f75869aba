"""The split decomposition of the int8 decode-attention kernels
(``mxq_tpu_torch/csrc/attn_split.cuh``), emulated in torch on the CPU and
held against the sequential plain versions and ``mxq_tpu``.

The kernels cut each (batch, kv head)'s history into splits (dense: CHUNK
rows; paged: one page per split) and run two passes. The K4 family rounds
bf16(p * v_scale) against the GLOBAL max, known only once every split's
scores are: pass A writes scores and split maxima, pass B rounds against
their max and forms each split's partial sums, and the splits add up in
split order. K9-K11 round against the RUNNING max of each page: page j's
is the prefix max m_j of the page maxima, so its partial sums can be
formed apart and combined as sum_j (.)_j * exp(m_j - m_final).

The emulations take the scores as the plain versions compute them (the
kernels' dot products only sum in another order) and rebuild everything
after them as the kernels do. Each bf16(p * v_scale) must be BIT-equal to
the one the plain version rounds (``_mirror_*`` repeats the plain
version's lines and returns it, and is itself held bit-equal to the plain
ctx), and ctx within 1e-6 of the plain version: only f32 sums and, paged,
the rescales move. Against ``mxq_tpu``: the dequantize-then-attend oracle
``int8_decode_attention_reference`` to 1e-2 (it does not round p * v_scale
to bf16), and the paged kernels (interpret mode) to 1e-3, as
``test_torch_paged.py`` holds the plain versions."""

import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mxq_tpu.ops import attn_int8 as ja8
from mxq_tpu_torch.ops import attn_int8 as ta8
from torch_port_helpers import bits, rel, to_torch

NEG = ta8.NEG
BF = ml_dtypes.bfloat16
S, D, HKV = 40, 64, 2


def _bf16(x):
    return x.to(torch.bfloat16).float()


# ---------------------------------------------------------------- dense --


def _dense_inputs(seed, g, t, positions):
    rng = np.random.default_rng(seed)
    b = len(positions)
    codes = lambda *s: rng.integers(-127, 128, s).astype(np.int8)  # noqa
    scales = lambda *s: (rng.random(s) * 0.02 + 1e-3).astype(BF)  # noqa
    a = dict(q=rng.standard_normal((b, t, HKV * g, D)).astype(np.float32),
             kc=codes(b, HKV, S, D), vc=codes(b, HKV, S, D),
             ks=scales(b, HKV, S), vs=scales(b, HKV, S),
             kcur=codes(b, HKV, 1, D), vcur=codes(b, HKV, 1, D),
             kscur=scales(b, HKV, 1), vscur=scales(b, HKV, 1),
             positions=np.asarray(positions, np.int32))
    return a, {k: to_torch(v) for k, v in a.items()}


def _scores(q, kc, ks):
    """``_attend_plain``'s scores: q [B, H, Q, D] -> [B, H, Q, S]."""
    st = torch.einsum("bhgd,bhsd->bhgs", _bf16(q), kc.float())
    return st * (ks.float() * (1.0 / math.sqrt(D)))[:, :, None, :]


def _mirror_dense(q, kc, ks, vc, vs, positions, cur=None):
    """``_attend_plain`` line for line (q [B, H, G, D]), returning its ctx
    and its bf16(p * v_scale) tensor [B, H, G, S]."""
    st = _scores(q, kc, ks)
    kpos = torch.arange(S)[None, None, None, :]
    pos = positions[:, None, None, None]
    st = torch.where(kpos < pos if cur is not None else kpos <= pos, st,
                     torch.full_like(st, NEG))
    m = st.amax(dim=-1, keepdim=True)
    if cur is not None:
        kcur, kscur, vcur, vscur = cur
        stc = torch.einsum("bhgd,bhsd->bhgs", _bf16(q), kcur.float())
        stc = stc * (kscur.float() * (1.0 / math.sqrt(D)))[:, :, None, :]
        m = torch.maximum(m, stc)
    p = torch.exp(st - m)
    denom = p.sum(dim=-1, keepdim=True)
    pv = (p * vs.float()[:, :, None, :]).to(torch.bfloat16).float()
    ctx = torch.einsum("bhgs,bhsd->bhgd", pv, vc.float())
    if cur is not None:
        pc = torch.exp(stc - m)
        denom = denom + pc
        pcb = (pc * vscur.float()[:, :, None, :]).to(torch.bfloat16).float()
        ctx = ctx + pcb * vcur.float()
    return ctx / denom, pv


def _emulate_dense(q, kc, ks, vc, vs, nrows, chunk, cur=None):
    """The kernels' two passes over splits of ``chunk`` rows. q
    [B, H, Q, D]; nrows [B, Q]: the history rows query row r attends.
    Returns ctx [B, H, Q, D] and the bf16(p * v_scale) [B, H, Q, S]."""
    st = _scores(q, kc, ks)
    cuts = list(range(0, S, chunk))
    rows = torch.arange(S)
    valid = rows[None, None, :] < nrows[:, :, None]          # [B, Q, S]
    valid = valid[:, None]                                    # [B, 1, Q, S]
    # pass A: each split's scores and its max per query row
    smax = [torch.where(valid[..., c:c + chunk], st[..., c:c + chunk],
                        NEG).amax(-1) for c in cuts]
    m = torch.stack(smax).amax(0)[..., None]                  # global max
    if cur is not None:
        kcur, kscur, vcur, vscur = cur
        stc = torch.einsum("bhgd,bhsd->bhgs", _bf16(q), kcur.float())
        stc = stc * (kscur.float() * (1.0 / math.sqrt(D)))[:, :, None, :]
        m = torch.maximum(m, stc)
    # pass B: every split rounds against m and forms its partial sums
    acc = den = 0.0
    pvs = []
    for c in cuts:
        v = valid[..., c:c + chunk]
        e = torch.where(v, torch.exp(st[..., c:c + chunk] - m), 0.0)
        pv = torch.where(v, _bf16(e * vs[:, :, None, c:c + chunk].float()),
                         0.0)
        pvs.append(pv)
        acc = acc + torch.einsum("bhgs,bhsd->bhgd", pv,
                                 vc[:, :, c:c + chunk].float())
        den = den + e.sum(-1, keepdim=True)
    if cur is not None:                  # the last block's combine
        ec = torch.exp(stc - m)
        den = den + ec
        acc = acc + _bf16(ec * vscur.float()[:, :, None, :]) * vcur.float()
    return acc / den, torch.cat(pvs, dim=-1)


def _rows_of(q, g, t):
    """[B, T, Hq, D] -> [B, H, T * G, D]: query row r = t * G + g."""
    b = q.shape[0]
    return q.reshape(b, t, HKV, g, D).permute(0, 2, 1, 3, 4).reshape(
        b, HKV, t * g, D)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("chunk", [7, 16])
@pytest.mark.parametrize("with_cur", [False, True])
def test_dense_split_keeps_the_rounding_points(chunk, g, with_cur):
    """K4 (with the current token: rows < pos and the token) and K4a
    (rows <= pos) over splits that cut the history at 0, 1, chunk - 1,
    chunk and S - 1."""
    a, t = _dense_inputs(chunk * 10 + g, g, 1,
                         [0, 1, chunk - 1, chunk, S - 1])
    q = _rows_of(t["q"], g, 1)
    pos = t["positions"]
    cur = (t["kcur"], t["kscur"], t["vcur"], t["vscur"]) if with_cur \
        else None
    want, want_pv = _mirror_dense(q, t["kc"], t["ks"], t["vc"], t["vs"],
                                  pos, cur)
    plain = ta8._attend_plain(q.to(torch.bfloat16), t["kc"], t["ks"],
                              t["vc"], t["vs"], pos, cur)
    assert torch.equal(want, plain)            # the mirror is the plain
    nrows = (pos if with_cur else pos + 1)[:, None].expand(-1, g)
    got, got_pv = _emulate_dense(q, t["kc"], t["ks"], t["vc"], t["vs"],
                                 nrows, chunk, cur)
    assert torch.equal(bits(got_pv.to(torch.bfloat16)),
                       bits(want_pv.to(torch.bfloat16)))
    assert rel(got, plain) <= 1e-6
    # mxq_tpu's dequantize-then-attend oracle, the current row spliced in
    kc, ks, vc, vs = (t[k].clone() for k in ("kc", "ks", "vc", "vs"))
    if with_cur:
        rows, p = torch.arange(len(pos)), pos.long()
        kc[rows, :, p] = t["kcur"][:, :, 0]
        vc[rows, :, p] = t["vcur"][:, :, 0]
        ks[rows, :, p] = t["kscur"][:, :, 0]
        vs[rows, :, p] = t["vscur"][:, :, 0]
    ref = ja8.int8_decode_attention_reference(
        jnp.asarray(_bf16(t["q"][:, 0]).numpy()), jnp.asarray(kc.numpy()),
        jnp.asarray(ks.float().numpy()), jnp.asarray(vc.numpy()),
        jnp.asarray(vs.float().numpy()), jnp.asarray(a["positions"]))
    assert rel(got.reshape(ref.shape), ref) <= 1e-2


@pytest.mark.parametrize("g", [1, 4])
def test_dense_split_multi_query(g):
    """K4a with T = 3 query tokens per sequence in one launch: query row
    r = t * G + g attends rows <= pos + t; the same roundings as three
    single-query plain calls."""
    chunk, t_q = 16, 3
    a, t = _dense_inputs(50 + g, g, t_q, [0, 1, chunk - 2, chunk - 1,
                                          S - t_q])
    pos = t["positions"]
    q = _rows_of(t["q"], g, t_q)
    nrows = (pos[:, None] + 1 + torch.arange(t_q)[:, None].expand(
        t_q, g).reshape(-1)[None, :])
    got, got_pv = _emulate_dense(q, t["kc"], t["ks"], t["vc"], t["vs"],
                                 nrows, chunk)
    plain = ta8.int8_decode_attention_stacked_plain(
        t["q"], t["kc"][None], t["ks"][None], t["vc"][None], t["vs"][None],
        0, pos)
    want_pv = torch.cat([_mirror_dense(_rows_of(t["q"][:, i:i + 1], g, 1),
                                       t["kc"], t["ks"], t["vc"], t["vs"],
                                       pos + i)[1]
                         for i in range(t_q)], dim=2)
    assert torch.equal(bits(got_pv.to(torch.bfloat16)),
                       bits(want_pv.to(torch.bfloat16)))
    got_t = got.reshape(len(pos), HKV, t_q, g, D).permute(0, 2, 1, 3, 4)
    assert rel(got_t.reshape(plain.shape), plain) <= 1e-6
    for i in range(t_q):
        ref = ja8.int8_decode_attention_reference(
            jnp.asarray(_bf16(t["q"][:, i]).numpy()), jnp.asarray(a["kc"]),
            jnp.asarray(t["ks"].float().numpy()), jnp.asarray(a["vc"]),
            jnp.asarray(t["vs"].float().numpy()),
            jnp.asarray(a["positions"] + i))
        assert rel(got_t[:, i].reshape(ref.shape), ref) <= 1e-2, i


# ---------------------------------------------------------------- paged --

PS = ta8.PAGE_INT8


def _paged_inputs(seed, g, plist, pps=3):
    rng = np.random.default_rng(seed)
    b = len(plist)
    lp = 1 + b * pps
    scales = lambda *s: (rng.random(s) * 0.02 + 1e-3).astype(BF)  # noqa
    codes = lambda *s: rng.integers(-127, 128, s).astype(np.int8)  # noqa
    tables = (rng.permutation(lp - 1)[:b * pps] + 1).reshape(b, pps)
    for i, p in enumerate(plist):
        tables[i, p // PS + 1:] = 0
    a = dict(q=rng.standard_normal((b, HKV * g, D)).astype(np.float32),
             kp=codes(HKV, lp, PS, D), ks=scales(HKV, lp, 1, PS),
             vp=codes(HKV, lp, PS, D), vs=scales(HKV, lp, 1, PS),
             kcur=codes(b, HKV, D), kscur=scales(b, HKV),
             vcur=codes(b, HKV, D), vscur=scales(b, HKV),
             pos=np.asarray(plist, np.int32),
             tables=tables.astype(np.int32))
    t = {k: to_torch(v) for k, v in a.items()}
    t["ks"][:, 0] = t["vs"][:, 0] = float("nan")     # the null page
    return a, t


def _page(t, qf, bound, j):
    """Page j of every sequence as ``_paged_attend_plain`` forms it: its
    valid mask [B, 1, 1, PS], scores, v scales and value codes."""
    pid = t["tables"][:, j].long()
    valid = ((j * PS + torch.arange(PS))[None, :]
             < bound[:, None])[:, None, None, :]
    ks = t["ks"][:, pid, 0].float().transpose(0, 1)
    vs = t["vs"][:, pid, 0].float().transpose(0, 1)
    st = torch.einsum("bhgd,hbsd->bhgs", qf, t["kp"][:, pid].float()) \
        * (ks * (1.0 / math.sqrt(D)))[:, :, None, :]
    return valid, torch.where(valid, st, NEG), vs, t["vp"][:, pid].float()


def _cur_fold(qf, t, m, l, acc):
    stc = torch.einsum("bhgd,bhd->bhg", qf, t["kcur"].float())[..., None]
    stc = stc * (t["kscur"].float() * (1.0 / math.sqrt(D)))[:, :, None,
                                                            None]
    m_fin = torch.maximum(m, stc)
    alpha2 = torch.exp(m - m_fin)
    pc = torch.exp(stc - m_fin)
    l = l * alpha2 + pc
    pcb = (pc * t["vscur"].float()[:, :, None, None]).to(torch.bfloat16)
    return l, acc * alpha2 + pcb.float() * t["vcur"].float()[:, :, None, :]


def _npages(bound):
    return min(3, -(-int(bound.max()) // PS))


def _mirror_paged(t, qf, bound, with_cur):
    """``_paged_attend_plain``'s sequential fold, returning its ctx and
    each page's bf16(p * v_scale)."""
    b, g = qf.shape[0], qf.shape[2]
    m = torch.full((b, HKV, g, 1), NEG)
    l = torch.zeros((b, HKV, g, 1))
    acc = torch.zeros((b, HKV, g, D))
    pvs = []
    for j in range(_npages(bound)):
        valid, st, vs, vc = _page(t, qf, bound, j)
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        pexp = torch.where(valid, torch.exp(st - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + pexp.sum(dim=-1, keepdim=True)
        pv = torch.where(valid, pexp * vs[:, :, None, :], 0.0)
        pv = pv.to(torch.bfloat16).float()
        pvs.append(pv)
        acc = acc * alpha + torch.einsum("bhgs,hbsd->bhgd", pv, vc)
        m = m_new
    if with_cur:
        l, acc = _cur_fold(qf, t, m, l, acc)
    return (acc / l.clamp_min(1e-30)).reshape(b, -1, D), pvs


def _emulate_paged(t, qf, bound, with_cur):
    """The kernels' passes: page maxima (pass A), then each page against
    its prefix max m_j (pass B), then the pages scaled by exp(m_j - m_J)
    in page order and the current token folded in (the combine)."""
    b, g = qf.shape[0], qf.shape[2]
    pages = [_page(t, qf, bound, j) for j in range(_npages(bound))]
    pmax = [st.amax(dim=-1, keepdim=True) for _, st, _, _ in pages]
    m_j, m = [], torch.full((b, HKV, g, 1), NEG)
    for pm in pmax:                                   # prefix maxima
        m = torch.maximum(m, pm)
        m_j.append(m)
    parts, pvs = [], []
    for (valid, st, vs, vc), mj in zip(pages, m_j):   # independent pages
        pexp = torch.where(valid, torch.exp(st - mj), 0.0)
        pv = torch.where(valid, pexp * vs[:, :, None, :], 0.0)
        pv = pv.to(torch.bfloat16).float()
        pvs.append(pv)
        parts.append((torch.einsum("bhgs,hbsd->bhgd", pv, vc),
                      pexp.sum(dim=-1, keepdim=True)))
    acc = torch.zeros((b, HKV, g, D))
    l = torch.zeros((b, HKV, g, 1))
    for (c, lj), mj in zip(parts, m_j):
        f = torch.exp(mj - m)
        acc = acc + c * f
        l = l + lj * f
    if with_cur:
        l, acc = _cur_fold(qf, t, m, l, acc)
    return (acc / l.clamp_min(1e-30)).reshape(b, -1, D), pvs


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("with_cur", [False, True])
def test_paged_split_keeps_the_rounding_points(g, with_cur):
    """K9 (bound = pos + 1) and K10/K11 (bound = pos, the current token
    folded in last) at positions 0, 1, 127, 128, 129 and 257 (last pages
    holding one valid row) and 383 (three full pages), shuffled tables
    and a NaN null page."""
    plist = [0, 1, 127, 128, 129, 257, 3 * PS - 1]
    a, t = _paged_inputs(g * 7 + int(with_cur), g, plist)
    bound = t["pos"] if with_cur else t["pos"] + 1
    qf = _bf16(t["q"]).reshape(len(plist), HKV, g, D)
    want, want_pv = _mirror_paged(t, qf, bound, with_cur)
    pool = [t[k] for k in ("kp", "ks", "vp", "vs")]
    cur = [t[k] for k in ("kcur", "kscur", "vcur", "vscur")]
    plain = ta8._paged_attend_plain(t["q"], *pool, bound, t["tables"],
                                    cur if with_cur else None)
    assert torch.equal(want, plain)            # the mirror is the plain
    got, got_pv = _emulate_paged(t, qf, bound, with_cur)
    assert len(got_pv) == len(want_pv)
    for x, y in zip(got_pv, want_pv):
        assert torch.equal(bits(x.to(torch.bfloat16)),
                           bits(y.to(torch.bfloat16)))
    assert bool(torch.isfinite(got).all())
    assert rel(got, plain) <= 1e-6
    # (mxq_tpu's kernels read the null page: their pool keeps its scales)
    pool_j = [jnp.asarray(a[k]) for k in ("kp", "ks", "vp", "vs")]
    q, tab = jnp.asarray(a["q"]), jnp.asarray(a["tables"])
    if with_cur:
        ref = ja8.int8_paged_decode_attention_cur(
            q, *pool_j, *[jnp.asarray(a[k]) for k in
                          ("kcur", "kscur", "vcur", "vscur")],
            jnp.asarray(a["pos"]), tab)
    else:
        ref = ja8.int8_paged_decode_attention(q, *pool_j,
                                              jnp.asarray(a["pos"] + 1), tab)
    assert rel(got, ref) <= 1e-3
