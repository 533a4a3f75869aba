"""K12's schedule (``mxq_tpu_torch/csrc/paged_attn_bf16.cu``) emulated on
the CPU, against K12's plain version and ``mxq_tpu``'s
``_paged_attend_reference``.

The kernel runs persistent blocks over a work list it derives on the
device from ``lengths``: an item per (batch row, kv head, split of
SPLIT_ROWS history rows) that holds a live row, and one item per (row, kv
head) of length <= 0, which writes zeros. A block's producer warp decodes
items ``blockIdx.x, + gridDim.x, ...`` by scanning 32 lengths at a time,
and copies each item's rows through a ring of tiles (one bulk copy per run
of rows within a page, or one per row, or the cp.async ladder); its four
consumer warps score and sum each tile in lane groups with an online
softmax, merge the lane groups in a fixed order at the item's end, and
the last item of a (row, kv head) to finish combines the splits in split
order. These tests emulate that schedule in numpy and torch and hold it
to the kernel's rules:

- the work list visits every live row exactly once, for any grid, and
  never a row at or past a length or a page past ceil(length / ps);
- every bulk copy is a multiple of 16 bytes within one page;
- the emulated result, with NaN in the null page, past each length in
  the last live page and in the tiles' stale rows, is within 1e-6 of the
  plain version and within 1e-5 of ``_paged_attend_reference`` (f32 q:
  only the order of summation differs), and one bf16 ulp with bf16 q;
- a row's emulated result has the same bits alone as inside a batch of
  other lengths (its splits and tiles follow from its own length only).
"""

import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from mxq_tpu.serving import paged as jpg
from mxq_tpu_torch.ops import attn_bf16 as ab
from torch_port_helpers import rel, to_torch

BF = ml_dtypes.bfloat16
SPLIT = ab.SPLIT_ROWS
# the kernel's constants (paged_attn_bf16.cu): consumer warps, bytes of
# one K (or V) tile of the ring
NCW = 4
TILE_BYTES = 8192


def layout(w: int, g: int) -> dict:
    """The kernel's consumer layout at template width ``w`` and ``g``
    query heads a launch (the template's GT: the next power of two): lane
    groups a warp and in all (a row's lanes each read 8 columns, 4 at GT >=
    8 below the 256 template), tile rows, rows a lane group takes per tile
    and per online step."""
    gt = 1 << (g - 1).bit_length()
    cpl = 4 if gt >= 8 and w <= 128 else 8
    rpw = 32 // (w // cpl)
    nlg = NCW * rpw
    tr = TILE_BYTES // (2 * w)
    r = tr // nlg
    return dict(gt=gt, rpw=rpw, nlg=nlg, tr=tr, r=r,
                rg=max(1, min(r, 16 // gt)))


def live_rows(n: int, cap: int) -> int:
    return min(max(n, 0), cap)


def item_count(n: int, hkv: int, cap: int) -> int:
    """Items of one batch row: a split of SPLIT rows per kv head, or one
    zero item per kv head where the length is <= 0."""
    return hkv * max(1, -(-live_rows(n, cap) // SPLIT))


def find_item(it: int, lengths, hkv: int, cap: int):
    """The producer warp's decode of item ``it``: 32 lengths at a time, an
    inclusive scan of their item counts, the first row whose running count
    passes ``it``. Returns (row, its first item, its item count) or None
    past the last item."""
    base = 0
    for c0 in range(0, len(lengths), 32):
        cnt = [item_count(n, hkv, cap) for n in lengths[c0:c0 + 32]]
        incl = np.cumsum(cnt)
        if it < base + incl[-1]:
            lane = int(np.argmax(base + incl > it))
            return c0 + lane, base + int(incl[lane]) - cnt[lane], cnt[lane]
        base += int(incl[-1])
    return None


def block_items(blk: int, grid: int, lengths, hkv: int, cap: int) -> list:
    """The items (row, kv head, split) block ``blk`` of ``grid`` walks."""
    out, it = [], blk
    while (found := find_item(it, lengths, hkv, cap)) is not None:
        b, first, cnt = found
        ns = cnt // hkv
        out.append((b, (it - first) // ns, (it - first) % ns))
        it += grid
    return out


def tiles(n: int, j: int, tr: int) -> list:
    """Rows [ra, rb) of split ``j``'s ring tiles for a row of ``n`` live
    rows: TR rows each, the last cut at the length."""
    r0 = j * SPLIT
    nv = min(n - r0, SPLIT)
    return [(r0 + t * tr, min(r0 + t * tr + tr, r0 + nv))
            for t in range(-(-nv // tr))]


def copy_units(ra: int, rb: int, ps: int, d: int, w: int) -> list:
    """The producer's copies of one tile's rows [ra, rb): (table slot,
    first row in the page, rows, first tile row). Pages of the template
    width (d == w) go by one copy per run of rows within a page, narrower
    ones by one copy per row (the ladder copies a row in pieces, so a row
    is its unit here too)."""
    if d == w:
        return [(p, max(ra, p * ps) - p * ps,
                 min(rb, p * ps + ps) - max(ra, p * ps),
                 max(ra, p * ps) - ra)
                for p in range(ra // ps, (rb - 1) // ps + 1)]
    return [(r // ps, r % ps, 1, r - ra) for r in range(ra, rb)]


def check_work_list(lengths, hkv, ps, pps, d, w, grids):
    cap = pps * ps
    want = [(b, h, j) for b, n in enumerate(lengths) for h in range(hkv)
            for j in range(max(1, -(-live_rows(n, cap) // SPLIT)))]
    tr = TILE_BYTES // (2 * w)
    for grid in grids:
        got = [x for blk in range(grid)
               for x in block_items(blk, grid, lengths, hkv, cap)]
        assert sorted(got) == want           # every item once, any grid
    for b, n in enumerate(lengths):
        n = live_rows(n, cap)
        seen = []
        for j in range(max(1, -(-n // SPLIT))):
            for ra, rb in tiles(n, j, tr) if n else []:
                assert ra < rb <= n and rb - ra <= tr
                for p, r_in, rows, dst in copy_units(ra, rb, ps, d, w):
                    assert p < -(-n // ps) and r_in + rows <= ps
                    assert p * ps + r_in == ra + dst     # in tile order
                    if d % 8 == 0:
                        assert rows * d * 2 % 16 == 0
                    seen += range(p * ps + r_in, p * ps + r_in + rows)
        assert seen == list(range(n))        # each live row once, in order


EDGES = [0, 1, SPLIT - 1, SPLIT, SPLIT + 1]


@pytest.mark.parametrize("ps,pps", [(16, 32), (64, 3), (64, 32),
                                    (128, 2), (128, 32)])
@pytest.mark.parametrize("d,w", [(128, 128), (64, 64), (96, 128),
                                 (256, 256)])
def test_work_list_at_edges(ps, pps, d, w):
    """Lengths 0, 1, ps +- 1, SPLIT +- 1, the whole table and past it
    (cut to the table), and a negative one."""
    cap = pps * ps
    lengths = sorted({n for n in EDGES + [ps - 1, ps, ps + 1, cap - 1, cap,
                                          cap + 7, -3] if n <= cap + 7})
    check_work_list(lengths, 2, ps, pps, d, w, grids=(1, 3, 132, 396))


@settings(max_examples=60, deadline=None)
@given(lengths=st.lists(st.integers(-2, 32 * 128 + 3), min_size=1,
                        max_size=16),
       ps=st.sampled_from([16, 64, 128]), pps=st.integers(1, 32),
       hkv=st.integers(1, 4), grid=st.integers(1, 600),
       dw=st.sampled_from([(128, 128), (64, 64), (96, 128), (100, 128)]))
def test_work_list_random(lengths, ps, pps, hkv, grid, dw):
    check_work_list(lengths, hkv, ps, pps, *dw, grids=(grid,))


def test_work_list_scans_past_32_rows():
    """More than 32 batch rows: the producer's scan moves on by chunks of
    32 lengths."""
    lengths = list(np.random.default_rng(0).integers(-1, 600, 75))
    check_work_list(lengths, 3, 64, 10, 128, 128, grids=(1, 7, 396))


def _gather_tile(pages, h, table, ra, rb, ps, d, w, tr):
    """One ring tile as the kernel's shared memory holds it: the copied
    rows, zeros past column d, stale rows (NaN here) past the tile's
    live rows."""
    tile = torch.full((tr, w), float("nan"))
    tile[:, d:] = 0
    for p, r_in, rows, dst in copy_units(ra, rb, ps, d, w):
        tile[dst:dst + rows, :d] = pages[h, table[p], r_in:r_in + rows].float()
    return tile


def _online(q, kt, vt, nvt, lay, sqrt_d, state):
    """One tile into the lane groups' online state (m, l, acc): lane group
    lg takes rows lg + NLG * i, RG rows per step; rows >= nvt are selected
    away (-inf scores, no P.V term), never multiplied by 0."""
    m, l, acc = state
    nlg, r, rg = lay["nlg"], lay["r"], lay["rg"]
    for sg in range(0, r, rg):
        rows = (torch.arange(nlg)[:, None]
                + nlg * (sg + torch.arange(rg))[None, :])    # [NLG, RG]
        live = rows < nvt
        s = torch.einsum("nrc,gc->nrg", kt[rows], q) / sqrt_d
        s = torch.where(live[..., None], s, float("-inf"))
        mn = torch.maximum(m, s.max(dim=1).values)            # [NLG, GT]
        ok = mn > float("-inf")
        f = torch.where(ok, torch.exp(m - mn), 1.0)
        m = torch.where(ok, mn, m)
        l, acc = l * f, acc * f[..., None]
        for i in range(rg):
            p = torch.where(ok & live[:, i, None],
                            torch.exp(s[:, i] - mn), 0.0)     # [NLG, GT]
            l = l + p
            term = p[..., None] * vt[rows[:, i]][:, None, :]
            acc = acc + torch.where(live[:, i, None, None], term, 0.0)
    return m, l, acc


def _merge(m, l, acc, mo, lo, ao):
    """Two partial softmaxes in one: the larger max, each side scaled."""
    mn = torch.maximum(m, mo)
    f = torch.where(m > float("-inf"), torch.exp(m - mn), 0.0)
    fo = torch.where(mo > float("-inf"), torch.exp(mo - mn), 0.0)
    return mn, l * f + lo * fo, acc * f[..., None] + ao * fo[..., None]


def _split_partial(q, kp, vp, h, table, n, j, lay, ps, d, w, sqrt_d):
    """One item's (m, l, partial context) [GT], [GT], [GT, w]: its tiles
    through the lane groups, then the lane groups of each warp by the
    butterfly over their bits, then the warps in order."""
    gt, nlg, rpw = lay["gt"], lay["nlg"], lay["rpw"]
    state = (torch.full((nlg, gt), float("-inf")), torch.zeros(nlg, gt),
             torch.zeros(nlg, gt, w))
    for ra, rb in tiles(n, j, lay["tr"]):
        kt = _gather_tile(kp, h, table, ra, rb, ps, d, w, lay["tr"])
        vt = _gather_tile(vp, h, table, ra, rb, ps, d, w, lay["tr"])
        state = _online(q, kt, vt, rb - ra, lay, sqrt_d, state)
    m, l, acc = state
    off = 1
    while off < rpw:                      # within a warp: xor of lane groups
        perm = torch.arange(nlg) ^ off
        m, l, acc = _merge(m, l, acc, m[perm], l[perm], acc[perm])
        off *= 2
    m, l, acc = m[::rpw], l[::rpw], acc[::rpw]          # one per warp
    mw = m.max(dim=0).values
    f = torch.where(m > float("-inf"), torch.exp(m - mw), 0.0)
    accw, lw = torch.zeros_like(acc[0]), torch.zeros_like(l[0])
    for x in range(NCW):                  # the warps in order
        accw = accw + acc[x] * f[x][:, None]
        lw = lw + l[x] * f[x]
    return mw, lw, accw


def k12_emulated(q, kp, vp, lengths, tables):
    """K12's result as its schedule computes it (f32, before the cast to
    q's type): a launch per ``ab.heads_per_launch`` query heads of a kv
    head (16; 8 at the 256 template), each item's
    split partial, the splits combined in order by the last one, a
    single split written directly, zeros for a length <= 0."""
    b, hq, d = q.shape
    hkv, _, ps, _ = kp.shape
    pps = tables.shape[1]
    w = ab.kernel_head_dim(d)
    g_all = hq // hkv
    cap = pps * ps
    sqrt_d = torch.tensor(math.sqrt(d), dtype=torch.float32)
    qf = q.float()
    out = torch.zeros(b, hq, w)
    per = ab.heads_per_launch(w)
    for g0 in range(0, g_all, per):
        g = min(per, g_all - g0)
        lay = layout(w, g)
        for bb in range(b):
            n = live_rows(int(lengths[bb]), cap)
            if n == 0:
                continue
            ns = -(-n // SPLIT)
            for h in range(hkv):
                qs = torch.zeros(lay["gt"], w)
                qs[:g, :d] = qf[bb, h * g_all + g0:h * g_all + g0 + g]
                parts = [_split_partial(qs, kp, vp, h, tables[bb], n, j,
                                        lay, ps, d, w, sqrt_d)
                         for j in range(ns)]
                if ns == 1:
                    m, l, acc = parts[0]
                else:
                    mm = torch.stack([p[0] for p in parts]).max(dim=0).values
                    l, acc = torch.zeros_like(parts[0][1]), \
                        torch.zeros_like(parts[0][2])
                    for m_j, l_j, a_j in parts:      # split order
                        f = torch.exp(m_j - mm)
                        acc = acc + a_j * f[:, None]
                        l = l + l_j * f
                ctx = torch.where(l[:, None] > 0, acc / l[:, None], 0.0)
                out[bb, h * g_all + g0:h * g_all + g0 + g] = ctx[:g]
    return out[..., :d]


def _pool(rng, lengths, hkv, g, d, ps, pps, q_dtype=np.float32):
    """q [B, Hq, D], pages [Hkv, LP, ps, D] bf16 with NaN in the null page
    0 and past each length in its last live page (``nan``), the same pool
    with zeros there (``zero``, what the plain version gathers), lengths
    and shuffled tables with the null page past each length."""
    b = len(lengths)
    lp = 1 + b * pps
    k = rng.standard_normal((hkv, lp, ps, d)).astype(np.float32)
    v = rng.standard_normal((hkv, lp, ps, d)).astype(np.float32)
    q = rng.standard_normal((b, hkv * g, d)).astype(np.float32)
    tables = (rng.permutation(lp - 1)[:b * pps] + 1).reshape(b, pps)
    kz, vz = k.copy(), v.copy()
    kz[:, 0] = vz[:, 0] = 0
    k[:, 0] = v[:, 0] = np.nan
    for i, n in enumerate(lengths):
        tables[i, -(-n // ps):] = 0
        if n % ps:
            last = tables[i, n // ps]
            k[:, last, n % ps:] = v[:, last, n % ps:] = np.nan
            kz[:, last, n % ps:] = vz[:, last, n % ps:] = 0
    cast = (lambda a: to_torch(a.astype(BF)))
    q = q.astype(q_dtype)
    return dict(q=to_torch(q), nan=(cast(k), cast(v)),
                zero=(cast(kz), cast(vz)),
                np=(q, kz.astype(BF), vz.astype(BF),
                    np.array(lengths, np.int32), tables.astype(np.int32)),
                lengths=torch.tensor(lengths, dtype=torch.int32),
                tables=torch.from_numpy(tables.astype(np.int32)))


def _lengths(ps, pps):
    cap = pps * ps
    return [n for n in (1, ps - 1, ps + 1, SPLIT - 1, SPLIT + 1, cap)
            if 1 <= n <= cap]


@pytest.mark.parametrize("ps,pps", [(64, 5), (16, 12), (128, 3)])
@pytest.mark.parametrize("g,d", [(1, 128), (4, 64), (8, 128), (2, 96),
                                 (3, 100), (16, 64), (32, 128), (1, 99),
                                 (8, 256), (16, 256), (2, 200)])
def test_emulated_schedule_matches_plain_and_jax(g, d, ps, pps):
    """f32 q: within 1e-6 of max|ctx| of the plain version, within 1e-5 of
    ``mxq_tpu``'s reference; finite with NaN in the null page, past each
    length and in the tiles' stale rows."""
    lengths = _lengths(ps, pps)
    t = _pool(np.random.default_rng(d * 7 + g + ps), lengths, 2, g, d, ps,
              pps)
    got = k12_emulated(t["q"], *t["nan"], t["lengths"], t["tables"])
    assert bool(torch.isfinite(got).all())
    plain = ab.paged_decode_attention_plain(t["q"], *t["zero"], t["lengths"],
                                            t["tables"])
    assert rel(got, plain) <= 1e-6
    want = to_torch(jpg._paged_attend_reference(
        *(jnp.asarray(x) for x in t["np"])))
    assert rel(got, want) <= 1e-5


@pytest.mark.parametrize("g,d", [(1, 128), (8, 128), (4, 96)])
def test_emulated_schedule_bf16_q(g, d):
    """bf16 q: the emulated f32 context cast to bf16 lies within one bf16
    ulp of each element of the plain version's."""
    ps, pps = 64, 5
    t = _pool(np.random.default_rng(g + d), _lengths(ps, pps), 2, g, d, ps,
              pps, q_dtype=BF)
    got = k12_emulated(t["q"], *t["nan"], t["lengths"], t["tables"]).to(
        torch.bfloat16).float()
    want = ab.paged_decode_attention_plain(
        t["q"], *t["zero"], t["lengths"], t["tables"]).float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
                     - 7)
    assert bool(((got - want).abs() <= ulp).all())


@pytest.mark.parametrize("g,d", [(1, 128), (8, 128), (4, 64)])
def test_emulated_row_bits_independent_of_batch(g, d):
    """Row 0 (length 300: two splits, a cut tile) alone and as row 3 of
    a batch of other lengths (1, 129, 2000, 64 and a zero length), the
    same pages: the same bits."""
    ps, pps = 64, 32
    rng = np.random.default_rng(11)
    batch = [1, 129, 2000, 300, 64, 0]
    t = _pool(rng, [n or 1 for n in batch], 2, g, d, ps, pps)
    t["lengths"][-1] = 0
    kp, vp = t["nan"]
    alone = k12_emulated(t["q"][3:4], kp, vp, t["lengths"][3:4],
                         t["tables"][3:4])
    inside = k12_emulated(t["q"], kp, vp, t["lengths"], t["tables"])
    assert torch.equal(alone[0], inside[3])
    assert not bool(inside[-1].any())            # length 0: zeros
