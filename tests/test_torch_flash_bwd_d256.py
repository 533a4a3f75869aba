"""K13-bwd's bf16 kernels at the 256 template (``csrc/flash_attn_bwd.cu``
``dq_d256_kernel``, ``dkv_d256_kernel``), their schedule emulated in torch
on the CPU from numpy seeds:

- the dK/dV item plan (``flash_bwd_plan.bwd_plan_d256``, the library's
  ``plan_d256``): units of one key tile or a pair (kt, nk - 1 - kt), each
  kv head's query heads split over blocks; every (key tile, query tile,
  query head) pair walked exactly once, with an odd number of key tiles
  too;
- the tiles as the consumers share them: per 64-row tile each consumer
  takes 32 of the rows for S (S^T) and dP (dP^T) over all of D, P and dS
  rounded to the inputs' type, and each consumer's 128 columns of dQ (dK,
  dV) add the tile's four k16 slices in order, consumer 0's two first;
- split heads: each split's f32 partial, summed in split order (by the
  last block of the key tile);
- the emulation against ``flash_attention_bwd_plain`` and against
  ``jax.vjp`` of upstream ``flash_attention`` in interpret mode.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention

from flash_bwd_plan import bwd_plan_d256
from mxq_tpu_torch.ops import attn_bf16 as ab
from torch_port_helpers import rel, to_torch

R, HALF, W = 64, 32, 256          # tile rows, a consumer's rows, template
LOG2E = 1.4426950408889634
SMS = 132                         # the H100's SMs


def _inputs(seed, t, hq, hkv, d, b=1):
    """q, do [B, T, Hq, D] and k, v [B, T, Hkv, D], f32 normals."""
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, t, hq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, t, hkv, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _items(b, t, hq, hkv, pairs, splits):
    """The dK/dV kernel's items (``kv_item``, ``unit_tiles``): (kv head,
    batch row, split, the unit's key tiles in the order walked)."""
    nk = -(-t // R)
    units = (nk + 1) // 2 if pairs else nk
    per = hkv * b * splits
    for w in range(units * per):
        u, r = divmod(w, per)
        tiles = [u] + ([nk - 1 - u] if pairs and nk - 1 - u != u else [])
        yield r % hkv, r // hkv % b, r // (hkv * b), tiles


def _rows(x, b, row0, h):
    """64 rows of head h from row0 of x [B, T, H, D], zeros past T and
    past D up to the template's 256 columns (as TMA or cp.async fill)."""
    out = torch.zeros((R, W), dtype=x.dtype)
    rows = x[b, row0:row0 + R, h]
    out[:rows.shape[0], :rows.shape[1]] = rows
    return out


def _sliced(a, bmat):
    """a [64, 64] (the A operand over a tile's 64 rows, consumer 0's 32
    then consumer 1's) . bmat [64, 256]: the four k16 slices added in
    order, each in f32."""
    acc = torch.zeros((a.shape[0], bmat.shape[1]))
    for kk in range(4):
        acc = acc + a[:, 16 * kk:16 * kk + 16].float() \
            @ bmat[16 * kk:16 * kk + 16].float()
    return acc


def emulate_d256(q, k, v, o, lse, do, pairs, splits, count=None):
    """dq, dk, dv of the D = 256 bf16 design at ``(pairs, splits)``, the
    inputs' type for P and dS (f32 sums). ``count`` [B, Hq, nk, nk]
    counts the dK/dV kernel's (key tile, query tile) steps per head."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    nk = -(-t // R)
    scale = 1.0 / math.sqrt(d)
    dt = q.dtype
    di = (o.float() * do.float()).sum(-1)               # [B, T, Hq]
    tp = nk * R
    lse2 = torch.full((b, hq, tp), math.inf)
    dis = torch.zeros((b, hq, tp))
    lse2[..., :t] = lse * LOG2E
    dis[..., :t] = di.transpose(1, 2)

    def probs(s, dp, lrow, drow, mask):
        """P and dS of one consumer's S and dP (rows or columns as the
        lse and di broadcast), zero where ``mask``."""
        p = torch.exp2(s * (scale * LOG2E) - lrow)
        p = torch.where(mask, 0.0, p)
        ds = (dp - drow) * p * scale
        return p.to(dt), ds.to(dt)

    # dQ: an item per (64 query rows, head); the consumers split each
    # 64-key tile's keys for S and dP
    dq = torch.zeros((b, tp, hq, W))
    for bb in range(b):
        for h in range(hq):
            for qt in range(nk):
                qq, dd = _rows(q, bb, qt * R, h), _rows(do, bb, qt * R, h)
                rows = torch.arange(qt * R, qt * R + R)
                acc = torch.zeros((R, W))
                for kt in range(-(-min((qt + 1) * R, t) // R)):
                    kk, vv = (_rows(x, bb, kt * R, h // g) for x in (k, v))
                    pieces = []
                    for c in range(2):
                        keys = torch.arange(kt * R + HALF * c,
                                            kt * R + HALF * (c + 1))
                        kc = kk[HALF * c:HALF * (c + 1)]
                        vc = vv[HALF * c:HALF * (c + 1)]
                        s = qq.float() @ kc.float().T
                        dp = dd.float() @ vc.float().T
                        mask = (keys[None] > rows[:, None]) & (kt == qt)
                        pieces.append(probs(s, dp,
                                            lse2[bb, h, rows][:, None],
                                            dis[bb, h, rows][:, None],
                                            mask)[1])
                    acc = acc + _sliced(torch.cat(pieces, 1), kk)
                dq[bb, qt * R:qt * R + R, h] = acc

    # dK, dV: the items of the plan; per key tile the split's heads, query
    # tiles from the diagonal on; the consumers split each tile's query
    # rows for S^T and dP^T
    parts = torch.zeros((2, splits, b, hkv, tp, W))
    for hk, bb, s_, tiles in _items(b, t, hq, hkv, pairs, splits):
        for kt in tiles:
            kk, vv = (_rows(x, bb, kt * R, hk) for x in (k, v))
            keys = torch.arange(kt * R, kt * R + R)
            ak, av = torch.zeros((R, W)), torch.zeros((R, W))
            for h in range(hk * g + s_ * (g // splits),
                           hk * g + (s_ + 1) * (g // splits)):
                for qt in range(kt, nk):
                    if count is not None:
                        count[bb, h, kt, qt] += 1
                    qq = _rows(q, bb, qt * R, h)
                    dd = _rows(do, bb, qt * R, h)
                    pt, dst = [], []
                    for c in range(2):
                        rows = torch.arange(qt * R + HALF * c,
                                            qt * R + HALF * (c + 1))
                        qc = qq[HALF * c:HALF * (c + 1)]
                        dc = dd[HALF * c:HALF * (c + 1)]
                        st = kk.float() @ qc.float().T
                        dpt = vv.float() @ dc.float().T
                        mask = (keys[:, None] > rows[None]) & (qt == kt)
                        p, ds = probs(st, dpt, lse2[bb, h, rows][None],
                                      dis[bb, h, rows][None], mask)
                        pt.append(p)
                        dst.append(ds)
                    av = av + _sliced(torch.cat(pt, 1), dd)
                    ak = ak + _sliced(torch.cat(dst, 1), qq)
            parts[0, s_, bb, hk, kt * R:kt * R + R] = ak
            parts[1, s_, bb, hk, kt * R:kt * R + R] = av
    total = torch.zeros(parts.shape[:1] + parts.shape[2:])
    for sp in range(splits):                # split order
        total = total + parts[:, sp]
    dk, dv = (x.transpose(1, 2)[:, :t, :, :d].to(dt) for x in total)
    s_rows = k.shape[1]
    if s_rows > t:
        dk, dv = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, s_rows - t))
                  for x in (dk, dv))
    return dq[:, :t, :, :d].to(dt), dk, dv


@pytest.mark.parametrize("b,t,hq,hkv,want", [
    (1, 2048, 8, 1, (True, 8)),      # Gemma-2B's widths: 128 items of 33
    (1, 512, 8, 1, (False, 8)),      # 64 items of 8 query tiles
    (2, 1025, 8, 2, (True, 2)),      # 17 key tiles: the middle one alone
    (2, 1025, 8, 1, (True, 4)),
    (1, 2048, 16, 16, (False, 1)),   # Gemma-7B's: 512 items, no split
    (1, 257, 8, 1, (False, 8))])
def test_d256_plan(b, t, hq, hkv, want):
    """The plan at the card's 132 SMs (the card test
    test_k13_bwd_d256_plan_is_the_cpu_tests holds the library to it):
    splits divide G, and with splits > 1 every item has a block of one
    wave."""
    pairs, splits = bwd_plan_d256(b, t, hq, hkv, SMS)
    assert (pairs, splits) == want
    g, nk = hq // hkv, -(-t // R)
    units = (nk + 1) // 2 if pairs else nk
    assert g % splits == 0
    assert splits == 1 or units * hkv * b * splits <= SMS


@pytest.mark.parametrize("t", [64, 65, 257, 320, 1025])
@pytest.mark.parametrize("pairs,splits", [(False, 1), (True, 1), (True, 2),
                                          (False, 4), (True, 4)])
def test_d256_items_walk_every_tile_once(t, pairs, splits):
    """Every (key tile, query tile >= it, query head, batch row) step once
    over the items of a plan, none before the diagonal, at odd and even
    key tiles (1, 2, 5, 5, 17), B = 2, 8 query heads over 2 kv heads."""
    b, hq, hkv = 2, 8, 2
    g, nk = hq // hkv, -(-t // R)
    count = torch.zeros((b, hq, nk, nk), dtype=torch.int64)
    for hk, bb, s, tiles in _items(b, t, hq, hkv, pairs, splits):
        for kt in tiles:
            for h in range(hk * g + s * (g // splits),
                           hk * g + (s + 1) * (g // splits)):
                count[bb, h, kt, kt:] += 1
    want = torch.ones((nk, nk), dtype=torch.int64).triu()
    assert torch.equal(count, want.expand_as(count))


@pytest.mark.parametrize("d", [256, 192])
@pytest.mark.parametrize("pairs,splits", [(False, 8), (True, 4), (True, 1)])
def test_d256_schedule_equals_plain(d, pairs, splits):
    """The emulated design at Hq 8 over one kv head, T = 257 (5 key tiles:
    paired, the middle one alone), f32 inputs (P and dS unrounded), k and
    v 7 rows longer than T: dQ, dK and dV within 1e-5 of each one's max
    of ``flash_attention_bwd_plain`` on the plain forward's o and lse (f32
    sums in other orders; measured <= 6.1e-7), dK and dV zero past T; every
    step walked once. D = 192 runs at the template with zeros past D, its
    scale from D."""
    q, k, v, do = (to_torch(x) for x in _inputs(d + splits, 257, 8, 1, d))
    kx, vx = (torch.cat([x, torch.randn((1, 7, 1, d))], 1) for x in (k, v))
    o, lse = ab.flash_attention_forward_plain(q, kx, vx)
    want = ab.flash_attention_bwd_plain(q, kx, vx, o, lse, do)
    nk = 5
    count = torch.zeros((1, 8, nk, nk), dtype=torch.int64)
    got = emulate_d256(q, kx, vx, o, lse, do, pairs, splits, count)
    assert torch.equal(count[0], torch.ones((nk, nk), dtype=torch.int64)
                       .triu().expand(8, nk, nk))
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape and rel(g_, w_) <= 1e-5
    for g_ in got[1:]:
        assert not bool(g_[:, 257:].any())


def test_d256_schedule_bf16_equals_plain():
    """The same at bf16 inputs (P and dS rounded to bf16 where upstream
    rounds them, in both), D = 192, the paired plan with 4 splits: each
    gradient within 2e-2 of its max, the card tests' bf16 gate (a sum in
    another order moves a bf16 rounding of dS by an ulp; measured
    <= 3.8e-4)."""
    q, k, v, do = (to_torch(x).to(torch.bfloat16)
                   for x in _inputs(7, 257, 8, 1, 192))
    o, lse = ab.flash_attention_forward_plain(q, k, v)
    want = ab.flash_attention_bwd_plain(q, k, v, o, lse, do)
    got = emulate_d256(q, k, v, o, lse, do, True, 4)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.bfloat16 and rel(g_, w_) <= 2e-2


def test_d256_schedule_equals_upstream_flash_vjp():
    """The emulated design (paired key tiles, 4 splits) against ``jax.vjp``
    of upstream ``flash_attention`` (causal, sm_scale 1/sqrt(D), its
    default blocks) in interpret mode at Hq 8 over one kv head (JAX
    repeats k and v), D = 256, T = 256 (upstream takes T in whole
    128-row blocks), f32: each gradient within 1e-5 of its max (f32 sums
    in other orders, and upstream's exp(s - m) / l against exp(s -
    lse))."""
    t, hq, hkv, d = 256, 8, 1, 256
    q, k, v, do = _inputs(11, t, hq, hkv, d)

    def upstream(q, k, v):
        k, v = (jnp.repeat(x, hq // hkv, axis=2) for x in (k, v))
        return flash_attention(
            q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
            v.transpose(0, 2, 1, 3), causal=True,
            sm_scale=float(1.0 / np.sqrt(d))).transpose(0, 2, 1, 3)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(upstream, q, k, v)
        want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (to_torch(x) for x in (q, k, v, do))
    o, lse = ab.flash_attention_forward_plain(tq, tk, tv)
    got = emulate_d256(tq, tk, tv, o, lse, tdo, True, 4)
    for g_, w_ in zip(got, want):
        assert rel(g_, w_) <= 1e-5
