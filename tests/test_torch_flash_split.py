"""The float32 path of K13 and K13-bwd on the CPU, from numpy seeds:

- the split pass's plain version (``flash_split_plain``; the card holds
  the kernel to it bit for bit): hi is bf16(x), x = hi + lo to 2^-16 of
  |x|, zeros past D in the kernels' width;
- the wrapper of the split pass takes the plain version on the CPU, on
  strided rows too, and the planes the wrappers allocate hold every
  tensor's hi and lo;
- an emulation of the arithmetic the float32 kernels do (every product
  hi.lo + lo.hi + hi.hi over bf16 planes with f32 sums, P and dS split in
  registers, the softmax in base 2, di = rowsum(o . dO) in f32) applied to
  causal attention and its backward, against ``mxq_tpu``'s float32 einsum
  attention and ``jax.vjp`` through it: the card's 1e-4 gate on the
  kernels against the plain versions then holds against the JAX package
  too.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxq_tpu.models import llama as jl
from mxq_tpu_torch.ops import attn_bf16 as ab
from torch_port_helpers import rel, to_torch

LOG2E = 1.4426950408889634


def _spread(rng, shape):
    """f32 normals scaled over six decades, with exact zeros and bf16
    values (whose lo is 0) among them."""
    x = rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 3, shape)
    x.flat[::7] = 0.0
    x.flat[3::11] = np.round(x.flat[3::11])
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("d", [64, 80, 96, 100, 128])
def test_split_plain_planes(d):
    """hi is x.to(bfloat16) bit for bit, |x - hi - lo| <= 2^-16 |x|
    (hi's error is at most 2^-9 |x|, lo rounds it to 2^-9 of itself), and
    columns D .. W of both planes are zero, W the kernels' width."""
    w = ab.kernel_head_dim(d)
    x = _spread(np.random.default_rng(d), (2, 9, 3, d))
    hi, lo = ab.flash_split_plain(x, w)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert hi.shape == lo.shape == (2, 9, 3, w)
    assert torch.equal(hi[..., :d].view(torch.int16),
                       x.to(torch.bfloat16).view(torch.int16))
    rest = (x.double() - hi[..., :d].double() - lo[..., :d].double()).abs()
    assert bool((rest <= 2.0 ** -16 * x.double().abs()).all())
    assert not bool(hi[..., d:].any()) and not bool(lo[..., d:].any())


def test_split_wrapper_on_cpu_is_plain_on_strided_rows():
    """``flash_split`` on the CPU is its plain version, bit for bit, on q
    sliced from a fused qkv tensor (the rows the wrappers pass)."""
    rng = np.random.default_rng(1)
    qkv = _spread(rng, (2, 12, 8 * 96))
    q = qkv[:, :, :4 * 96].reshape(2, 12, 4, 96)
    got = ab.flash_split(q, 128)
    want = ab.flash_split_plain(q.contiguous(), 128)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))


@pytest.mark.parametrize("b,t,hq,hkv,w", [(1, 2048, 32, 32, 128),
                                         (2, 200, 4, 1, 64),
                                         (1, 513, 64, 8, 128)])
def test_split_plane_elems_hold_every_plane(b, t, hq, hkv, w):
    """The bf16 planes the wrappers allocate at float32: hi and lo of q, k
    and v (K13) and of dO too (K13-bwd), each [B, T, H, w] (k's and v's
    first T rows), laid end to end as the libraries read them."""
    plane = {h: 2 * b * t * h * w for h in (hq, hkv)}
    assert ab.split_plane_elems(b, t, hq, hkv, w) == plane[hq] + 2 * plane[hkv]
    assert ab.split_plane_elems(b, t, hq, hkv, w, backward=True) == \
        2 * plane[hq] + 2 * plane[hkv]


# ---------------------------------------------------------------------------
# the float32 kernels' arithmetic, emulated
# ---------------------------------------------------------------------------


def _halves(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _prod3(a, b):
    """a @ b as the kernels compute it at float32: bf16 hi and lo planes
    of both, hi.lo + lo.hi + hi.hi (the small terms first), each product
    exact and summed in f32 (the dropped lo.lo is about 2^-18 of a
    term)."""
    ah, al = _halves(a)
    bh, bl = _halves(b)
    return (ah @ bl + al @ bh) + ah @ bh


def _mask(t):
    return torch.ones(t, t, dtype=torch.bool).tril()


def _emulated_forward(q, k, v, prod=_prod3):
    """K13's float32 arithmetic on q [B, T, Hq, D], k, v [B, T, Hkv, D]:
    S = Q K^T, p = 2^(S scale log2(e) - m) on the causal half, O = (P V) /
    l with P split in registers; lse = (m + log2 l) ln 2, each product
    ``prod``'s. Returns the context [B, T, Hq, D] and lse [B, Hq, T]."""
    t, hq, d = q.shape[1], q.shape[2], q.shape[3]
    g = hq // k.shape[2]
    qh = q.transpose(1, 2)
    kh, vh = (x.repeat_interleave(g, dim=2).transpose(1, 2) for x in (k, v))
    s = prod(qh, kh.transpose(-1, -2)) * (LOG2E / math.sqrt(d))
    s = s.masked_fill(~_mask(t), -math.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    o = prod(p, vh) / l
    lse = (m + torch.log2(l))[..., 0] / LOG2E
    return o.transpose(1, 2), lse


def _emulated_backward(q, k, v, o, lse, do):
    """K13-bwd's float32 arithmetic: di = rowsum(o . dO) in f32 (the split
    pass), P = 2^(S scale log2(e) - lse log2(e)), dP = dO V^T, dS = (dP -
    di) P scale, dV = P^T dO, dK = dS^T Q, dQ = dS K, every product split,
    dK and dV summed over each kv head's query heads."""
    t, hq, d = q.shape[1], q.shape[2], q.shape[3]
    hkv = k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qh, oh, doh = (x.transpose(1, 2) for x in (q, o, do))
    kh, vh = (x.repeat_interleave(g, dim=2).transpose(1, 2) for x in (k, v))
    di = (oh * doh).sum(-1, keepdim=True)
    s = _prod3(qh, kh.transpose(-1, -2))
    p = torch.exp2(s * (scale * LOG2E) - lse[..., None] * LOG2E)
    p = p.masked_fill(~_mask(t), 0.0)
    dp = _prod3(doh, vh.transpose(-1, -2))
    ds = (dp - di) * p * scale
    dv = _prod3(p.transpose(-1, -2), doh)
    dk = _prod3(ds.transpose(-1, -2), qh)
    dq = _prod3(ds, kh)
    b = q.shape[0]
    dk, dv = (x.view(b, hkv, g, t, d).sum(2).transpose(1, 2)
              for x in (dk, dv))
    return dq.transpose(1, 2), dk, dv


def _einsum_attention(q, k, v):
    """``mxq_tpu.models.llama.attention``'s float32 einsum path (:377-380
    and :397-406): k, v repeated to the query heads, scores over sqrt(D)
    plus the causal mask, softmax, the product with v."""
    t, hq, d = q.shape[1], q.shape[2], q.shape[3]
    g = hq // k.shape[2]
    k, v = jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2)
    scores = jnp.einsum("bthd,bshd->bhts", q, k) / np.sqrt(d)
    probs = jax.nn.softmax(scores + jl.causal_mask(t), axis=-1)
    return jnp.einsum("bhts,bshd->bthd", probs, v)


@pytest.mark.parametrize("hkv,d", [(4, 64), (1, 64), (1, 96)])
def test_emulated_float32_kernels_match_jax_einsum_attention(hkv, d):
    """The emulated float32 K13 and K13-bwd on 2 sequences of 200 tokens
    (not a multiple of any tile), 4 query heads over ``hkv`` kv heads (G =
    1 and 4), against mxq_tpu's float32 einsum attention and ``jax.vjp``
    through it: the context and each gradient within 1e-4 of its max (the
    card's gate on the kernels against the plain versions; the split
    products keep about 16 significant bits)."""
    rng = np.random.default_rng(10 * hkv + d)
    q, do = (rng.standard_normal((2, 200, 4, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((2, 200, hkv, d)).astype(np.float32)
            for _ in range(2))
    out, vjp = jax.vjp(_einsum_attention, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (to_torch(x) for x in (q, k, v, do))
    o, lse = _emulated_forward(tq, tk, tv)
    assert o.dtype == torch.float32 and rel(o, out) <= 1e-4
    got = _emulated_backward(tq, tk, tv, o, lse, tdo)
    for g, w, x in zip(got, want, (q, k, v)):
        assert tuple(g.shape) == x.shape
        assert rel(g, w) <= 1e-4


def test_emulated_split_products_keep_what_bf16_loses():
    """The same emulation with one bf16 product (hi.hi) in place of the
    three sits far outside the 1e-4 gate: the gate tells the split
    products from a kernel that dropped the hi.lo and lo.hi terms."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((1, 160, 2, 64)).astype(np.float32)
               for _ in range(3))
    out = _einsum_attention(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (to_torch(x) for x in (q, k, v))
    o, _ = _emulated_forward(tq, tk, tv)
    assert rel(o, out) <= 1e-4
    o1, _ = _emulated_forward(tq, tk, tv,
                              lambda a, b: _halves(a)[0] @ _halves(b)[0])
    assert rel(o1, out) > 1e-3
