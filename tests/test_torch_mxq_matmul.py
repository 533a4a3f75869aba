"""mxq_tpu_torch.ops.mxq_matmul (the plain versions the kernel wrappers run
on CPU tensors) against mxq_tpu.ops.mxq_matmul run as its own tests run it
(Pallas in interpret mode on the CPU). Tolerance: rel <= 1e-4 of max|y|
for the f32 decode paths; the prefill path rounds its two GEMM results to
bf16 as the JAX one does, so it is held to the same 1e-4 on the pair of
bf16 GEMMs plus one bf16 ulp per element where the two libraries' f32
sums round to different sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxq_tpu import packfmt as jpf
from mxq_tpu.ops import mxq_matmul as jmm
from mxq_tpu_torch import packfmt as tpf
from mxq_tpu_torch.ops import mxq_matmul as tmm
from torch_port_helpers import bits, port_params, rel, to_torch

O, K = 320, 1088        # ragged N (pads to 1024) and K (pads to 2 k-tiles)


@pytest.fixture(scope="module")
def packed():
    w = np.random.default_rng(0).standard_normal((O, K)).astype(np.float32)
    pj = jpf.quantize_pack(jnp.asarray(w))
    return pj, port_params({"p": pj})["p"]


@pytest.mark.parametrize("b", [1, 8, 40])
def test_mxq_matmul_matches_jax(packed, b):
    pj, pt = packed
    x = np.random.default_rng(b).standard_normal((b, K)).astype(np.float32)
    yj = np.asarray(jmm.mxq_matmul(jnp.asarray(x), pj))
    yt = tmm.mxq_matmul(torch.from_numpy(x), pt)
    assert yt.shape == (b, O) and yt.dtype == torch.float32
    assert rel(yt, yj) <= 1e-4


def test_mxq_matmul_3d_and_dtype(packed):
    _, pt = packed
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 3, K)).astype(np.float32))
    y = tmm.mxq_matmul(x.to(torch.bfloat16), pt)
    assert y.shape == (2, 3, O) and y.dtype == torch.bfloat16
    ref = tmm.gemv_plain(x.reshape(6, K), pt).reshape(2, 3, O)
    assert rel(y, ref) <= 1e-2           # the output is rounded to bf16


def test_stacked_per_layer_matches_jax():
    l = 3
    rng = np.random.default_rng(7)
    ps = [jpf.quantize_pack(jnp.asarray(rng.standard_normal((O, K)).astype(
        np.float32))) for _ in range(l)]
    st = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ps)
    pt = port_params({"p": st})["p"]
    assert pt.stacked
    x = rng.standard_normal((4, K)).astype(np.float32)
    for li in range(l):
        yj = np.asarray(jmm.mxq_matmul_stacked(jnp.asarray(x), st,
                                               jnp.int32(li)))
        yt = tmm.mxq_matmul_stacked(torch.from_numpy(x), pt, li)
        assert rel(yt, yj) <= 1e-4, li


def test_prefill_matches_jax_at_512(packed):
    pj, pt = packed
    x = np.random.default_rng(11).standard_normal((512, K)).astype(
        np.float32)
    yj = np.asarray(jmm.mxq_matmul_prefill(jnp.asarray(x), pj))
    yt = tmm.mxq_matmul_prefill(torch.from_numpy(x), pt)
    assert yt.shape == (512, O)
    yj_t = to_torch(yj)
    assert rel(yt, yj_t) <= 1e-2
    # the two sides agree to f32 rounding before the bf16 output rounding
    ulp = yj_t.abs() * 2.0**-7
    assert bool(((yt - yj_t).abs() <= ulp + 1e-4 * yj_t.abs().max()).all())


def test_dequant_planes_plain_matches_tpu_kernel_bits(packed):
    """K3's plain version equals the TPU dequant kernel up to row order:
    the TPU writes slab order (row j*48 + g of a k-tile holds code j of
    group g), the port natural order (row g*16 + j). The 2-bit plane is
    bit-equal. In the 4-bit plane XLA's CPU backend fuses s4*c - s4*z4
    into one FMA, so where c == z4 it leaves the rounding error of s4*z4
    (under one f32 ulp of it) where the port, like K3 (built with
    --fmad=false), gives exactly 0; every other value is bit-equal."""
    pj, pt = packed
    nbp, n = pt.meta2.shape
    wd2j, wd4j = jmm._dequant_pallas(pj.w2, pj.w4, pj.meta2, pj.qscale,
                                     pj.qmin, pj.smeta4, block_n=1024,
                                     interpret=True)
    wd2t, wd4t = tmm.dequant_planes_plain(pt)
    n_kt = nbp // tpf.NB_TILE
    slab2 = wd2t.reshape(n_kt, 48, 16, n).transpose(1, 2).reshape(-1, n)
    slab4 = wd4t.reshape(n_kt, 32, 8, n).transpose(1, 2).reshape(-1, n)
    assert torch.equal(bits(slab2), bits(to_torch(wd2j)))
    wd4j = to_torch(wd4j)
    differ = bits(slab4) != bits(wd4j)
    assert bool((slab4[differ] == 0).all())
    sz4 = (pt.smeta4[0] * pt.smeta4[1]).abs().expand_as(wd4j)
    assert bool((wd4j[differ].float().abs() <= sz4[differ] * 2.0**-23).all())


def test_gemv_plain_is_the_reference_dequant(packed):
    _, pt = packed
    x = torch.randn((3, K), generator=torch.Generator().manual_seed(0))
    ref = x.to(torch.bfloat16).float() @ tpf.unpack_dequant(pt)
    assert torch.equal(tmm.gemv_plain(x, pt), ref)


def test_cpu_dispatch_never_counts_a_launch(packed):
    """On CPU tensors the wrappers run the plain versions; a launch count
    moves only where a kernel is launched."""
    _, pt = packed
    before = {k: f.launches for k, f in tmm.KERNELS.items()}
    tmm.mxq_matmul(torch.ones((1, K)), pt)
    tmm.mxq_matmul(torch.ones((4, K)), pt)
    tmm.mxq_matmul_prefill(torch.ones((512, K)), pt)
    tmm.mxq_matmul_prefill_a8(torch.ones((512, K)), pt)
    assert {k: f.launches for k, f in tmm.KERNELS.items()} == before


def test_wrappers_reject_bad_input(packed):
    _, pt = packed
    tmm._check_packed(pt, torch.device("cpu"))
    short = tpf.PackedMXQLinear(pt.w2[:-1], pt.w4, pt.meta2, pt.qscale,
                                pt.qmin, pt.smeta4, pt.in_features,
                                pt.out_features)
    with pytest.raises(ValueError):
        tmm._check_packed(short, torch.device("cpu"))
    stacked = tpf.stack_packed([pt, pt])
    with pytest.raises(ValueError):
        tmm._check_packed(stacked, torch.device("cpu"))


@pytest.mark.parametrize("nbp,n,b,want", [
    (64, 4096, 1, 4),        # o_proj at B=1: 32 column blocks -> 16 splits
    (64, 12288, 1, 16),      # qkv at B=1: 96 column blocks -> 4 splits
    (176, 4096, 1, 16),      # down at B=1: 11 splits of a whole k-tile
    (64, 4096, 16, 64),      # 16 batch tiles fill the card alone: 1 split
])
def test_split_rows(nbp, n, b, want):
    """K1/K2's K split on a 132-SM H100."""
    assert tmm._split_rows(nbp, n, b, 132) == want


# ---------------------------------------------------------------------------
# int8-activation prefill (K5 and mxq_matmul_prefill_a8)
# ---------------------------------------------------------------------------


def test_int8_weight_scale_equals_jax(packed):
    pj, pt = packed
    sw = tmm.int8_weight_scale(pt)
    assert sw.shape == (1, pt.n_padded) and sw.dtype == torch.float32
    want = jmm._int8_weight_scale(pj.meta2, pj.qscale, pj.qmin, pj.smeta4)
    assert torch.equal(sw, to_torch(want))
    # the bound covers every dequantized weight: requantizing never clips
    wmax = tpf.unpack_dequant(pt).abs().amax(dim=0)
    assert bool((wmax <= sw[0, :O] * 127.0 * 1.0001).all())


def test_dequant_int8_plain_matches_tpu_kernel(packed):
    """K5's plain version against the TPU kernel (interpret mode), up to
    row order (slab order there, natural plane order here). The 2-bit plane
    is equal. In the 4-bit plane XLA's CPU backend fuses (s4*c - s4*z4) *
    inv otherwise than the kernel's three roundings, so values within a few
    f32 ulps of a half-way point (all at 63.5 here) round to the other
    neighbour: 56 of 524288 codes at seed 0, each off by one; every other
    code is equal."""
    pj, pt = packed
    nbp, n = pt.meta2.shape
    inv = 1.0 / tmm.int8_weight_scale(pt)
    q2j, q4j = jmm._dequant_int8_pallas(
        pj.w2, pj.w4, pj.meta2, pj.qscale, pj.qmin, pj.smeta4,
        jnp.asarray(inv.numpy()), block_n=1024, interpret=True)
    q2t, q4t = tmm.dequant_int8_planes_plain(pt, inv)
    assert q2t.dtype == torch.int8 and q2t.shape == (n, nbp * 48)
    assert q4t.dtype == torch.int8 and q4t.shape == (n, nbp * 16)
    assert q2t.is_contiguous() and q4t.is_contiguous()
    q2t, q4t = q2t.T, q4t.T                         # natural plane order
    n_kt = nbp // tpf.NB_TILE
    slab2 = q2t.reshape(n_kt, 48, 16, n).transpose(1, 2).reshape(-1, n)
    assert torch.equal(slab2, to_torch(q2j))
    s4 = pt.smeta4[0:1]
    raw4 = (s4 * tpf._unpack_along_sublanes(pt.w4, 4).float()
            - s4 * pt.smeta4[1:2]) * inv                # before rounding
    diff = (q4t.int() - to_torch(q4j).reshape(n_kt, 8, 32, n).transpose(
        1, 2).reshape(-1, n).int())
    ties = diff != 0
    assert int(diff.abs().max()) <= 1
    assert int(ties.sum()) <= 100, int(ties.sum())
    frac = raw4[ties] - raw4[ties].floor()
    assert bool(((frac - 0.5).abs() <= 8 * 2.0**-23 * raw4[ties].abs()).all())
    # the codes are the rounded dequantized weights, inside [-127, 127]
    wd2, _ = tmm.dequant_planes_plain(pt)
    assert int(q2t.abs().max()) <= 127 and int(q4t.abs().max()) <= 127
    assert rel(q2t.float() / inv, wd2.float()) <= 1e-2


def test_prefill_a8_matches_jax(packed):
    """mxq_matmul_prefill_a8 against JAX's at 512 rows: the int32 sums are
    exact on both sides, so y differs only where an activation or weight
    code flips on a half-way tie (<= 5e-3 * max|y|, the tolerance of
    tests/test_mxq_matmul.py:209); and against the f32 path, the int8
    quantization error (< 0.03, tests/test_mxq_matmul.py:189)."""
    pj, pt = packed
    x = np.random.default_rng(13).standard_normal((512, K)).astype(
        np.float32)
    yj = np.asarray(jmm.mxq_matmul_prefill_a8(jnp.asarray(x), pj))
    yt = tmm.mxq_matmul_prefill_a8(torch.from_numpy(x), pt)
    assert yt.shape == (512, O) and yt.dtype == torch.float32
    assert rel(yt, yj) <= 5e-3
    ref = torch.from_numpy(x) @ tpf.unpack_dequant(pt)
    assert rel(yt, ref) < 0.03
    # the int8 GEMM accumulates exactly: equal to an int64 matmul
    a = torch.randint(-127, 128, (32, 64), dtype=torch.int8)
    b = torch.randint(-127, 128, (64, 24), dtype=torch.int8)
    assert torch.equal(torch._int_mm(a, b).long(), a.long() @ b.long())


def test_prefill_a8_stacked_and_dtype():
    rng = np.random.default_rng(17)
    ps = [tpf.quantize_pack(torch.from_numpy(rng.standard_normal(
        (256, 1024)).astype(np.float32))) for _ in range(2)]
    st = tpf.stack_packed(ps)
    x = torch.from_numpy(rng.standard_normal((2, 40, 1024)).astype(
        np.float32))
    for i, p in enumerate(ps):
        y = tmm.mxq_matmul_prefill_a8(x, st, i)
        assert y.shape == (2, 40, 256)
        assert torch.equal(y, tmm.mxq_matmul_prefill_a8(x, p))
    yb = tmm.mxq_matmul_prefill_a8(x.to(torch.bfloat16), ps[0])
    assert yb.dtype == torch.bfloat16
