"""mxq_tpu_torch.ops.uniform4 against mxq_tpu.ops.uniform4: the uniform
4-bit and 2-bit packers bit for bit (JAX's eager packers), the reference
dequants exactly, the closed-form bit patterns of tests/test_uniform4.py,
and the plain version of K7/K8 (what the wrappers run on CPU tensors)
against JAX's kernels in interpret mode and against bf16(x) @ dequant.

Tolerances: the plain version is bf16(x) @ dequant in f32, the TPU kernel
the factored s*(x.c) - s*z*sum(x) in f32: both sum the same products in
another order, rel <= 1e-5 of max|y|; against its own definition the plain
version is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxq_tpu.ops import uniform4 as ju4
from mxq_tpu_torch import weights
from mxq_tpu_torch.ops import uniform4 as tu4
from torch_port_helpers import bits, port_params, rel, to_numpy_tree, to_torch

# (batch rows, columns) of K7/K8's tile ids as csrc/uniform_gemv.cu builds
# them (ops/uniform4._tiles reads them from the library on the card;
# tests/test_torch_kernels_cuda.py holds the build to this table)
UNIFORM_TILES = ((8, 128), (32, 64), (128, 128))
PACKERS = {4: (ju4.quantize_pack_u4, tu4.quantize_pack_u4,
               ju4.unpack_dequant_u4),
           2: (ju4.quantize_pack_u2, tu4.quantize_pack_u2,
               ju4.unpack_dequant_u2)}


def _weight(o, k, seed=0):
    return np.random.default_rng(seed).standard_normal((o, k)).astype(
        np.float32)


@pytest.mark.parametrize("nbits", [4, 2])
@pytest.mark.parametrize("o,k", [(300, 640), (1024, 1088)])
def test_packers_bit_exact_with_jax(nbits, o, k):
    jpack, tpack, _ = PACKERS[nbits]
    w = _weight(o, k, seed=o + nbits)
    pj = jpack(jnp.asarray(w))
    pt = tpack(torch.from_numpy(w))
    assert (pt.in_features, pt.out_features) == (k, o)
    assert pt.kp == pj.kp and pt.n_padded == pj.n_padded
    for f in ("w", "s", "z"):
        want = to_torch(getattr(pj, f))
        got = getattr(pt, f)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert torch.equal(bits(got), bits(want)), f


@pytest.mark.parametrize("nbits", [4, 2])
def test_unpack_dequant_equals_jax(nbits):
    jpack, tpack, junpack = PACKERS[nbits]
    w = _weight(300, 640, seed=9)
    pj = jpack(jnp.asarray(w))
    pt = port_params({"p": pj})["p"]
    assert isinstance(pt, tu4.PackedU4Linear if nbits == 4
                      else tu4.PackedU2Linear)
    got = tu4.unpack_dequant(pt)
    assert got.shape == (640, 300)
    assert torch.equal(got, to_torch(junpack(pj)))
    fq = (tu4.fake_quant_u4 if nbits == 4 else tu4.fake_quant_u2)(
        torch.from_numpy(w))
    assert torch.equal(fq, got.T)


def test_closed_form_bit_pattern_u4():
    """Words 0x76543210 (code 7 in the sign bits), s=1, z=0: column
    t*1024 + j*128 + r carries weight j, so ones give
    tiles * 128 * sum(j) exactly (tests/test_uniform4.py:13)."""
    k, o = 2048, 1024
    p = tu4.PackedU4Linear(
        w=torch.full((k // 8, o), 0x76543210, dtype=torch.int32),
        s=torch.ones((k // 128, o), dtype=torch.bfloat16),
        z=torch.zeros((k // 128, o), dtype=torch.bfloat16),
        in_features=k, out_features=o)
    wk = tu4.unpack_dequant(p)
    expect = np.tile(np.repeat(np.arange(8), 128), k // 1024)
    np.testing.assert_array_equal(wk[:, 0].numpy(), expect)
    y = tu4.u4_matmul(torch.ones((1, k)), p)
    assert float(y[0, 0]) == (k // 1024) * 128 * sum(range(8))
    neg = p.w.clone()
    neg.fill_(-0x789ABCDF)                     # 0x87654321: code 8 on top
    assert int(tu4.unpack_dequant(tu4.PackedU4Linear(
        neg, p.s, p.z, k, o))[7 * 128, 0]) == 8


def test_closed_form_bit_pattern_u2():
    """Words 0x2 (code 2 in slab 0), s=1, z=0: only columns j=0 of each
    tile carry weight 2, ones give tiles * 64 * 2 (tests/test_uniform4.py:72)."""
    k, o = 2048, 1024
    p = tu4.PackedU2Linear(
        w=torch.full((k // 16, o), 0x2, dtype=torch.int32),
        s=torch.ones((k // 128, o), dtype=torch.bfloat16),
        z=torch.zeros((k // 128, o), dtype=torch.bfloat16),
        in_features=k, out_features=o)
    col = tu4.unpack_dequant(p)[:, 0].reshape(k // 1024, 16, 64)
    assert bool((col[:, 0] == 2).all()) and bool((col[:, 1:] == 0).all())
    y = tu4.u2_matmul(torch.ones((1, k)), p)
    assert float(y[0, 0]) == (k // 1024) * 64 * 2


@pytest.mark.parametrize("nbits", [4, 2])
def test_plain_matches_jax_kernel_interpret(nbits):
    """One tiny shape per kernel: B=8, O=256, K=1024 (JAX's Pallas kernel
    in interpret mode)."""
    jpack, _, _ = PACKERS[nbits]
    w = _weight(256, 1024, seed=3)
    x = np.random.default_rng(4).standard_normal((8, 1024)).astype(np.float32)
    pj = jpack(jnp.asarray(w))
    pt = port_params({"p": pj})["p"]
    mm_j = ju4.u4_matmul if nbits == 4 else ju4.u2_matmul
    mm_t = tu4.u4_matmul if nbits == 4 else tu4.u2_matmul
    yj = np.asarray(mm_j(jnp.asarray(x), pj, interpret=True))
    yt = mm_t(torch.from_numpy(x), pt)
    assert yt.shape == (8, 256) and yt.dtype == torch.float32
    assert rel(yt, yj) <= 1e-5
    ref = torch.from_numpy(x).to(torch.bfloat16).float() \
        @ tu4.unpack_dequant(pt)
    assert torch.equal(tu4.uniform_matmul_plain(torch.from_numpy(x), pt),
                       ref)


@pytest.mark.parametrize("nbits", [4, 2])
def test_leading_dims_and_dtype(nbits):
    _, tpack, _ = PACKERS[nbits]
    p = tpack(torch.from_numpy(_weight(256, 1100, seed=5)))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 3, 1100)).astype(np.float32))
    mm_t = tu4.u4_matmul if nbits == 4 else tu4.u2_matmul
    y = mm_t(x.to(torch.bfloat16), p)
    assert y.shape == (2, 3, 256) and y.dtype == torch.bfloat16
    ref = tu4.uniform_matmul_plain(x.reshape(6, 1100), p).reshape(2, 3, 256)
    assert rel(y, ref) <= 1e-2             # the output is rounded to bf16


def test_cpu_calls_launch_nothing():
    p = tu4.quantize_pack_u4(torch.from_numpy(_weight(256, 1024)))
    before = {k: f.launches for k, f in tu4.KERNELS.items()}
    tu4.u4_matmul(torch.ones((1, 1024)), p)
    tu4.u4_matmul(torch.ones((9, 1024)), p)
    tu4.u2_matmul(torch.ones((9, 1024)),
                  tu4.quantize_pack_u2(torch.from_numpy(_weight(256, 1024))))
    assert {k: f.launches for k, f in tu4.KERNELS.items()} == before


def test_weights_bridge_round_trip():
    """A JAX packed head crosses into the port and back unchanged."""
    pj = ju4.quantize_pack_u4(jnp.asarray(_weight(300, 640, seed=2)))
    tree = to_numpy_tree({"lm_head": pj})
    pt = weights.params_from_numpy(tree, "cpu")["lm_head"]
    back = weights.params_to_numpy({"lm_head": pt})["lm_head"]
    for f in "wsz":
        np.testing.assert_array_equal(np.asarray(back[f]).view(np.uint8),
                                      np.asarray(tree["lm_head"][f])
                                      .view(np.uint8))
    assert weights.params_to(pt, "cpu").out_features == 300
    with pytest.raises(ValueError):
        tu4._check_uniform(tu4.PackedU4Linear(pt.w[:-1], pt.s, pt.z, 640,
                                              300), torch.device("cpu"))


@pytest.mark.parametrize("n_kt,n,b,want", [
    (4, 32768, 8, 4),        # lm_head at B=8: 256 column blocks, no split
    (4, 32768, 2048, 4),     # at B=2048 the row tiles fill the card
    (11, 4096, 8, 3),        # down (K 11008): 32 column blocks, 4 splits
    (4, 4096, 128, 1),       # o at 128 rows: 32 blocks, 4 splits
    (4, 32768, 40, 4),       # a verify round's 40 rows: 2 row blocks
])
def test_split_tiles(n_kt, n, b, want):
    """K7/K8's K split on a 132-SM H100: k-tiles per split, from the
    tile that B picks (enough blocks for one per SM's residency)."""
    assert tu4._split_tiles(n_kt, n, b, 132, UNIFORM_TILES) == want


@pytest.mark.parametrize("b,tile", [(1, 0), (8, 0), (9, 1), (16, 1),
                                    (17, 1), (32, 1), (33, 1), (64, 1),
                                    (65, 2), (2048, 2)])
def test_tile_rule(b, tile):
    """Rows up to 64 take a codes-major block of 8 or 32 rows (two row
    blocks above 32), then 128-row group-major tiles."""
    assert tu4._tile(b) == tile
    assert b <= 2 * UNIFORM_TILES[tile][0] or tile == len(UNIFORM_TILES) - 1


def _bf16_bits_to_f32(h):
    """uint32 array of bf16 bit patterns (low 16 bits) -> float32."""
    return (h.astype(np.uint32) << 16).view(np.float32)


def _codes_minus_zero(wa, wb, pos, z, nbits):
    """numpy emulation of csrc/uniform_gemv.cu pair_halves and
    codes_minus_zero: the 16-bit halves of word rows k (wa) and k + 1 (wb)
    that hold bit ``pos`` side by side (prmt 0x5410 / 0x7632), the code
    shifted into the low mantissa of bf16 128.0 (0x4300), minus bf16(128 +
    z) in f32 and rounded to bf16 (sub.bf16x2). Returns (k, k + 1) as
    float32."""
    wa = wa.astype(np.uint32)
    wb = wb.astype(np.uint32)
    if pos < 16:
        p = (wa & 0xFFFF) | ((wb & 0xFFFF) << 16)
    else:
        p = (wa >> 16) | (wb & 0xFFFF0000)
    mask2 = ((1 << nbits) - 1) * 0x00010001
    c = ((p >> np.uint32(pos & 15)) & np.uint32(mask2)) | np.uint32(0x43004300)
    zz = torch.tensor(128.0 + z, dtype=torch.float32).to(torch.bfloat16)
    out = []
    for half in (c & 0xFFFF, c >> 16):
        v = torch.from_numpy(_bf16_bits_to_f32(half))
        out.append((v.to(torch.bfloat16) - zz).float().numpy())
    return out


@pytest.mark.parametrize("nbits", [4, 2])
def test_magic_number_unpack_is_exact(nbits):
    """Every code value at every position of the word, with every zero,
    in words whose other bits are random and in words with the top bit set
    (negative int32): the kernel's unpack gives c - z exactly, for word
    row k in the low half and k + 1 in the high half."""
    rng = np.random.default_rng(nbits)
    per, maxq = 32 // nbits, (1 << nbits) - 1
    n = 64
    for j in range(per):
        pos = nbits * j
        for z in range(maxq + 1):
            ca = rng.integers(0, maxq + 1, n).astype(np.uint32)
            cb = rng.integers(0, maxq + 1, n).astype(np.uint32)
            ca[: maxq + 1] = np.arange(maxq + 1)     # every value
            cb[: maxq + 1] = np.arange(maxq + 1)[::-1]
            fill = rng.integers(0, 2**32, (2, n), dtype=np.uint64).astype(
                np.uint32)
            fill[:, ::2] |= np.uint32(0x80000000)    # negative as int32
            field = np.uint32(maxq << pos)
            wa = (fill[0] & ~field) | (ca << np.uint32(pos))
            wb = (fill[1] & ~field) | (cb << np.uint32(pos))
            assert (wa.view(np.int32) < 0).any()
            lo, hi = _codes_minus_zero(wa, wb, pos, float(z), nbits)
            np.testing.assert_array_equal(lo, ca.astype(np.float32) - z)
            np.testing.assert_array_equal(hi, cb.astype(np.float32) - z)


def _codes(p):
    """Integer codes [KP, N] of a packed weight, row k = input column k."""
    per = p.per_word
    wv = p.w.reshape(p.kp // tu4.KT, 1, tu4.KT // per, p.n_padded)
    shifts = (torch.arange(per, dtype=torch.int32) * p.BITS)[
        None, :, None, None]
    return ((wv >> shifts) & ((1 << p.BITS) - 1)).reshape(p.kp, p.n_padded)


def _group_folded(x, p):
    """The kernel's algebra: per quant group g, acc += s_g * (bf16(x)_g .
    (c_g - z_g)), with f32 sums (the products are exact)."""
    xb = x.to(torch.bfloat16).float()
    xb = torch.nn.functional.pad(xb, (0, p.kp - p.in_features))
    c = _codes(p).float()
    acc = torch.zeros((x.shape[0], p.n_padded), dtype=torch.float32)
    for g in range(p.kp // tu4.GROUP):
        k = slice(g * tu4.GROUP, (g + 1) * tu4.GROUP)
        part = xb[:, k] @ (c[k] - p.z[g].float())
        acc += p.s[g].float() * part
    return acc[:, : p.out_features]


@pytest.mark.parametrize("nbits", [4, 2])
@pytest.mark.parametrize("b,o,k", [(1, 300, 640), (17, 1024, 1088),
                                   (130, 320, 2048)])
def test_group_folded_algebra_matches_plain(nbits, b, o, k):
    """s_g * (x_g . (c_g - z_g)) summed group by group in f32 (what K7/K8
    compute on the tensor cores) equals the plain version bf16(x) @
    dequant within 1e-6 of max|y|: only the f32 summation order and the
    rounding of s * (c - z) differ."""
    _, tpack, _ = PACKERS[nbits]
    p = tpack(torch.from_numpy(_weight(o, k, seed=b + nbits)))
    x = torch.from_numpy(np.random.default_rng(b).standard_normal(
        (b, k)).astype(np.float32))
    got = _group_folded(x, p)
    want = tu4.uniform_matmul_plain(x, p)
    assert got.shape == want.shape == (b, o)
    assert rel(got, want) <= 1e-6
