"""mxq_tpu_torch.packfmt against mxq_tpu.packfmt: the packed arrays bit for
bit, the reference dequant, the input split, closed-form bit patterns, and
the numpy bridge of ``mxq_tpu_torch.weights``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxq_tpu import packfmt as jpf
from mxq_tpu_torch import packfmt as tpf
from mxq_tpu_torch import weights
from torch_port_helpers import bits, to_torch

SHAPES = [(256, 256), (300, 640), (1024, 1088)]


def _weight(o, k, seed=0):
    return np.random.default_rng(seed).standard_normal((o, k)).astype(
        np.float32)


@pytest.mark.parametrize("o,k", SHAPES)
def test_quantize_pack_bit_exact(o, k):
    """Every field equals JAX's eager quantize_pack bit for bit (under jit,
    XLA turns division by a constant into a reciprocal multiply and the
    JAX side itself moves by an ulp; the port matches the eager result)."""
    w = _weight(o, k)
    pj = jpf.quantize_pack(jnp.asarray(w))
    pt = tpf.quantize_pack(torch.from_numpy(w))
    assert (pt.in_features, pt.out_features) == (k, o)
    for f in tpf.FIELDS:
        a, b = to_torch(getattr(pj, f)), getattr(pt, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(bits(a), bits(b)), f


@pytest.mark.parametrize("o,k", SHAPES)
def test_unpack_dequant_and_split_agree(o, k):
    w = _weight(o, k, seed=1)
    pj = jpf.quantize_pack(jnp.asarray(w))
    pt = tpf.quantize_pack(torch.from_numpy(w))
    np.testing.assert_array_equal(tpf.unpack_dequant(pt).numpy(),
                                  np.asarray(jpf.unpack_dequant(pj)))
    np.testing.assert_array_equal(tpf.fake_quant_packed(
        torch.from_numpy(w)).numpy(),
        np.asarray(jpf.fake_quant_packed(jnp.asarray(w))))
    x = np.random.default_rng(2).standard_normal((3, 2, k)).astype(np.float32)
    x2j, x4j = jpf.pad_inputs_split(jnp.asarray(x), pj)
    x2t, x4t = tpf.pad_inputs_split(torch.from_numpy(x), pt)
    np.testing.assert_array_equal(x2t.numpy(), np.asarray(x2j))
    np.testing.assert_array_equal(x4t.numpy(), np.asarray(x4j))


def test_negative_words_pack_and_unpack():
    """The 2-bit code at bits 30-31 makes a word negative: packing must
    wrap it into int32 and unpacking must mask after the arithmetic shift."""
    codes = torch.full((16, 4), 3, dtype=torch.int64)
    w = tpf._pack_along_sublanes(codes, 2)
    assert w.dtype == torch.int32 and int(w[0, 0]) == -1
    assert torch.equal(tpf._unpack_along_sublanes(w, 2),
                       codes.to(torch.int32))


class TestClosedFormBitPatterns:
    """Hand-constructed packed constants -> exact expected dequant values
    (the port of tests/test_packfmt.py::TestClosedFormBitPatterns)."""

    def test_all_patterns(self):
        nbp, n = 16, 256
        full = lambda shape, v, dt: torch.full(shape, v, dtype=dt)  # noqa: E731
        smeta4 = torch.zeros((8, n))
        smeta4[0], smeta4[1] = 2.0, 5.0          # s4=2, z4=5
        p = tpf.PackedMXQLinear(
            # 2b codes 0b10 everywhere; 4b codes 0b1001 = 9
            w2=full((nbp * 3, n), int(np.uint32(0xAAAAAAAA).astype(np.int32)),
                    torch.int32),
            w4=full((nbp * 2, n), 0x99999999 - (1 << 32), torch.int32),
            meta2=full((nbp, n), (1 << 0) | (1 << 2) | (1 << 4)
                       | (2 << 6) | (2 << 14) | (2 << 22), torch.int32),
            qscale=full((nbp, n), 0.5, torch.bfloat16),
            qmin=full((nbp, n), 1.0, torch.bfloat16),
            smeta4=smeta4, in_features=nbp * 64, out_features=n)
        wdq = tpf.unpack_dequant(p).numpy()        # [K, N]
        wk = wdq.T.reshape(n, nbp, 64)
        # s_eff = 0.5*2 + 1 = 2, w2 = 2*(2-1) = 2; w4 = 2*(9-5) = 8
        np.testing.assert_array_equal(wk[:, :, :48], 2.0)
        np.testing.assert_array_equal(wk[:, :, 48:], 8.0)
        y = np.ones((1, nbp * 64), np.float32) @ wdq
        np.testing.assert_array_equal(y, 224.0 * nbp)


def test_params_from_numpy_round_trip():
    """numpy tree -> port params -> numpy tree is the identity, bf16 and
    packed fields included."""
    import ml_dtypes
    rng = np.random.default_rng(3)
    pt = tpf.quantize_pack(torch.from_numpy(_weight(128, 256)))
    tree = {"embed": rng.standard_normal((4, 8)).astype(ml_dtypes.bfloat16),
            "layers": {"norm": rng.standard_normal((2, 8)).astype(np.float32),
                       "proj": weights.params_to_numpy(pt)}}
    params = weights.params_from_numpy(tree, "cpu")
    assert params["embed"].dtype == torch.bfloat16
    assert isinstance(params["layers"]["proj"], tpf.PackedMXQLinear)
    for f in tpf.FIELDS:
        assert torch.equal(bits(getattr(params["layers"]["proj"], f)),
                           bits(getattr(pt, f)))
    back = weights.params_to_numpy(params)
    np.testing.assert_array_equal(back["embed"].view(np.uint16),
                                  tree["embed"].view(np.uint16))
    np.testing.assert_array_equal(back["layers"]["norm"],
                                  tree["layers"]["norm"])
    assert back["layers"]["proj"]["in_features"] == 256
    assert back["layers"]["proj"]["out_features"] == 128


def test_layer_and_stack_views():
    ps = [tpf.quantize_pack(torch.from_numpy(_weight(64, 128, s)))
          for s in range(3)]
    st = tpf.stack_packed(ps)
    assert st.stacked and st.nbp == 16 and st.n_padded == 1024
    for i, p in enumerate(ps):
        li = st.layer(i)
        assert not li.stacked
        for f in tpf.FIELDS:
            assert torch.equal(bits(getattr(li, f)), bits(getattr(p, f)))
            assert getattr(li, f).is_contiguous()


def test_scheme_primitives_match_jax():
    from mxq_tpu import scheme as jsc
    from mxq_tpu_torch import scheme as tsc
    x = np.random.default_rng(6).standard_normal((8, 128)).astype(np.float32)
    x[0] = 0.25                                  # degenerate row
    sj, zj = jsc.asym_find_params(jnp.asarray(x), 3)
    st, zt = tsc.asym_find_params(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_array_equal(
        tsc.asym_qdq(torch.from_numpy(x), st[:, None], zt[:, None], 3)
        .numpy(),
        np.asarray(jsc.asym_qdq(jnp.asarray(x), sj[:, None], zj[:, None], 3)))
    lo, hi = tsc.split_blocks(torch.from_numpy(x))
    loj, hij = jsc.split_blocks(jnp.asarray(x))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(loj))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(hij))
    assert torch.equal(tsc.merge_blocks(lo, hi), torch.from_numpy(x))
