"""The PTQ half of mxq_tpu_torch.scheme against the goldens captured from
the original torch reference (tests/golden/ptq_*.npz, at the tolerances
of tests/test_scheme.py) and against mxq_tpu.scheme on the same
numpy-seeded inputs: integer codes equal, floats within 1e-6."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxq_tpu import scheme as js
from mxq_tpu.config import MXQConfig as JConfig
from mxq_tpu_torch import scheme as ts
from mxq_tpu_torch.config import MXQConfig

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CFG = MXQConfig()
JCFG = JConfig()


def load(name):
    return np.load(os.path.join(GOLDEN, name + ".npz"))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                               atol=atol)


# --- the goldens of tests/test_scheme.py --------------------------------


def test_2b_group_with_double_quant_golden():
    g = load("ptq_quantizer_2b")
    w = t(g["w"])                               # [32, 16]: a group a row
    scale, zero = ts.asym_find_params(w, CFG.maxq_lo)
    close(zero, g["zero"][:, 0], 1e-6)
    dq = ts.double_quant_scales(scale, CFG.qq_scale_bits, CFG.qq_group)
    close(dq.scale_dq, g["scale"][:, 0], 1e-7)
    np.testing.assert_array_equal(dq.codes.numpy().reshape(-1, 16),
                                  g["scale_codes"])
    out = ts.asym_qdq(w, dq.scale_dq[:, None], zero[:, None], CFG.maxq_lo,
                      CFG.ptq_eps)
    close(out, g["out"], 1e-6)


def test_4b_rowwise_with_double_quant_golden():
    g = load("ptq_quantizer_4b")
    w = t(g["w"])
    scale, zero = ts.asym_find_params(w, CFG.maxq_hi)
    dq = ts.double_quant_scales(scale, CFG.qq_scale_bits, CFG.qq_group)
    out = ts.asym_qdq(w, dq.scale_dq[:, None], zero[:, None], CFG.maxq_hi,
                      CFG.ptq_eps)
    close(out, g["out"], 1e-6)


def test_fasterquant_full_layer_golden():
    """Whole-layer PTQ with dead columns zeroed first (mxqgpt.py:387-448)."""
    g = load("ptq_fasterquant")
    dead = (g["inp"] ** 2).sum(0) == 0
    w = t(g["w"])
    w[:, torch.from_numpy(dead)] = 0.0
    out = ts.mxq_fake_quant_ptq(w, CFG)
    close(out, g["out"], 1e-5)
    assert np.abs(out.numpy()[:, dead]).max() < 1.0


def test_1bit_outlier_golden():
    g = load("ptq_outlier_1b")
    out, mask = ts.mxq_outlier_quantize(t(g["w"]), bits=1, blocksize=16)
    close(out, g["out"], 1e-6)
    np.testing.assert_array_equal(mask.numpy(), g["mask"] != 0)


def test_leave_one_out_error_golden():
    g = load("ptq_loo_2b")
    red = ts.leave_one_out_error(t(g["w"]), t(g["hdiag"])[None, :], bits=2)
    close(red, g["red"], 1e-4, rtol=1e-4)


# --- against mxq_tpu.scheme on seeded inputs -----------------------------


def _w(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _same(got: torch.Tensor, want, atol=1e-6):
    """Integer arrays equal (dtype too), float arrays within ``atol``."""
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    if want.dtype.kind in "iub":
        assert got.dtype == want.dtype and np.array_equal(got, want)
    else:
        assert got.dtype == np.float32
        assert float(np.abs(got - want).max(initial=0.0)) <= atol


@pytest.mark.parametrize("round_zero", [False, True])
def test_double_quant_scales_matches_jax(round_zero):
    s = np.abs(_w(1, (6, 64))) + 0.01
    want = js.double_quant_scales(jnp.asarray(s), 4, 16, round_zero)
    got = ts.double_quant_scales(torch.from_numpy(s), 4, 16, round_zero)
    for f in want._fields:
        _same(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("round_zero", [False, True])
def test_quantize_dequantize_ptq_matches_jax(round_zero):
    """Every field of MXQQuantized (int8 codes equal, zeros and
    second-order scales within 1e-6), the dequantized weight and the
    fake-quant; round_zero's fields are integral and in range."""
    w = _w(2, (64, 256))
    want = js.mxq_quantize_ptq(jnp.asarray(w), JCFG, round_zero)
    got = ts.mxq_quantize_ptq(torch.from_numpy(w), CFG, round_zero)
    assert got._fields == want._fields
    for f in want._fields:
        _same(getattr(got, f), getattr(want, f))
    _same(ts.mxq_dequantize(got, CFG), js.mxq_dequantize(want, JCFG))
    fq = ts.mxq_fake_quant_ptq(torch.from_numpy(w), CFG, round_zero)
    _same(fq, js.mxq_fake_quant_ptq(jnp.asarray(w), JCFG, round_zero))
    assert torch.equal(fq, ts.mxq_dequantize(got, CFG))
    if round_zero:
        for arr, hi in ((got.lo_zero, CFG.maxq_lo), (got.hi_zero,
                        CFG.maxq_hi), (got.lo_qq_zero, CFG.maxq_qq),
                        (got.hi_qq_zero, CFG.maxq_qq)):
            assert arr.dtype == torch.int8
            assert int(arr.min()) >= 0 and int(arr.max()) <= hi


@pytest.mark.parametrize("num,den,bs", [(6, 10, 32), (6, 8, 16), (5, 8, 16)])
def test_fake_quant_ptq_ratio_matches_jax(num, den, bs):
    """The ratio variant, with a ragged last sub-block at 6/10 (38 = 32 +
    6 columns) and 5/8 (40 = 16 + 16 + 8); 6/8 with sub-blocks of 16 is
    the standard scheme."""
    w = _w(3, (32, 128))
    got = ts.mxq_fake_quant_ptq_ratio(torch.from_numpy(w), num, den, bs)
    _same(got, js.mxq_fake_quant_ptq_ratio(jnp.asarray(w), num, den, bs))
    if (num, den, bs) == (6, 8, 16):
        _same(got, ts.mxq_fake_quant_ptq(torch.from_numpy(w)), atol=0.0)


def test_rowmean_sign_and_sub2bit_match_jax():
    w = _w(4, (8, 64))
    _same(ts._rowmean_sign_qdq(torch.from_numpy(w).reshape(8, 4, 16)),
          js._rowmean_sign_qdq(jnp.asarray(w).reshape(8, 4, 16)))
    for bits, layerwise in ((1, False), (1, True), (2, False)):
        _same(ts.sub2bit_fake_quant(torch.from_numpy(w), bits, layerwise),
              js.sub2bit_fake_quant(jnp.asarray(w), bits, layerwise))


def test_leave_one_out_error_matches_jax():
    w = _w(5, (6, 4, 16))
    hd = np.abs(_w(6, (1, 4, 16))) + 0.5
    _same(ts.leave_one_out_error(torch.from_numpy(w), torch.from_numpy(hd),
                                 2),
          js.leave_one_out_error(jnp.asarray(w), jnp.asarray(hd), 2),
          atol=1e-5)


@pytest.mark.parametrize("bits", [1, 2])
def test_outlier_quantize_matches_jax(bits):
    """1 bit without and with the Hessian (dead input 9 zeroed), 2 bits
    with it: a planted outlier is kept, the masks equal JAX's."""
    w = _w(7, (16, 64))
    w[3, 17] = 8.0
    x = _w(8, (32, 64))
    x[:, 9] = 0.0
    h = (2.0 / 32) * (x.T @ x)
    cases = [(None,), (h,)] if bits == 1 else [(h,)]
    for (hh,) in cases:
        want_w, want_m = js.mxq_outlier_quantize(
            jnp.asarray(w), None if hh is None else jnp.asarray(hh),
            bits=bits)
        got_w, got_m = ts.mxq_outlier_quantize(
            torch.from_numpy(w), None if hh is None else torch.from_numpy(hh),
            bits=bits)
        _same(got_m, want_m)
        _same(got_w, want_w)
        assert bool(got_m[3, 17])
    with pytest.raises(ValueError, match="Hessian"):
        ts.mxq_outlier_quantize(torch.from_numpy(w), bits=2)


def test_div_const_is_ieee_division():
    """div_const rounds as x / c does in f32 (the CPU's division), which is
    what the card must reproduce (the card multiplies by 1/c for a Python
    divisor; tests/test_torch_kernels_cuda.py holds the packer there)."""
    x = torch.from_numpy(_w(9, (4096,)))
    for c in (3, 15, 255, 127.0):
        want = (x.double() / c).float()
        assert torch.equal(ts.div_const(x, c), want)
