"""mxq_tpu_torch.scheme's fake-quant forward and straight-through
estimators against the goldens captured from the original torch reference
(tests/golden/qat_*.npz, read as tests/test_scheme.py reads them, at its
tolerances) and against mxq_tpu.scheme on the same numpy-seeded inputs,
gradients against jax.grad."""

import os

import jax
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


def load(name):
    return np.load(os.path.join(GOLDEN, name + ".npz"))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def close(a, b, atol):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0,
                               atol=atol)


# --- the goldens of tests/test_scheme.py --------------------------------


def test_mxasym_golden():
    g = load("qat_mxasym")
    close(ts.mxq_fake_quant_qat(t(g["w"]), CFG), g["out"], 1e-6)


def test_mxasym_ste_backward_golden():
    g = load("qat_mxasym")
    w = t(g["w_big"]).requires_grad_()
    (ts.mxq_fake_quant_ste(w, CFG) * t(g["coeff"])).sum().backward()
    close(w.grad, g["grad_big"], 1e-6)


def test_sym_a8_golden():
    g = load("qat_sym_a8")
    close(ts.sym_fake_quant(t(g["x"]), bits=8, groupsize=128), g["out"], 1e-6)
    close(ts.sym_fake_quant(t(g["x"]), bits=8, layerwise=True), g["out_lw"],
          1e-6)


def test_sym3d_reference_bug_golden():
    g = load("qat_sym3d")
    close(ts.sym_fake_quant_ref3d(t(g["x"]), bits=8), g["out"], 1e-6)
    with pytest.raises(ValueError):
        ts.sym_fake_quant_ref3d(t(g["x"])[0], bits=8)


def test_asym_a4_golden():
    g = load("qat_asym_a4")
    close(ts.asym_fake_quant(t(g["x"]), bits=4, groupsize=8), g["out"], 1e-6)
    close(ts.asym_fake_quant(t(g["x"]), bits=4, layerwise=True), g["out_lw"],
          1e-6)


def test_mx1_golden():
    g = load("qat_mx1")
    close(ts.mx1_fake_quant_qat(t(g["w"]), ratio_2b=0.6), g["out"], 1e-6)


def test_binary_golden():
    g = load("qat_w1")
    close(ts.binary_fake_quant(t(g["w"]), groupsize=8), g["wq"], 1e-5)


# --- against mxq_tpu.scheme on seeded inputs -----------------------------


def _w(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


CASES = {
    "mxq_qat": (lambda m, x: m.mxq_fake_quant_qat(
        x, CFG if m is ts else JConfig()), (96, 640)),
    "sym8": (lambda m, x: m.sym_fake_quant(x, 8, groupsize=128), (3, 5, 256)),
    "sym4_layerwise": (lambda m, x: m.sym_fake_quant(x, 4, layerwise=True),
                       (6, 128)),
    "sym8_ref3d": (lambda m, x: m.sym_fake_quant_ref3d(x, 8), (2, 300, 256)),
    "asym4": (lambda m, x: m.asym_fake_quant(x, 4, groupsize=8), (4, 7, 64)),
    "asym3_layerwise": (lambda m, x: m.asym_fake_quant(x, 3, layerwise=True),
                        (5, 40)),
    "mx1": (lambda m, x: m.mx1_fake_quant_qat(x, ratio_2b=0.6), (16, 200)),
    "binary": (lambda m, x: m.binary_fake_quant(x, groupsize=8), (12, 64)),
    "binary_layerwise": (lambda m, x: m.binary_fake_quant(x, layerwise=True),
                         (12, 64)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    """Each ported function against its JAX function: equal to 2e-7 of
    max|x| (XLA may fuse a division or multiply-add that torch rounds
    twice; measured 0 or a few f32 ulps)."""
    fn, shape = CASES[name]
    x = _w(len(name), shape)
    want = np.asarray(fn(js, jnp.asarray(x)))
    got = fn(ts, torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= 2e-7 * np.abs(x).max()


def test_bf16_inputs_keep_their_type():
    x = torch.from_numpy(_w(1, (4, 256))).to(torch.bfloat16)
    for y in (ts.sym_fake_quant(x, 8), ts.asym_fake_quant(x, 4),
              ts.mxq_fake_quant_qat(x), ts.binary_fake_quant(x)):
        assert y.dtype == torch.bfloat16 and y.shape == x.shape


@pytest.mark.parametrize("name", ["mxq", "sym", "asym"])
def test_ste_gradient_matches_jax_grad(name):
    """The clipped straight-through backward against jax.grad of the JAX
    custom_vjp: the cotangent passes where -clip < x < clip, else 0.
    Inputs are spread to +-3 so the mask cuts."""
    x = _w(7, (8, 256), scale=1.5)
    coeff = _w(8, (8, 256))
    if name == "mxq":
        jf = lambda v: js.mxq_fake_quant_ste(v, JConfig())    # noqa: E731
        tf = lambda v: ts.mxq_fake_quant_ste(v, CFG)          # noqa: E731
    elif name == "sym":
        jf = lambda v: js.sym_fake_quant_ste(v, 8)            # noqa: E731
        tf = lambda v: ts.sym_fake_quant_ste(v, 8)            # noqa: E731
    else:
        jf = lambda v: js.asym_fake_quant_ste(v, 4)           # noqa: E731
        tf = lambda v: ts.asym_fake_quant_ste(v, 4)           # noqa: E731
    want = np.asarray(jax.grad(lambda v: jnp.sum(jf(v) * coeff))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (tf(xt) * torch.from_numpy(coeff)).sum().backward()
    assert np.array_equal(xt.grad.numpy(), want)
    clipped = np.abs(x) >= 2.0
    assert clipped.any() and (xt.grad.numpy()[clipped] == 0).all()
    assert np.array_equal(xt.grad.numpy()[~clipped], coeff[~clipped])


# every QAT fake-quant at llama2_7b's hidden width, as the training and
# eval-ppl forward call them (ref3d on [2, 128, 4096])
EAGER_CASES = {
    "sym8": lambda m, x: m.sym_fake_quant(x, 8),
    "sym4": lambda m, x: m.sym_fake_quant(x, 4),
    "sym8_layerwise": lambda m, x: m.sym_fake_quant(x, 8, layerwise=True),
    "sym4_layerwise": lambda m, x: m.sym_fake_quant(x, 4, layerwise=True),
    "sym8_ref3d": lambda m, x: m.sym_fake_quant_ref3d(
        x.reshape(2, 128, 4096), 8),
    "asym4": lambda m, x: m.asym_fake_quant(x, 4),
    "mxq_qat": lambda m, x: m.mxq_fake_quant_qat(x),
    "mx1": lambda m, x: m.mx1_fake_quant_qat(x),
}


@pytest.mark.parametrize("name", sorted(EAGER_CASES))
def test_bit_equal_to_jax_eager(name):
    """Each fake-quant equals JAX's, run op by op (``jax.disable_jit``), bit
    for bit on a (256, 4096) seed-0 standard normal: every division by a
    constant is an IEEE division. Dividing a Python number by a tensor
    (``reciprocal() * number`` in PyTorch) left 237,769 outputs of sym8,
    192,422 of sym4 and 275,032 of ref3d one ulp off."""
    fn = EAGER_CASES[name]
    x = np.random.default_rng(0).standard_normal((256, 4096)).astype(
        np.float32)
    with jax.disable_jit():
        want = np.asarray(fn(js, jnp.asarray(x)))
    got = fn(ts, torch.from_numpy(x))
    assert torch.equal(got, torch.from_numpy(want.copy()))
