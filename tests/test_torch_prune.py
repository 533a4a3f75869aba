"""ptq/prune of the port against mxq_tpu's on numpy-seeded inputs: the
magnitude and Wanda masks (unstructured and 2:4) and Wanda's alpha search
equal JAX's; SparseGPT and the GPTQ 1-bit/4-bit quantizer keep >= 0.999
of JAX's mask and their weights within 1e-6 of max|W| (measured: masks
equal, weights 3.2-3.8e-7 for SparseGPT and 1.2-1.8e-7 for GPTQ, because
the Cholesky factor and the f32 sums of XLA and of torch's CPU library
round apart); the permutations
equal JAX's; ``prune_model`` (Wanda 2:4) on the tiny preset equals
JAX's, and ``cli prune`` prints mxq_tpu's lines."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxq_tpu.models import llama as jl
from mxq_tpu.ptq import data as jdata
from mxq_tpu.ptq import prune as jp
from mxq_tpu_torch import cli
from mxq_tpu_torch.models import llama as tl
from mxq_tpu_torch.ptq import prune as tp
from torch_port_helpers import port_params, to_torch


def _w(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


W = _w(0, (128, 64))                       # [in, out]
COL_SQ = np.abs(_w(1, (128,))) * 3
X = _w(2, (256, 128))
X[:, 7] = 0.0                              # a dead input
H = (2.0 / 256) * (X.T @ X)


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("nm", [(0, 0), (2, 4), (1, 4)])
def test_masks_equal_jax(nm):
    n, m = nm
    for sp in (0.5, 0.3):
        assert np.array_equal(tp.magnitude_mask(t(W), sp, n, m).numpy(),
                              np.asarray(jp.magnitude_mask(
                                  jnp.asarray(W), sp, n, m)))
        assert np.array_equal(
            tp.wanda_mask(t(W), t(COL_SQ), sp, n, m).numpy(),
            np.asarray(jp.wanda_mask(jnp.asarray(W), jnp.asarray(COL_SQ),
                                     sp, n, m)))


def test_ties_rank_as_jax():
    """Equal metrics (zero weights) rank by position on both sides."""
    w = W.copy()
    w[::3] = 0.0
    for n, m in ((2, 4), (0, 0)):
        assert np.array_equal(
            tp.magnitude_mask(t(w), 0.5, n, m).numpy(),
            np.asarray(jp.magnitude_mask(jnp.asarray(w), 0.5, n, m)))


def test_quantile_is_jax_linear_quantile():
    """Bit-equal to jnp.quantile op by op; jitted, XLA fuses the
    interpolation's multiply and add, one f32 ulp apart."""
    x = _w(3, (37, 11))
    for q in (0.0, 0.25, 0.5, 0.9, 1.0):
        got = tp.quantile(t(x), q, 0).numpy()
        with jax.disable_jit():
            want = np.asarray(jnp.quantile(jnp.asarray(x), q, axis=0,
                                           keepdims=True))
            want_all = np.asarray(jnp.quantile(jnp.asarray(x), q))
        assert np.array_equal(got, want)
        assert np.array_equal(tp.quantile(t(x), q).numpy(), want_all)
        jit = np.asarray(jnp.quantile(jnp.asarray(x), q, axis=0,
                                      keepdims=True))
        assert np.allclose(got, jit, rtol=2 ** -23, atol=0)


def test_wanda_alpha_search_equals_jax():
    for sp in (0.5, 0.6):
        got = tp.wanda_mask_alpha(t(W), t(COL_SQ), sp).numpy()
        want = np.asarray(jp.wanda_mask_alpha(jnp.asarray(W),
                                              jnp.asarray(COL_SQ), sp))
        assert np.array_equal(got, want)
        assert abs(float((~got).mean()) - sp) <= 2e-3


def _close_weights(got, want, mask_gate=0.999, rel=1e-6):
    got, want = got.numpy(), np.asarray(want)
    assert float(((got == 0) == (want == 0)).mean()) >= mask_gate
    assert float(np.abs(got - want).max()) <= rel * np.abs(want).max()


@pytest.mark.parametrize("nm", [(0, 0), (2, 4)])
def test_sparsegpt_matches_jax(nm):
    got = tp.sparsegpt_prune(t(W), t(H), 0.5, n=nm[0], m=nm[1])
    want = jp.sparsegpt_prune(jnp.asarray(W), jnp.asarray(H), 0.5,
                              n=nm[0], m=nm[1])
    _close_weights(got, want)
    assert got.dtype == torch.float32
    assert bool((got[7] == 0).all())          # the dead input is zeroed
    frac = float((got == 0).float().mean())
    assert 0.49 <= frac <= 0.52


@pytest.mark.parametrize("split_sign", [False, True])
@pytest.mark.parametrize("nm", [(0, 0), (2, 4)])
def test_gptq_1b4b_matches_jax(nm, split_sign):
    got = tp.gptq_quantize_1b4b(t(W), t(H), 0.5, blocksize=64, n=nm[0],
                                m=nm[1], split_sign=split_sign)
    want = jp.gptq_quantize_1b4b(jnp.asarray(W), jnp.asarray(H), 0.5,
                                 blocksize=64, n=nm[0], m=nm[1],
                                 split_sign=split_sign)
    _close_weights(got, want)


def test_permutations_equal_jax():
    d = t(np.abs(_w(4, (64,))))
    assert np.array_equal(tp.act_order_permutation(d).numpy(),
                          np.asarray(jp.act_order_permutation(
                              jnp.asarray(d.numpy()))))
    assert np.array_equal(
        tp.sparse_act_order_permutation(t(W), t(H)).numpy(),
        np.asarray(jp.sparse_act_order_permutation(jnp.asarray(W),
                                                   jnp.asarray(H))))
    small = W[:, :24]
    for use_abs in (False, True):
        assert np.array_equal(
            tp.greedy_nearest_permutation(t(small), use_abs).numpy(),
            np.asarray(jp.greedy_nearest_permutation(jnp.asarray(small),
                                                     use_abs)))
        assert np.array_equal(
            tp.spearman_permutation(t(small), use_abs).numpy(),
            np.asarray(jp.spearman_permutation(jnp.asarray(small),
                                               use_abs)))


@pytest.fixture(scope="module")
def tiny():
    cfg = jl.LlamaConfig.tiny()
    params = jl.init_params(cfg, jax.random.PRNGKey(5))
    ids = jdata.get_calibration_batch(2, 32, vocab_size=cfg.vocab_size)
    return cfg, params, port_params(params), ids


def test_prune_model_wanda_2_4_equals_jax(tiny):
    jcfg, jparams, params, ids = tiny
    want = jp.prune_model(jparams, jcfg, jnp.asarray(ids), "wanda", n=2, m=4)
    got = tp.prune_model(params, tl.LlamaConfig.tiny(), ids, "wanda", n=2,
                         m=4, device="cpu")
    for name in tl.LAYER_LINEARS:
        assert torch.equal(got["layers"][name],
                           to_torch(want["layers"][name])), name
    assert tp.check_sparsity(got) == jp.check_sparsity(want) == 0.5
    assert got["embed_tokens"] is params["embed_tokens"]


def test_prune_model_methods_and_errors(tiny):
    _, _, params, ids = tiny
    cfg = tl.LlamaConfig.tiny()
    for method, sp in (("magnitude", 0.5), ("sparsegpt", 0.5),
                       ("wanda", 0.25)):
        got = tp.prune_model(params, cfg, ids, method, sp, device="cpu")
        assert abs(tp.check_sparsity(got) - sp) <= 0.01, method
    with pytest.raises(ValueError, match="method"):
        tp.prune_model(params, cfg, ids, "obs", device="cpu")


def test_cli_prune_prints_jax_lines(capsys):
    out = cli.main(["prune", "--device", "cpu", "--prune_method", "wanda",
                    "--sparsity_type", "2:4", "--nsamples", "2",
                    "--seqlen", "32", "--max_eval_windows", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == ["actual sparsity 0.5000",
                     f"wikitext2 ppl (pruned): {out['ppl']:.4f}"]
    assert out["sparsity"] == 0.5 and out["prune_seconds"] > 0
