"""Layer-sequential PTQ (ptq/calibrate), the checkpoint (utils/checkpoint)
and ``cli ptq`` of the port against mxq_tpu's on the tiny preset, from
one numpy-seeded HF checkpoint whose layer 0 has a dead input column
(input_layernorm[DEAD] = 0, so q/k/v see an all-zero input there).

Against JAX run op by op (``jax.disable_jit()``), packed mode is bit-equal
field for field and the quant-dequantized weights equal to 1e-6 (measured
0), and reference mode likewise. Jitted, JAX moves some second-order
scales by one bf16 ulp (XLA folds a division by a constant into a
multiply; ROADMAP.md queue 3): the codes stay equal."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxq_tpu import cli as jcli
from mxq_tpu.config import MXQConfig as JConfig
from mxq_tpu.models import hf_loader as jhf
from mxq_tpu.ptq import calibrate as jc
from mxq_tpu.ptq import data as jdata
from mxq_tpu_torch import cli, packfmt
from mxq_tpu_torch.models import hf_loader as thf
from mxq_tpu_torch.models import llama as tl
from mxq_tpu_torch.ptq import calibrate as tc
from mxq_tpu_torch.utils import checkpoint
from test_torch_hf_loader import hf_tensors, write_checkpoint
from torch_port_helpers import bits, to_torch

CFG = tl.LlamaConfig.tiny()
DEAD = 5
IDS = jdata.get_calibration_batch(4, 32, vocab_size=CFG.vocab_size, seed=1)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(checkpoint dir, JAX config, JAX params, port params), f32."""
    path = tmp_path_factory.mktemp("hf")
    tensors = hf_tensors(CFG, seed=4)
    tensors["model.layers.0.input_layernorm.weight"][DEAD] = 0.0
    write_checkpoint(path, CFG, tensors)
    jcfg, jparams = jhf.load_params(str(path), dtype=jnp.float32)
    _, params = thf.load_params(str(path), dtype=torch.float32, device="cpu")
    return path, jcfg, jparams, params


def _ptq(model, mode, jit):
    _, jcfg, jparams, params = model
    if jit:
        want = jc.ptq_quantize(jparams, jcfg, jnp.asarray(IDS),
                               jc.PTQConfig(mode=mode))
    else:
        with jax.disable_jit():
            want = jc.ptq_quantize(jparams, jcfg, jnp.asarray(IDS),
                                   jc.PTQConfig(mode=mode))
    got = tc.ptq_quantize(params, CFG, IDS, tc.PTQConfig(mode=mode),
                          device="cpu")
    return want, got


@pytest.fixture(scope="module")
def packed_eager(model):
    return _ptq(model, "packed", jit=False)


def _qparams_close(want, got, atol=1e-6):
    for name in tl.LAYER_LINEARS:
        w = to_torch(want["layers"][name])
        assert got["layers"][name].dtype == w.dtype
        assert float((got["layers"][name] - w).abs().max()) <= atol, name


def test_packed_ptq_bit_equal_to_jax_op_by_op(packed_eager):
    (jq, jp), (q, p) = packed_eager
    _qparams_close(jq, q)
    for name in tl.LAYER_LINEARS:
        pj, pt = jp["layers"][name], p["layers"][name]
        assert (pt.in_features, pt.out_features) == (pj.in_features,
                                                     pj.out_features)
        for f in packfmt.FIELDS:
            w = to_torch(getattr(pj, f))
            assert getattr(pt, f).dtype == w.dtype, (name, f)
            assert torch.equal(bits(getattr(pt, f)), bits(w)), (name, f)
    for k in ("input_layernorm", "post_attention_layernorm"):
        assert p["layers"][k] is q["layers"][k]
    # one pass: the artifact dequantizes to the quant-dequantized weights
    for i in range(CFG.num_hidden_layers):
        for name in tl.LAYER_LINEARS:
            assert torch.equal(packfmt.unpack_dequant(
                p["layers"][name].layer(i)), q["layers"][name][i])


def test_reference_ptq_matches_jax_op_by_op(model):
    (jq, jp), (q, p) = _ptq(model, "reference", jit=False)
    assert jp is None and p is None
    _qparams_close(jq, q)


def test_dead_input_column_zeroed_on_both_sides(model, packed_eager):
    """Layer 0's q/k/v are quantized with input row DEAD zeroed (their
    input is 0 there), on both sides; the other linears are not."""
    (jq, _), (q, _) = packed_eager
    params = model[3]
    for name in tl.LAYER_LINEARS:
        w = params["layers"][name][0]
        zeroed = w.clone()
        zeroed[DEAD] = 0.0
        dead = name in ("q_proj", "k_proj", "v_proj")
        want = packfmt.unpack_dequant(packfmt.quantize_pack(
            (zeroed if dead else w).T))
        assert torch.equal(q["layers"][name][0], want), name
        if dead:
            other = packfmt.unpack_dequant(packfmt.quantize_pack(w.T))
            assert not torch.equal(want[DEAD], other[DEAD])
            assert torch.equal(to_torch(jq["layers"][name][0])[DEAD],
                               want[DEAD])


def test_packed_ptq_against_jitted_jax(model):
    """Jitted JAX: codes and meta words equal; qscale and qmin within one
    bf16 ulp, the 4-bit scales within 2 f32 ulps."""
    (_, jp), (_, p) = _ptq(model, "packed", jit=True)
    for name in tl.LAYER_LINEARS:
        pj, pt = jp["layers"][name], p["layers"][name]
        for f in ("w2", "w4", "meta2"):
            assert torch.equal(getattr(pt, f), to_torch(getattr(pj, f)))
        for f in ("qscale", "qmin"):
            a = getattr(pt, f).view(torch.int16).int()
            b = to_torch(getattr(pj, f)).view(torch.int16).int()
            assert int((a - b).abs().max()) <= 1, (name, f)
        w = to_torch(pj.smeta4)
        assert torch.allclose(pt.smeta4, w, rtol=2 ** -22, atol=0), name


@pytest.mark.parametrize("mode", tc.MODES)
def test_chunked_equals_unchunked(model, mode):
    """Column statistics summed over chunks of 2 samples and the layer run
    chunk by chunk give the same weights and artifact."""
    params = model[3]
    q1, p1 = tc.ptq_quantize(params, CFG, IDS, tc.PTQConfig(mode=mode),
                             device="cpu")
    q2, p2 = tc.ptq_quantize(params, CFG, IDS, tc.PTQConfig(mode=mode,
                                                            chunk=2),
                             device="cpu")
    for name in tl.LAYER_LINEARS:
        assert torch.equal(q1["layers"][name], q2["layers"][name])
        if mode == "packed":
            for f in packfmt.FIELDS:
                assert torch.equal(getattr(p1["layers"][name], f),
                                   getattr(p2["layers"][name], f))


def test_ptq_rejects_unknown_mode_and_device(model):
    params = model[3]
    with pytest.raises(ValueError, match="mode"):
        tc.ptq_quantize(params, CFG, IDS, tc.PTQConfig(mode="gptq"),
                        device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tc.ptq_quantize(params, CFG, IDS)


def test_cli_ptq_save_reload(model, tmp_path, capsys, monkeypatch):
    """``cli ptq --mode packed --save_model`` on the checkpoint: the lines
    of mxq_tpu's cli ptq and its perplexity to 1e-3 (JAX op by op); the
    saved packed params reload bit for bit and give the same logits."""
    path = str(model[0])
    args = ["ptq", "--model", path, "--mode", "packed", "--nsamples", "4",
            "--seqlen", "32", "--max_eval_windows", "2"]
    with jax.disable_jit():
        jcli.main(args)
    want = capsys.readouterr().out.strip().splitlines()
    seen = []
    real = tc.ptq_quantize

    def record(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(tc, "ptq_quantize", record)
    out = cli.main(args + ["--device", "cpu", "--save_model",
                           str(tmp_path)])
    got = capsys.readouterr().out.strip().splitlines()
    assert got[:3] == want[:3] == [
        "calibrating 2 layers on 4x32 wikitext2 tokens (mode=packed)",
        "  layer 0 done", "  layer 1 done"]
    jppl = float(want[3].split(": ")[1])
    assert got[3] == f"wikitext2 ppl (quantized): {out['ppl']:.4f}"
    assert abs(out["ppl"] - jppl) <= 1e-3 * jppl
    assert got[4] == f"saved to {tmp_path}"
    assert len(out["layer_seconds"]) == 2

    cfg, params = checkpoint.load_params(str(tmp_path), device="cpu")
    packed = seen[0][1]
    assert cfg == CFG
    ids = np.arange(40)[None] % CFG.vocab_size
    want_logits, _ = tl.forward(packed, ids, cfg, device="cpu")
    got_logits, _ = tl.forward(params, ids, cfg, device="cpu")
    assert torch.equal(got_logits, want_logits)


def test_checkpoint_roundtrip_and_schema(tmp_path):
    """Dense and packed params reload bit for bit; mxq_config.json holds
    mxq_tpu's keys: the config with the scheme's fields under ``scheme``,
    and each packed linear's in/out features."""
    cfg = tl.LlamaConfig.tiny(num_hidden_layers=1)
    dense = tl.init_params(cfg, seed=2, dtype=torch.bfloat16, device="cpu")
    for params in (dense, tl.quantize_params_packed(dense, cfg,
                                                    device="cpu")):
        checkpoint.save_params(str(tmp_path), params, cfg)
        got_cfg, got = checkpoint.load_params(str(tmp_path), device="cpu")
        assert got_cfg == cfg
        assert set(got) == set(params)
        assert set(got["layers"]) == set(params["layers"])
        for k, v in params["layers"].items():
            g = got["layers"][k]
            if isinstance(v, packfmt.PackedMXQLinear):
                assert (g.in_features, g.out_features) == (
                    v.in_features, v.out_features)
                assert all(torch.equal(getattr(g, f), getattr(v, f))
                           for f in packfmt.FIELDS)
            else:
                assert torch.equal(bits(g), bits(v))
        for k in ("embed_tokens", "norm", "lm_head"):
            assert torch.equal(bits(got[k]), bits(params[k]))
    with open(tmp_path / "mxq_config.json") as f:
        info = json.load(f)
    assert set(info) == {"config", "packed"}
    assert info["config"]["scheme"] == JConfig().__dict__
    assert info["packed"]["qkv_proj"] == {"in_features": 256,
                                          "out_features": 768}
