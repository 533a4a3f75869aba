"""The port's safetensors reader/writer and HF loader against the
``safetensors`` package and mxq_tpu's loader: tiny random Llama
checkpoints (numpy-seeded) written by either writer, as one file or two
shards, loaded in f32 and bf16 by both packages: the same config and
tensors bit for bit. ``cli eval-ppl --model`` runs on such a checkpoint
and its perplexity agrees with mxq_tpu's (f32; 1e-3 relative, the dense
model's gate in test_torch_ppl.py)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxq_tpu import cli as jcli
from mxq_tpu.models import hf_loader as jhf
from mxq_tpu_torch import cli
from mxq_tpu_torch.models import hf_loader as thf
from mxq_tpu_torch.models import llama as tl
from mxq_tpu_torch.utils import safetensors_io
from torch_port_helpers import bits, to_torch

CFG = tl.LlamaConfig.tiny(num_key_value_heads=2)


def hf_tensors(cfg, seed=0, tied=False) -> dict:
    """HF-named f32 tensors of a random Llama (linears [out, in])."""
    rng = np.random.default_rng(seed)
    h, v = cfg.hidden_size, cfg.vocab_size

    def normal(shape, std, mean=0.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * std + mean).astype(np.float32))

    out = {"model.embed_tokens.weight": normal((v, h), 0.02)}
    for i in range(cfg.num_hidden_layers):
        for name, (fi, fo) in tl._linear_shapes(cfg).items():
            part = "mlp" if name in ("gate_proj", "up_proj",
                                     "down_proj") else "self_attn"
            out[f"model.layers.{i}.{part}.{name}.weight"] = normal(
                (fo, fi), fi ** -0.5)
        for name in ("input_layernorm", "post_attention_layernorm"):
            out[f"model.layers.{i}.{name}.weight"] = normal((h,), 0.1, 1.0)
    out["model.norm.weight"] = normal((h,), 0.1, 1.0)
    if not tied:
        out["lm_head.weight"] = normal((v, h), 0.02)
    return out


def write_checkpoint(path, cfg, tensors, writer="port", sharded=False):
    """config.json plus model.safetensors, or two shards and the index;
    the package's writer adds the metadata HF files carry."""
    st = None if writer == "port" else pytest.importorskip(
        "safetensors.torch")
    os.makedirs(path, exist_ok=True)
    keys = ("vocab_size", "hidden_size", "intermediate_size",
            "num_hidden_layers", "num_attention_heads",
            "num_key_value_heads", "max_position_embeddings",
            "rms_norm_eps", "rope_theta", "tie_word_embeddings")
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({k: getattr(cfg, k) for k in keys}, f)
    names = list(tensors)
    parts = ([names[: len(names) // 2], names[len(names) // 2:]] if sharded
             else [names])
    files = ([f"model-{i + 1:05d}-of-00002.safetensors" for i in range(2)]
             if sharded else ["model.safetensors"])
    for part, fname in zip(parts, files):
        chunk = {n: tensors[n] for n in part}
        if st is None:
            safetensors_io.save_file(chunk, os.path.join(path, fname))
        else:
            st.save_file(chunk, os.path.join(path, fname),
                         metadata={"format": "pt"})
    if sharded:
        with open(os.path.join(path, "model.safetensors.index.json"),
                  "w") as f:
            json.dump({"weight_map": {n: fname for part, fname in
                                      zip(parts, files) for n in part}}, f)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
@pytest.mark.parametrize("writer", ["port", "safetensors"])
def test_load_params_matches_jax(tmp_path, writer, sharded, dtype):
    """The port's load_params equals mxq_tpu's (config, every tensor bit
    for bit, in [in, out] and stacked per layer) for checkpoints stored in
    bf16 and read as ``dtype``."""
    tensors = {k: v.to(torch.bfloat16)
               for k, v in hf_tensors(CFG, seed=1).items()}
    write_checkpoint(tmp_path, CFG, tensors, writer, sharded)
    jcfg, jparams = jhf.load_params(str(tmp_path),
                                    dtype=getattr(jnp, dtype))
    cfg, params = thf.load_params(str(tmp_path), dtype=getattr(torch, dtype),
                                  device="cpu")
    assert cfg == CFG
    assert {f: getattr(jcfg, f) for f in ("vocab_size", "hidden_size",
            "num_key_value_heads", "tie_word_embeddings")} == {
        f: getattr(cfg, f) for f in ("vocab_size", "hidden_size",
                                     "num_key_value_heads",
                                     "tie_word_embeddings")}
    want, got = _flat(jparams), _flat(params)
    assert set(want) == set(got)
    for k, v in want.items():
        w = to_torch(v)
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert torch.equal(bits(got[k]), bits(w)), k


def test_tied_embeddings_leave_lm_head_absent(tmp_path):
    cfg = tl.LlamaConfig.tiny(tie_word_embeddings=True, num_hidden_layers=1)
    write_checkpoint(tmp_path, cfg, hf_tensors(cfg, tied=True))
    _, jparams = jhf.load_params(str(tmp_path), dtype=jnp.float32)
    got_cfg, params = thf.load_params(str(tmp_path), dtype=torch.float32,
                                      device="cpu")
    assert got_cfg.tie_word_embeddings
    assert "lm_head" not in params and "lm_head" not in jparams
    x = torch.ones(1, 1, cfg.hidden_size)
    assert torch.equal(tl.lm_head(params, x), x @ params["embed_tokens"].T)


def test_missing_tensor_raises(tmp_path):
    tensors = hf_tensors(CFG)
    del tensors["model.layers.1.mlp.up_proj.weight"]
    write_checkpoint(tmp_path, CFG, tensors)
    with pytest.raises(ValueError, match=r"up_proj for layers \[1\]"):
        thf.load_params(str(tmp_path), device="cpu")


@pytest.mark.parametrize("writer", ["port", "safetensors"])
def test_safetensors_files_cross_read(tmp_path, writer):
    """Every dtype, a 0-dim and an empty tensor survive a write by one
    side (the package's with metadata, which the port's reader skips) and
    a read by both."""
    st = pytest.importorskip("safetensors.torch")
    rng = np.random.default_rng(2)
    tensors = {name: torch.from_numpy(rng.standard_normal((3, 5)) * 100)
               .to(dt) for name, dt in safetensors_io.DTYPES.items()}
    tensors["scalar"] = torch.tensor(7, dtype=torch.int32)
    tensors["empty"] = torch.zeros((0, 4), dtype=torch.bfloat16)
    path = str(tmp_path / "x.safetensors")
    if writer == "port":
        safetensors_io.save_file(tensors, path)
    else:
        st.save_file(tensors, path, metadata={"format": "pt", "note": "x"})

    def port_read(p):
        return dict(safetensors_io.iter_tensors(p))

    for read in (port_read, st.load_file):
        got = read(path)
        assert set(got) == set(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert torch.equal(got[k], v), k


def test_cli_eval_ppl_with_model(tmp_path, capsys):
    """``eval-ppl --model DIR`` reads the checkpoint on both sides: the
    same perplexity to 1e-3 (f32)."""
    cfg = tl.LlamaConfig.tiny(num_hidden_layers=1)
    write_checkpoint(tmp_path, cfg, hf_tensors(cfg, seed=3))
    args = ["eval-ppl", "--model", str(tmp_path), "--seqlen", "64",
            "--max_eval_windows", "2"]
    jcli.main(args)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = cli.main(args + ["--device", "cpu"])
    assert np.isfinite(got["ppl"]) and got["ppl"] > 1
    assert abs(got["ppl"] - want["ppl"]) <= 1e-3 * want["ppl"]
