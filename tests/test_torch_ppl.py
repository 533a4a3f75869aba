"""The perplexity path of the port against mxq_tpu's: ptq/data's streams
(bit-equal), eval/ppl's eval_ppl on the tiny preset from the same weights
with each fake-quant option and on packed weights per GEMV layout, and
cli eval-ppl.

Tolerances, relative to JAX's perplexity: 1e-3 for the dense model with
and without fake-quant (f32 throughout; the logits differ by summation
order only), 5e-3 for the packed model, whose products round their
activations to bf16 (the logit gap of test_torch_llama.py)."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from mxq_tpu import cli as jcli
from mxq_tpu.eval import ppl as jppl
from mxq_tpu.models import llama as jl
from mxq_tpu.ops import mxq_matmul as jmm
from mxq_tpu.ptq import data as jdata
from mxq_tpu_torch import cli
from mxq_tpu_torch.eval import ppl as tppl
from mxq_tpu_torch.models import llama as tl
from mxq_tpu_torch.ops import mxq_matmul as tmm
from mxq_tpu_torch.ptq import data as tdata
from torch_port_helpers import port_params

SEQLEN, WINDOWS = 64, 2


@pytest.mark.parametrize("dataset", tdata.DATASETS)
def test_streams_equal_jax(dataset):
    """Synthetic corpus, calibration windows and eval stream bit-equal to
    JAX's for the same seeds (no tokenizer: the synthetic fallback)."""
    assert np.array_equal(tdata.synthetic_corpus(512, 3000, seed=5),
                          jdata.synthetic_corpus(512, 3000, seed=5))
    for seed in (0, 3):
        a = tdata.get_calibration_batch(6, 32, vocab_size=512, seed=seed,
                                        dataset=dataset)
        b = jdata.get_calibration_batch(6, 32, vocab_size=512, seed=seed,
                                        dataset=dataset)
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    a = tdata.get_eval_tokens(vocab_size=1000, n_tokens=5000, dataset=dataset)
    b = jdata.get_eval_tokens(vocab_size=1000, n_tokens=5000, dataset=dataset)
    assert a.dtype == np.int32 and np.array_equal(a, b)
    assert tdata._dataset_salt(dataset) == jdata._dataset_salt(dataset)


def test_strict_and_unknown_dataset_raise():
    with pytest.raises(RuntimeError, match="unavailable"):
        tdata.get_eval_tokens(dataset="ptb", strict=True)
    with pytest.raises(RuntimeError, match="unavailable"):
        tdata.get_calibration_batch(2, 16, dataset="c4", strict=True)
    with pytest.raises(ValueError, match="unknown dataset"):
        tdata.get_eval_tokens(dataset="pile")
    # without a tokenizer the corpus loaders stop before `datasets`
    assert tdata._load_wikitext2(None, "test") is None
    assert tdata._load_ptb(None, "test") is None


@pytest.fixture(scope="module")
def model():
    return _model()


def _model():
    cfg = jl.LlamaConfig.tiny()
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    tokens = jdata.get_eval_tokens(vocab_size=cfg.vocab_size,
                                   n_tokens=4096, seqlen=SEQLEN)
    return cfg, params, port_params(params), tokens


OPTIONS = {"fp": {}, "w2": dict(w_bits=2), "w1": dict(w_bits=1),
           "a8_sym": dict(a_bits=8),
           "a4_asym": dict(a_bits=4, a_symmetric=False),
           "kv8": dict(kv_bits=8)}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_eval_ppl_matches_jax(model, option):
    """JAX runs eagerly here: its jitted window fuses the fake-quant
    arithmetic and moves a4_asym's perplexity by 1.07e-3 of itself
    against its own eager run (ROADMAP queue 3); the port follows eager,
    as packfmt does."""
    jcfg, jp, tp, tokens = model
    jcfg = dataclasses.replace(jcfg, **OPTIONS[option])
    tcfg = tl.LlamaConfig.tiny(**OPTIONS[option])
    with jax.disable_jit():
        want = jppl.eval_ppl(jp, jcfg, tokens, seqlen=SEQLEN,
                             max_windows=WINDOWS)
    got = tppl.eval_ppl(tp, tcfg, tokens, seqlen=SEQLEN,
                        max_windows=WINDOWS, device="cpu")
    assert np.isfinite(got) and abs(got - want) <= 1e-3 * want


@pytest.fixture(scope="module")
def packed(model):
    jcfg, jp, _, tokens = model
    jpk = jl.quantize_params_packed(jp, jcfg)
    return jpk, port_params(jpk)


@pytest.mark.parametrize("layout", ["slab", "quad", "bfexp"])
def test_packed_eval_ppl_per_layout_matches_jax(model, packed, layout,
                                                monkeypatch):
    """seqlen 128, batch 1: every matmul has 128 rows, under the 512-token
    prefill switch, so the GEMV of the selected layout runs on both sides
    (JAX's interpret-mode body, the port's plain version of K1 or K6).
    JAX's jitted window reads GEMV_LAYOUT while it traces, so its caches
    are cleared around each layout."""
    jcfg, _, _, tokens = model
    jpk, tpk = packed
    tcfg = tl.LlamaConfig.tiny()
    monkeypatch.setattr(jmm, "GEMV_LAYOUT", layout)
    monkeypatch.setattr(tmm, "GEMV_LAYOUT", layout)
    jax.clear_caches()
    try:
        want = jppl.eval_ppl(jpk, jcfg, tokens, seqlen=128, batch=1,
                             max_windows=WINDOWS)
    finally:
        jax.clear_caches()
    got = tppl.eval_ppl(tpk, tcfg, tokens, seqlen=128, batch=1,
                        max_windows=WINDOWS, device="cpu")
    assert np.isfinite(got) and abs(got - want) <= 5e-3 * want


def test_eval_ppl_batches_and_window_count(model):
    """Two windows per forward give the same perplexity as one; too few
    tokens for a window raise."""
    _, _, tp, tokens = model
    cfg = tl.LlamaConfig.tiny()
    one = tppl.eval_ppl(tp, cfg, tokens, seqlen=SEQLEN, max_windows=4,
                        device="cpu")
    two = tppl.eval_ppl(tp, cfg, tokens, seqlen=SEQLEN, batch=2,
                        max_windows=4, device="cpu")
    assert abs(one - two) <= 1e-5 * one
    with pytest.raises(ValueError, match="window"):
        tppl.eval_ppl(tp, cfg, tokens[:SEQLEN - 1], seqlen=SEQLEN,
                      device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tppl.eval_ppl(tp, cfg, tokens, seqlen=SEQLEN)


def test_cli_eval_ppl_prints_jax_keys(capsys):
    args = ["eval-ppl", "--preset", "tiny", "--seqlen", str(SEQLEN),
            "--max_eval_windows", "1", "--dataset", "ptb"]
    jcli.main(args)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = cli.main(args + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == out and set(got) == set(want) == {"dataset", "ppl"}
    assert got["dataset"] == want["dataset"] == "ptb"
    assert np.isfinite(got["ppl"]) and got["ppl"] > 1
    for flags in (["--w_bits", "2"], ["--w_bits", "1"], ["--a_bits", "8"],
                  ["--kv_bits", "8"]):
        q = cli.main(args + ["--device", "cpu", "--layers", "1"] + flags)
        assert np.isfinite(q["ppl"]) and q["ppl"] > 1, flags
    # --model reads an HF checkpoint directory (test_torch_hf_loader.py)
    with pytest.raises(FileNotFoundError, match="config.json"):
        cli.main(args + ["--device", "cpu", "--model", "/nonexistent"])


if __name__ == "__main__":
    # the JAX behaviours quoted in ROADMAP.md (queue 3): its jitted window
    # against its eager run with a4-asym fake-quant, and its jit cache
    # keeping the first GEMV layout's trace
    jcfg, jp, tp, tokens = _model()
    opt = OPTIONS["a4_asym"]
    cfg = dataclasses.replace(jcfg, **opt)
    jit = jppl.eval_ppl(jp, cfg, tokens, seqlen=SEQLEN, max_windows=WINDOWS)
    with jax.disable_jit():
        eager = jppl.eval_ppl(jp, cfg, tokens, seqlen=SEQLEN,
                              max_windows=WINDOWS)
    port = tppl.eval_ppl(tp, tl.LlamaConfig.tiny(**opt), tokens,
                         seqlen=SEQLEN, max_windows=WINDOWS, device="cpu")
    print("a4_asym ppl: JAX jit", jit, "JAX eager", eager, "port", port)
    jpk = jl.quantize_params_packed(jp, jcfg)
    got = {}
    for layout in ("slab", "bfexp"):
        jmm.GEMV_LAYOUT = layout
        got[layout] = jppl.eval_ppl(jpk, jcfg, tokens, seqlen=128, batch=1,
                                    max_windows=1)
    jax.clear_caches()
    got["bfexp after clear_caches"] = jppl.eval_ppl(
        jpk, jcfg, tokens, seqlen=128, batch=1, max_windows=1)
    print("packed ppl per layout, one jitted window:", got)
