"""Prompt-lookup speculative decoding of the port (serving/spec.py, the
plain kernel versions on the CPU) against mxq_tpu's serving/spec.py: the
drafter, the acceptance count and the history shift register against
JAX's, and on the tiny packed model with the int8 KV cache, the tokens and
the acceptance statistics of run_spec and run_spec_pipelined equal to
JAX's, and the tokens equal to the port's plain greedy Engine. Also the
auto-disable on random prompts and the near-cache-end fallback."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxq_tpu.models import llama as jl
from mxq_tpu.serving import engine as jeng
from mxq_tpu.serving import spec as jspec
from mxq_tpu_torch.models import llama as tl
from mxq_tpu_torch.serving import engine as teng
from mxq_tpu_torch.serving import spec as tspec
from torch_port_helpers import port_params

TCFG = tl.LlamaConfig.tiny()
# a repetitive prompt (drafts can hit) and a random one, 8 new tokens each
PROMPTS = [np.array([4, 5, 6] * 5, np.int32),
           np.random.RandomState(3).randint(1, 512, 12).astype(np.int32)]
RUNS = {"sync": dict(fn="run_spec", kw=dict(draft_len=4)),
        "pipelined": dict(fn="run_spec_pipelined",
                          kw=dict(draft_len=4, rounds=2, auto_disable=False)),
        "auto_disable": dict(fn="run_spec_pipelined",
                             kw=dict(draft_len=4, rounds=2, min_accept=99.0,
                                     probe_every=4))}
STATS = ("rounds", "accepted", "dispatches", "plain_chunks")


def _engine(mod, params, cfg, **kw):
    ecfg = mod.EngineConfig(num_slots=2, max_len=64, prefill_buckets=(16,),
                            kv_quant=True)
    return mod.Engine(params, cfg, ecfg, **kw) if kw else mod.Engine(
        params, cfg, ecfg)


def _spec(mod, spec_mod, params, cfg, run, **kw):
    e = _engine(mod, params, cfg, **kw)
    reqs = [e.submit(p, max_new_tokens=8) for p in PROMPTS]
    getattr(spec_mod, RUNS[run]["fn"])(e, **RUNS[run]["kw"])
    st = {k: e._spec_stats.get(k, 0) for k in STATS}
    return [list(r.generated) for r in reqs], st, e.stats()


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX tiny packed model and its three spec runs — one fixture,
    because the JAX engine on the CPU takes tens of seconds."""
    cfg = jl.LlamaConfig.tiny()
    jp = jl.quantize_params_packed(jl.init_params(cfg, jax.random.PRNGKey(0)),
                                   cfg)
    return port_params(jp), {r: _spec(jeng, jspec, jp, cfg, r)
                             for r in RUNS}


@pytest.mark.parametrize("run", list(RUNS))
def test_spec_tokens_and_stats_equal_jax(jax_runs, run):
    tp, want = jax_runs
    toks, st, stats = _spec(teng, tspec, tp, TCFG, run, device="cpu")
    assert toks == want[run][0]
    assert st == want[run][1]
    keys = {k for k in want[run][2] if k.startswith("spec_")}
    assert keys == {k for k in stats if k.startswith("spec_")}
    for k in keys:
        if k in ("spec_verify_rounds", "spec_dispatches",
                 "spec_accept_len_mean", "spec_plain_chunks"):
            assert stats[k] == want[run][2][k], k
    if run == "auto_disable":
        assert stats["spec_plain_chunks"] > 0
    else:
        assert stats.get("spec_plain_chunks", 0) == 0


def test_spec_tokens_equal_plain_greedy(jax_runs):
    """Speculation changes how many tokens a verify yields, never their
    values: the port's plain Engine gives the same greedy tokens."""
    tp, want = jax_runs
    e = _engine(teng, tp, TCFG, device="cpu")
    reqs = [e.submit(p, max_new_tokens=8) for p in PROMPTS]
    e.run()
    plain = [list(r.generated) for r in reqs]
    for run in RUNS:
        assert want[run][0] == plain, run


def test_device_drafter_matches_host_drafter_and_jax():
    """_device_ngram_draft on random histories with many repeats equals
    ngram_draft on each slot's last H tokens, and JAX's drafter."""
    rng = np.random.default_rng(0)
    b, h, n, d = 16, 24, 3, 4
    hist = rng.integers(0, 4, (b, h)).astype(np.int32)
    hist_len = rng.integers(1, h + 1, b).astype(np.int32)
    hist_len[:2] = (h, 3)
    for i in range(b):
        hist[i, : h - hist_len[i]] = 0                # left padding
    last = hist[:, -1].copy()
    got = tspec._device_ngram_draft(torch.from_numpy(hist),
                                    torch.from_numpy(hist_len),
                                    torch.from_numpy(last), n, d)
    want = jspec._device_ngram_draft(jnp.asarray(hist), jnp.asarray(hist_len),
                                     jnp.asarray(last), n, d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i in range(b):
        real = hist[i, h - hist_len[i]:]
        np.testing.assert_array_equal(got[i].numpy(),
                                      tspec.ngram_draft(real, n, d))
        np.testing.assert_array_equal(tspec.ngram_draft(real, n, d),
                                      jspec.ngram_draft(real, n, d))
    assert list(tspec.ngram_draft(np.array([1, 2, 3, 9, 1, 2, 3]), 3, 3)) \
        == [9, 1, 2]
    assert list(tspec.ngram_draft(np.array([4, 5, 6]), 3, 2)) == [6, 6]


def test_accept_count_math():
    """Acceptance = 1 + the longest verified draft prefix
    (tests/test_serving.py:349)."""
    toks = torch.tensor([[10, 1, 2, 3], [10, 1, 9, 3], [10, 9, 9, 9],
                         [10, 1, 2, 3]])
    preds = torch.tensor([[1, 2, 3, 4]] * 4)
    act = torch.tensor([True, True, True, False])
    assert tspec._accept_count(toks, preds, act).tolist() == [4, 2, 1, 0]


def test_hist_append_matches_jax():
    rng = np.random.default_rng(1)
    hist = rng.integers(0, 50, (4, 8)).astype(np.int32)
    hist_len = np.array([8, 3, 0, 7], np.int32)
    preds = rng.integers(0, 50, (4, 5)).astype(np.int32)
    n_acc = np.array([5, 1, 0, 3], np.int32)
    h, hl = tspec._hist_append(*(torch.from_numpy(a) for a in
                                 (hist, hist_len, preds, n_acc)))
    hj, hlj = jspec._hist_append(*(jnp.asarray(a) for a in
                                   (hist, hist_len, preds, n_acc)))
    np.testing.assert_array_equal(h.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(hl.numpy(), np.asarray(hlj))


@pytest.fixture(scope="module")
def dense():
    return tl.init_params(TCFG, seed=0, device="cpu")


def _plain_tokens(params, prompts, n, **kw):
    e = teng.Engine(params, TCFG, teng.EngineConfig(**kw), device="cpu")
    reqs = [e.submit(p, max_new_tokens=n) for p in prompts]
    e.run()
    return [list(r.generated) for r in reqs]


def test_auto_disable_on_random_prompts(dense):
    """Random prompts: drafts miss, the acceptance EMA falls below the
    breakeven, and the loop runs plain chunks; tokens stay exact."""
    kw = dict(num_slots=2, max_len=64, prefill_buckets=(16,), kv_quant=True)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 512, 12).astype(np.int32) for _ in range(3)]
    e = teng.Engine(dense, TCFG, teng.EngineConfig(**kw), device="cpu")
    reqs = [e.submit(p, max_new_tokens=12) for p in prompts]
    tspec.run_spec_pipelined(e, draft_len=4, rounds=2, probe_every=2)
    assert [list(r.generated) for r in reqs] == _plain_tokens(
        dense, prompts, 12, **kw)
    st = e.stats()
    assert st["spec_verify_rounds"] >= 1           # it speculated first
    assert st["spec_plain_chunks"] > 0


def test_near_cache_end_falls_back(dense):
    """A prompt long enough that rounds * (draft + 1) would overrun max_len
    routes through the synchronous loop and stays exact
    (tests/test_serving.py:382)."""
    kw = dict(num_slots=2, max_len=32, prefill_buckets=(16,), kv_quant=False)
    prompt = np.array([3, 4] * 6, np.int32)
    e = teng.Engine(dense, TCFG, teng.EngineConfig(**kw), device="cpu")
    r = e.submit(prompt, max_new_tokens=12)
    tspec.run_spec_pipelined(e, draft_len=4, ngram=3, rounds=4)
    assert r.done
    assert list(r.generated) == _plain_tokens(dense, [prompt], 12, **kw)[0]


def test_spec_needs_greedy(dense):
    e = teng.Engine(dense, TCFG, teng.EngineConfig(
        num_slots=1, max_len=32, prefill_buckets=(16,), greedy=False),
        device="cpu")
    with pytest.raises(ValueError, match="greedy"):
        tspec.run_spec(e)
