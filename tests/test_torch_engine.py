"""The port's slot Engine (device="cpu", the plain kernel versions) against
mxq_tpu's Engine: greedy tokens equal token for token on the tiny preset,
packed, with the int8 KV cache, at num_slots 2 and 1, under continuous
batching and with the packed uniform-4b lm_head; the int8-activation
prefill's first token against JAX's forward; and the engine's own
invariants (near-capacity clamp, chunked prefill, cancel, stats, sampling
filters, the default device, the cli's serve options)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxq_tpu.models import llama as jl
from mxq_tpu.serving import engine as jeng
from mxq_tpu_torch.models import llama as tl
from mxq_tpu_torch.serving import engine as teng
from mxq_tpu_torch.ops import uniform4 as tu4
from torch_port_helpers import port_params, rel

TCFG = tl.LlamaConfig.tiny()
PROMPTS = [np.arange(5, dtype=np.int32) + 7, np.arange(9, dtype=np.int32) + 40]
# continuous batching: 5 requests through 2 slots, 3+i new tokens each
BATCH = [(np.arange(3 + i, dtype=np.int32) * 5 + i, 3 + i) for i in range(5)]
A8_PROMPT = np.random.RandomState(8).randint(0, 512, 600).astype(np.int32)


def _run(engine_mod, params, cfg, slots, reqs, lm_head_bits=16, **kw):
    ecfg = engine_mod.EngineConfig(num_slots=slots, max_len=64,
                                   prefill_buckets=(16,), kv_quant=True,
                                   lm_head_bits=lm_head_bits)
    e = (engine_mod.Engine(params, cfg, ecfg, **kw) if kw
         else engine_mod.Engine(params, cfg, ecfg))
    rs = [e.submit(p, max_new_tokens=n) for p, n in reqs]
    done = e.run()
    assert len(done) == len(reqs)
    return [list(r.generated) for r in rs]


@pytest.fixture(scope="module")
def packed_models():
    """The JAX tiny packed model and its runs — one fixture, because the
    JAX engine on the CPU takes tens of seconds."""
    cfg = jl.LlamaConfig.tiny()
    jp = jl.quantize_params_packed(jl.init_params(cfg, jax.random.PRNGKey(0)),
                                   cfg)
    two = [(p, 6) for p in PROMPTS]
    want = {slots: _run(jeng, jp, cfg, slots, two) for slots in (2, 1)}
    want["batch"] = _run(jeng, jp, cfg, 2, BATCH)
    want["u4_head"] = _run(jeng, jp, cfg, 2, two, lm_head_bits=4)
    # the int8-activation prefill of a 600-token prompt: JAX's logits
    want["a8_logits"] = np.asarray(jl.forward(
        jp, jnp.asarray(A8_PROMPT[None]),
        dataclasses.replace(cfg, prefill_act_bits=8))[0][0, -1])
    return port_params(jp), want


@pytest.mark.parametrize("slots", [2, 1])
def test_greedy_tokens_equal_jax(packed_models, slots):
    tp, want = packed_models
    got = _run(teng, tp, TCFG, slots, [(p, 6) for p in PROMPTS],
               device="cpu")
    assert got == want[slots]


def test_continuous_batching_equals_jax(packed_models):
    tp, want = packed_models
    got = _run(teng, tp, TCFG, 2, BATCH, device="cpu")
    assert got == want["batch"]
    assert [len(g) for g in got] == [n for _, n in BATCH]


def test_u4_lm_head_tokens_equal_jax(packed_models):
    """EngineConfig.lm_head_bits=4 packs the head with the port's packer
    (bit-exact with JAX's) and runs it through u4_matmul (K7's plain
    version): the greedy tokens equal JAX's Engine with the same option
    (port of tests/test_serving.py TestPackedLMHead)."""
    tp, want = packed_models
    got = _run(teng, tp, TCFG, 2, [(p, 6) for p in PROMPTS], lm_head_bits=4,
               device="cpu")
    assert got == want["u4_head"]


def test_prefill_a8_first_token_matches_jax_forward(packed_models):
    """prefill_a8 on a 600-token prompt (the 1024 bucket, past the 512-row
    switch): the engine's prefill goes through the int8 path, and its
    first token is the argmax of JAX's forward logits with
    prefill_act_bits=8 at the last prompt row; those logits agree to
    5e-2 of max|logit| (test_torch_llama.py explains the int8 gap)."""
    tp, want = packed_models
    e = teng.Engine(tp, TCFG, teng.EngineConfig(
        num_slots=1, max_len=1024, prefill_buckets=(1024,), kv_quant=True,
        prefill_a8=True), device="cpu")
    assert e.cfg.prefill_act_bits == 8
    req = e.submit(A8_PROMPT, max_new_tokens=1)
    e.run()
    assert req.generated == [int(want["a8_logits"].argmax())]
    lt, _ = tl.forward(tp, A8_PROMPT[None], e.cfg, device="cpu")
    assert rel(lt[0, -1], want["a8_logits"]) <= 5e-2


# ---------------------------------------------------------------------------
# the port's own engine invariants (reference: a no-cache greedy recompute)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense():
    return tl.init_params(TCFG, seed=0, device="cpu")


def greedy_reference(params, prompt, n_new):
    ids = list(prompt)
    for _ in range(n_new):
        logits, _ = tl.forward(params, np.asarray([ids], np.int32), TCFG,
                               device="cpu")
        ids.append(int(logits[0, -1].argmax()))
    return ids[len(prompt):]


def _engine(params, **kw):
    base = dict(num_slots=2, max_len=64, prefill_buckets=(16,),
                kv_quant=False)
    base.update(kw)
    return teng.Engine(params, TCFG, teng.EngineConfig(**base), device="cpu")


def test_bf16_cache_engine_tracks_greedy_reference(dense):
    """The bf16-cache branch of the decode forward: five requests through
    two slots; the first tokens equal the no-cache recompute."""
    e = _engine(dense)
    reqs = [e.submit(np.arange(3, dtype=np.int32) + i, max_new_tokens=3 + i)
            for i in range(5)]
    assert len(e.run()) == 5
    for i, r in enumerate(reqs):
        assert r.done and len(r.generated) == 3 + i
        ref = greedy_reference(dense, np.arange(3, dtype=np.int32) + i, 3)
        assert r.generated[:3] == ref


@pytest.mark.parametrize("kv_quant", [False, True])
def test_admit_at_max_len_minus_one_horizon8(dense, kv_quant):
    """A slot admitted at plen = max_len-1 gets horizon 8 steps with a
    fixed active mask: write rows clamp to max_len-1 (K4 requires
    S > max(positions)), overflow tokens are dropped, the neighbour is
    unaffected."""
    rng = np.random.RandomState(7)
    max_len = 16
    full = rng.randint(1, TCFG.vocab_size, size=max_len - 1).astype(np.int32)
    short = rng.randint(1, TCFG.vocab_size, size=4).astype(np.int32)
    e = _engine(dense, max_len=max_len, prefill_buckets=(max_len,),
                kv_quant=kv_quant, horizon=8)
    rf = e.submit(full, max_new_tokens=8)
    rs = e.submit(short, max_new_tokens=5)
    assert len(e.run()) == 2
    assert len(rf.generated) == 1
    ref_short = greedy_reference(dense, short, 5)
    if kv_quant:
        assert rs.generated[0] == ref_short[0]
    else:
        assert rf.generated == greedy_reference(dense, full, 1)
        assert rs.generated == ref_short


@pytest.mark.parametrize("kv_quant", [False, True])
def test_overflow_steps_clamp_and_zero(dense, kv_quant):
    """From position max_len-2 with horizon 8, steps i >= 2 are out of
    range: their tokens are 0 and no cache row below max_len-1 differs from
    a horizon-2 run."""
    max_len, b = 16, 2
    e = _engine(dense, max_len=max_len, prefill_buckets=(max_len,),
                kv_quant=kv_quant, horizon=8)
    caches0 = {k: v.clone() for k, v in e.caches.items()}
    args = (torch.zeros(b, dtype=torch.int32),
            torch.tensor([3, 5], dtype=torch.int32), torch.zeros(b, dtype=bool),
            torch.tensor([max_len - 2, 2], dtype=torch.int32),
            torch.ones(b, dtype=bool))
    toks8 = e._decode_chunk(*args, horizon=8)
    c8 = {k: v.clone() for k, v in e.caches.items()}
    e.caches = {k: v.clone() for k, v in caches0.items()}
    toks2 = e._decode_chunk(*args, horizon=2)
    assert (toks8[2:, 0] == 0).all()
    assert torch.equal(toks8[:2], toks2)
    seq_axis = 3 if kv_quant else 2
    for name in c8:
        keep = [slice(None)] * c8[name].dim()
        keep[1] = slice(0, 1)
        keep[seq_axis] = slice(0, max_len - 1)
        assert torch.equal(c8[name][tuple(keep)],
                           e.caches[name][tuple(keep)]), name


def test_chunked_prefill_matches_single_bucket(dense):
    """Prompts longer than the largest bucket prefill in chunks, and a
    final window that would overrun the cache shifts left."""
    rng = np.random.RandomState(4)
    prompt = rng.randint(1, TCFG.vocab_size, size=40).astype(np.int32)
    ref = greedy_reference(dense, prompt, 4)
    for buckets, max_len in (((16,), 128), ((64,), 128), ((32,), 48)):
        e = _engine(dense, max_len=max_len, prefill_buckets=buckets)
        req = e.submit(prompt, max_new_tokens=4)
        e.run()
        assert req.generated == ref, buckets


def test_overlong_prompt_keeps_tail(dense):
    rng = np.random.RandomState(3)
    prompt = rng.randint(1, TCFG.vocab_size, size=40).astype(np.int32)
    e = _engine(dense, max_len=32)
    req = e.submit(prompt, max_new_tokens=4)
    e.run()
    assert req.done and req.generated == greedy_reference(dense,
                                                          prompt[-31:], 1)


def test_cancel_and_stats(dense):
    e = _engine(dense, num_slots=1, horizon=2)
    prompt = np.arange(1, 6, dtype=np.int32)
    r0 = e.submit(prompt, max_new_tokens=30)
    r1 = e.submit(prompt + 1, max_new_tokens=4)
    r2 = e.submit(prompt + 2, max_new_tokens=4)
    e.step()                      # r0 running
    assert e.cancel(r1)           # queued
    assert e.cancel(r0)           # running: frees the slot
    done = e.run()
    assert r2 in done and r2.generated == greedy_reference(dense,
                                                           prompt + 2, 4)
    assert r0.done and r1.done and r1.generated == []
    assert not e.cancel(r2)
    st = e.stats()
    assert set(st) == {"requests_submitted", "requests_finished",
                       "tokens_generated", "ttft_p50_s", "ttft_p95_s",
                       "e2e_p50_s", "e2e_p95_s", "tokens_per_sec"}
    assert st["requests_submitted"] == 3
    assert st["tokens_generated"] == sum(len(r.generated)
                                         for r in (r0, r1, r2))


def test_stream_yields_the_tokens_of_run(dense):
    prompts = [np.arange(4, dtype=np.int32) + i for i in range(3)]
    e = _engine(dense, horizon=3)
    reqs = [e.submit(p, max_new_tokens=4) for p in prompts]
    seen = {r.uid: [] for r in reqs}
    for r, tok in e.stream():
        seen[r.uid].append(tok)
    assert all(seen[r.uid] == r.generated for r in reqs)
    assert all(r.done for r in reqs)


def test_filter_logits_keeps_jax_support():
    """Top-k / top-p filtering keeps exactly the tokens JAX's
    sample_token can draw: every JAX draw lies in the kept set, and the
    kept sets are those of the JAX formula on these inputs."""
    logits = np.random.default_rng(0).standard_normal((4, 64)).astype(
        np.float32) * 3
    for top_k, top_p in ((5, 1.0), (0, 0.6), (8, 0.5)):
        lg = teng.filter_logits(torch.from_numpy(logits), 0.7, top_k, top_p)
        kept = (lg > teng.NEG).numpy()
        if top_k:
            assert (kept.sum(-1) <= top_k).all()
        keys = jax.random.split(jax.random.PRNGKey(1), 200)
        draws = np.stack([np.asarray(jeng.sample_token(
            jnp.asarray(logits), k, False, 0.7, top_k, top_p)) for k in keys])
        for row in range(4):
            assert kept[row, draws[:, row]].all(), (top_k, top_p, row)
            # the most likely kept tokens are drawn at least once
            assert kept[row, np.bincount(draws[:, row], minlength=64)
                        .argmax()]


def test_sampling_modes(dense):
    prompt = np.arange(1, 9, dtype=np.int32)
    ref = greedy_reference(dense, prompt, 5)
    for kw in (dict(temperature=0.9, top_k=1), dict(temperature=1.0,
                                                    top_p=1e-9)):
        e = _engine(dense, greedy=False, **kw)
        req = e.submit(prompt, max_new_tokens=5)
        e.run()
        assert req.generated == ref, kw
    outs = []
    for seed in (7, 7, 8):
        e = _engine(dense, greedy=False, temperature=1.0, top_k=50, seed=seed)
        req = e.submit(prompt, max_new_tokens=8)
        e.run()
        outs.append(req.generated)
    assert outs[0] == outs[1] and len(outs[2]) == 8


def test_unported_options_raise(dense):
    """The engine's serve options are all ported now: prefill_a8 sets the
    int8-activation prefill on the model config, lm_head_bits=4 packs the
    head to uniform 4 bits; neither raises, and the tokens stay close to
    the dense engine's."""
    e = _engine(dense, prefill_a8=True)
    assert e.cfg.prefill_act_bits == 8 and dense is e.params
    e = _engine(dense, lm_head_bits=4)
    head = e.params["lm_head"]
    assert isinstance(head, tu4.PackedU4Linear)
    assert (head.in_features, head.out_features) == (TCFG.hidden_size,
                                                     TCFG.vocab_size)
    assert isinstance(dense["lm_head"], torch.Tensor)   # not modified
    req = e.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=3)
    e.run()
    assert len(req.generated) == 3


def test_engine_without_device_raises_on_a_host_without_cuda(dense):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.Engine(dense, TCFG)


def test_cli_serve_on_cpu():
    from mxq_tpu_torch import cli
    base = ["serve", "--device", "cpu", "--preset", "tiny", "--packed",
            "--slots", "2", "--max_len", "64", "--requests", "3",
            "--max_new_tokens", "3"]
    out = cli.main(base)
    assert out["requests"] == 3 and out["tokens"] == 9
    assert out["stats"]["requests_finished"] == 3
    for flags in (["--spec_decode"], ["--spec_decode", "--spec_sync",
                                      "--draft_len", "3"],
                  ["--prefill_a8", "--lm_head_bits", "4"]):
        got = cli.main(base + flags)
        assert got["requests"] == 3 and got["tokens"] == 9, flags
        if "--spec_decode" in flags:
            assert got["stats"]["spec_dispatches"] >= 1
    # the fake-quant forward of the dense model (mxq_tpu's cmd_serve)
    dense = [f for f in base if f != "--packed"]
    got = cli.main(dense + ["--w_bits", "4"])
    assert got["requests"] == 3 and got["tokens"] == 9


def test_cli_serve_spec_and_a8_tokens_equal_plain(monkeypatch):
    """On the CPU, cli serve --spec_decode (pipelined and --spec_sync) gives
    the greedy tokens of the plain serve; --prefill_a8 --lm_head_bits 4
    runs a 600-token prompt through the int8 prefill and the packed
    head."""
    from mxq_tpu_torch import cli
    from mxq_tpu_torch.serving import spec
    seen = {}

    def recording(name, real):
        def run(*a, **kw):
            done = real(*a, **kw)
            seen[name] = [g for _, g in sorted(
                (r.uid, list(r.generated)) for r in done)]
            return done
        return run
    monkeypatch.setattr(teng.Engine, "run",
                        recording("plain", teng.Engine.run))
    for fn in ("run_spec_pipelined", "run_spec"):
        monkeypatch.setattr(spec, fn, recording(fn, getattr(spec, fn)))
    base = ["serve", "--device", "cpu", "--preset", "tiny", "--packed",
            "--slots", "2", "--max_len", "64", "--requests", "3",
            "--max_new_tokens", "6", "--prompt_len", "12"]
    cli.main(base)
    cli.main(base + ["--spec_decode"])
    cli.main(base + ["--spec_decode", "--spec_sync"])
    assert seen["run_spec_pipelined"] == seen["plain"]
    assert seen["run_spec"] == seen["plain"]
    out = cli.main(["serve", "--device", "cpu", "--preset", "tiny",
                    "--packed", "--slots", "1", "--max_len", "1024",
                    "--requests", "1", "--prompt_len", "600",
                    "--max_new_tokens", "2", "--prefill_a8",
                    "--lm_head_bits", "4"])
    assert out["tokens"] == 2
