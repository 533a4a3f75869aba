"""The port's task-eval scoring core (mxq_tpu_torch/eval/harness.py) against
mxq_tpu's on the tiny preset, from the same weights (tests/test_harness.py's
toy tokenizer and synthetic task): MXQLM.loglikelihood on the dense, the
fake-quant and the packed model, loglikelihood_rolling, greedy_generate and
generate_batch, the bos protocol, right padding, the length-bucketed
batching, a synthetic task's acc/acc_norm, CachingLM and cli eval-tasks.

Tolerances on a score s (nats): 1e-4 * max(1, |s|) for the dense model
with and without fake-quant (f32 throughout: the logits differ by summation
order only; measured at most 1.6e-7); 1e-2 * max(1, |s|) for the packed
model, whose products round their activations to bf16 (measured at most
4.4e-4). JAX's fake-quant run is eager (``jax.disable_jit()``): jitted,
XLA moves the fake-quant's rounding points (ROADMAP queue 3, perplexity
516.730 jitted against 516.179 eager), and the port follows eager."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from mxq_tpu import cli as jcli
from mxq_tpu.eval import harness as jh
from mxq_tpu.models import llama as jl
from mxq_tpu_torch import cli
from mxq_tpu_torch.eval import harness as th
from mxq_tpu_torch.models import llama as tl
from torch_port_helpers import port_params

JCFG = jl.LlamaConfig.tiny()
TCFG = tl.LlamaConfig.tiny()


def toy_tokenize(text: str) -> np.ndarray:
    return np.asarray([(ord(c) % JCFG.vocab_size) for c in text][:64],
                      dtype=np.int32)


def synth_docs(mcdoc):
    rng = np.random.RandomState(0)
    return [mcdoc(context=f"context number {i}:",
                  choices=["alpha", "beta", "gamma"],
                  gold=int(rng.randint(3))) for i in range(8)]


class JSynth(jh.MultipleChoiceTask):
    name = "synth"

    def docs(self):
        return synth_docs(jh.MCDoc)


class TSynth(th.MultipleChoiceTask):
    name = "synth"

    def docs(self):
        return synth_docs(th.MCDoc)


def requests(seed=0, n=10):
    """Mixed-length requests from ``seed``: contexts of 0-40 tokens (one
    empty), continuations of 1-6."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        ctx = rng.randint(3, JCFG.vocab_size,
                          size=0 if i == 3 else rng.randint(1, 41))
        cont = rng.randint(3, JCFG.vocab_size, size=rng.randint(1, 7))
        out.append((ctx.astype(np.int32), cont.astype(np.int32)))
    return out


@pytest.fixture(scope="module")
def dense():
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, port_params(jp)


@pytest.fixture(scope="module")
def packed(dense):
    jpk = jl.quantize_params_packed(dense[0], JCFG)
    return jpk, port_params(jpk)


def _close(got, want, tol):
    for (s, e), (ws, we) in zip(got, want):
        assert abs(s - ws) <= tol * max(1.0, abs(ws)), (s, ws)


@pytest.mark.parametrize("bos_id", [None, 1])
def test_loglikelihood_dense_matches_jax(dense, bos_id):
    """Scores within 1e-4 * max(1, |s|) and exact-match flags equal, with
    and without the bos prefix, over batches padded to 16 to 64 tokens."""
    jp, tp = dense
    reqs = requests()
    want = jh.MXQLM(jp, JCFG, batch_size=4, bos_id=bos_id).loglikelihood(reqs)
    got = th.MXQLM(tp, TCFG, batch_size=4, bos_id=bos_id,
                   device="cpu").loglikelihood(reqs)
    _close(got, want, 1e-4)
    assert [e for _, e in got] == [e for _, e in want]
    assert all(isinstance(s, float) and isinstance(e, bool) for s, e in got)


def test_loglikelihood_fake_quant_matches_jax(dense):
    """w_bits=2 (the MXQ fake-quant of every dense weight); JAX eager."""
    jp, tp = dense
    reqs = requests(seed=1, n=4)
    jcfg = dataclasses.replace(JCFG, w_bits=2)
    with jax.disable_jit():
        want = jh.MXQLM(jp, jcfg, batch_size=4).loglikelihood(reqs)
    got = th.MXQLM(tp, tl.LlamaConfig.tiny(w_bits=2), batch_size=4,
                   device="cpu").loglikelihood(reqs)
    _close(got, want, 1e-4)
    assert [e for _, e in got] == [e for _, e in want]


def test_packed_scores_and_picks_match_jax(packed):
    """The packed model (the plain versions of K1 under 512 rows and of K3
    from 512 on, against JAX's interpret-mode kernels): scores within
    1e-2 * max(1, |s|) (measured 4.4e-4), and the synthetic task's picks
    equal. 8 rows padded to 64 tokens make 512 rows (K3's side)."""
    jpk, tpk = packed
    reqs = requests(seed=2, n=8)
    reqs[0] = (np.arange(3, 60, dtype=np.int32), reqs[0][1])
    jlm = jh.MXQLM(jpk, JCFG, batch_size=8)
    tlm = th.MXQLM(tpk, TCFG, batch_size=8, device="cpu")
    _close(tlm.loglikelihood(reqs), jlm.loglikelihood(reqs), 1e-2)
    jres = JSynth().evaluate(jlm, toy_tokenize)
    tres = TSynth().evaluate(tlm, toy_tokenize)
    assert tres == jres


def test_synthetic_task_acc_matches_jax(dense):
    """acc, acc_norm and their stderrs of the dense model equal JAX's."""
    jp, tp = dense
    jres = JSynth().evaluate(jh.MXQLM(jp, JCFG, batch_size=4), toy_tokenize)
    tres = TSynth().evaluate(th.MXQLM(tp, TCFG, batch_size=4, device="cpu"),
                             toy_tokenize)
    assert tres == jres
    assert tres["n"] == 8 and set(tres) >= {"acc", "acc_norm",
                                            "acc_stderr", "acc_norm_stderr"}


def test_loglikelihood_rolling_matches_jax_and_its_windows(dense):
    """A 40-token stream at max_len 16 (three windows): the total against
    JAX's, and against the sum of its disjoint windows scored alone."""
    jp, tp = dense
    toks = np.random.RandomState(4).randint(3, 512, size=40).astype(np.int32)
    (want,) = jh.MXQLM(jp, JCFG, batch_size=4,
                       max_len=16).loglikelihood_rolling([toks])
    lm = th.MXQLM(tp, TCFG, batch_size=4, max_len=16, device="cpu")
    (got,) = lm.loglikelihood_rolling([torch.from_numpy(toks)])
    assert abs(got - want) <= 1e-4 * abs(want)
    windows = [th.make_disjoint_window(w) for w in
               th.get_rolling_token_windows(toks.tolist(), 2, 15, 1)]
    assert len(windows) == 3
    assert [t for _, p in windows for t in p] == toks.tolist()
    parts = [lm.loglikelihood([(np.asarray(c, np.int32),
                                np.asarray(p, np.int32))])[0][0]
             for c, p in windows]
    assert abs(got - sum(parts)) <= 1e-5 * abs(got)


def test_rolling_windows_reference_semantics():
    """The vendored harness's docstring example (base.py:58-72), as
    tests/test_harness.py holds JAX's copy."""
    ws = [th.make_disjoint_window(w)
          for w in th.get_rolling_token_windows(list(range(10)), -1, 4, 1)]
    assert ws == [([-1], [0, 1, 2, 3]), ([3], [4, 5, 6, 7]),
                  ([5, 6, 7], [8, 9])]
    for n in (1, 2, 3, 5, 8, 100):
        assert th._round_pow2(n) == jh._round_pow2(n)


def test_greedy_and_generate_batch_match_jax():
    """greedy_generate's tokens equal JAX's (with and without a stop
    sequence, and with bos), and generate_batch (the port's Engine, bf16
    cache) equals greedy_generate, as tests/test_harness.py holds JAX."""
    jp = jl.init_params(JCFG, jax.random.PRNGKey(3))
    tp = port_params(jp)
    ctxs = [np.array([1, 5, 9, 13], np.int32), np.array([1, 7, 3], np.int32),
            np.array([1, 2, 4, 6, 8], np.int32)]
    jlm = jh.MXQLM(jp, JCFG, batch_size=4, max_len=64)
    tlm = th.MXQLM(tp, TCFG, batch_size=4, max_len=64, device="cpu")
    greedy = [tlm.greedy_generate(c, 6) for c in ctxs]
    for c, g in zip(ctxs[::2], greedy[::2]):
        np.testing.assert_array_equal(g, jlm.greedy_generate(c, 6))
    stop = greedy[0][1:3].tolist()
    cut = next(n for n in range(2, 7) if greedy[0][n - 2:n].tolist() == stop)
    got = tlm.greedy_generate(ctxs[0], 6, stop_sequences=[stop])
    np.testing.assert_array_equal(got, greedy[0][:cut])
    np.testing.assert_array_equal(
        got, jlm.greedy_generate(ctxs[0], 6, stop_sequences=[stop]))
    for c, g in zip(ctxs, tlm.generate_batch(ctxs, max_new_tokens=6)):
        np.testing.assert_array_equal(np.asarray(g)[:6],
                                      tlm.greedy_generate(c, 6))
    bos = th.MXQLM(tp, TCFG, batch_size=2, max_len=64, bos_id=1,
                   device="cpu")
    jbos = jh.MXQLM(jp, JCFG, batch_size=2, max_len=64, bos_id=1)
    np.testing.assert_array_equal(bos.greedy_generate(ctxs[1], 5),
                                  jbos.greedy_generate(ctxs[1], 5))
    for c, g in zip(ctxs[:2], bos.generate_batch(ctxs[:2], 5)):
        np.testing.assert_array_equal(g, bos.greedy_generate(c, 5))


def test_bos_id_protocol(dense):
    """With bos_id the context gets the prefix (an empty context becomes
    [bos], so every continuation token is scored), scores equal a manual
    forward over [bos] + ctx + cont, as JAX's test holds its own."""
    jp, tp = dense
    lm = th.MXQLM(tp, TCFG, batch_size=2, max_len=64, bos_id=1,
                  device="cpu")
    ctx, cont = np.array([5, 9], np.int64), np.array([11, 3], np.int64)
    (s, _), (s_empty, _) = lm.loglikelihood(
        [(ctx, cont), (np.zeros(0, np.int64), cont)])

    def manual(seq, n_cont):
        logits, _ = tl.forward(tp, torch.tensor([seq]), TCFG, device="cpu")
        logp = torch.log_softmax(logits[0, :-1].float(), -1)
        lls = logp.gather(-1, torch.tensor(seq[1:])[:, None])[:, 0]
        return float(lls[-n_cont:].sum())

    assert abs(s - manual([1, 5, 9, 11, 3], 2)) < 1e-4
    assert abs(s_empty - manual([1, 11, 3], 2)) < 1e-4
    want = jh.MXQLM(jp, JCFG, batch_size=2, max_len=64, bos_id=1)
    _close([(s, False), (s_empty, False)],
           want.loglikelihood([(ctx, cont), (np.zeros(0, np.int64), cont)]),
           1e-4)


def test_right_padding_invariance(dense):
    """A short request scored alone (padded to 16) and beside a long one
    (padded to 64): the same score."""
    _, tp = dense
    lm = th.MXQLM(tp, TCFG, batch_size=4, device="cpu")
    ctx, cont = toy_tokenize("hello world"), toy_tokenize(" xy")
    long_ctx = toy_tokenize("a much longer context string here padding out")
    (alone, _), = lm.loglikelihood([(ctx, cont)])
    (batched, _), _ = lm.loglikelihood([(ctx, cont), (long_ctx, cont)])
    assert abs(alone - batched) <= 1e-5 * abs(alone)


def test_length_bucketed_batching_equals_jax(dense):
    """The same batches as JAX's, ids and masks: batch_size rows each (zero
    rows in a short last batch), padded to the power of two over its
    longest request, in length order."""
    jp, tp = dense
    reqs = requests(seed=5, n=7)
    shapes = {}
    for name, lm in (("jax", jh.MXQLM(jp, JCFG, batch_size=3)),
                     ("torch", th.MXQLM(tp, TCFG, batch_size=3,
                                        device="cpu"))):
        seen, orig = [], lm._score

        def spy(ids, mask, orig=orig, seen=seen):
            seen.append((tuple(ids.shape), np.asarray(ids).tolist(),
                         np.asarray(mask).tolist()))
            return orig(ids, mask)

        lm._score = spy
        lm.loglikelihood(reqs)
        shapes[name] = seen
    assert shapes["torch"] == shapes["jax"]
    assert [s for s, _, _ in shapes["torch"]] == [(3, 8), (3, 32), (3, 64)]


def test_mxqlm_runs_on_the_card_unless_told():
    """The default device is the card: on a host without one MXQLM raises,
    and params on another device than the one named are refused."""
    tp = tl.init_params(TCFG, 0, torch.float32, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            th.MXQLM(tp, TCFG)
    with pytest.raises(ValueError, match="parameters live on"):
        th.MXQLM(tp, TCFG, device="meta")


class TestCachingLM:
    def test_hits_skip_scoring(self, dense, tmp_path):
        """A second run scores only the new request; cached results equal
        the scorer's."""
        _, tp = dense
        lm = th.MXQLM(tp, TCFG, batch_size=2, max_len=64, device="cpu")
        calls = {"n": 0}
        orig = lm.loglikelihood

        def counting(reqs):
            calls["n"] += len(reqs)
            return orig(reqs)

        lm.loglikelihood = counting
        clm = th.CachingLM(lm, str(tmp_path / "req.db"))
        reqs = [(np.arange(4, dtype=np.int32) + i,
                 np.arange(3, dtype=np.int32) + 1) for i in range(3)]
        first = clm.loglikelihood(reqs)
        assert calls["n"] == 3
        again = clm.loglikelihood(reqs + [(np.arange(4, dtype=np.int32) + 9,
                                           np.arange(3, dtype=np.int32))])
        assert calls["n"] == 4 and again[:3] == first
        assert first == orig(reqs)
        a = clm.greedy_generate(np.arange(5, dtype=np.int32) + 3, 4)
        np.testing.assert_array_equal(
            a, clm.greedy_generate(np.arange(5, dtype=np.int32) + 3, 4))
        assert clm.batch_size == 2          # other names reach the LM

    def test_one_key_for_tensor_and_array(self):
        """A tensor and an array of the same tokens share a key, the key
        of mxq_tpu's CachingLM for that array; other tokens do not."""
        a = np.arange(7, dtype=np.int32)
        key = th.CachingLM._key("ll", a, a[:3])
        assert th.CachingLM._key("ll", torch.from_numpy(a),
                                 torch.from_numpy(a[:3])) == key
        assert jh.CachingLM._key("ll", a, a[:3]) == key
        assert th.CachingLM._key("ll", a + 1, a[:3]) != key


class WordTok:
    """A stand-in for the HF tokenizer cli eval-tasks loads."""
    bos_token_id = 1

    def __call__(self, text, add_special_tokens=True):
        ids = toy_tokenize(text).tolist()
        return {"input_ids": ([1] if add_special_tokens else []) + ids}


def test_cli_eval_tasks(monkeypatch, capsys):
    """`eval-tasks --tasks list` prints mxq_tpu's names; without
    --tokenizer both CLIs exit with code 2 and the same message; with a
    tokenizer the port's command scores the dense model it builds (the
    preset's weights from --seed) as MXQLM does with bos_id, and prints
    each task's JSON line and the --table rows."""
    jcli.main(["eval-tasks", "--tasks", "list"])
    jnames = capsys.readouterr().out.split()
    names = cli.main(["eval-tasks", "--tasks", "list"])
    assert capsys.readouterr().out.split() == jnames == names
    assert len(names) == 291
    argv = ["eval-tasks", "--preset", "tiny", "--tasks", "synth"]
    for main, extra in ((jcli.main, []), (cli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(argv + extra)
        assert e.value.code == 2
        assert capsys.readouterr().err.strip() == \
            "eval-tasks requires --tokenizer"
    registry = th.all_tasks
    monkeypatch.setattr(th, "all_tasks",
                        lambda: {**registry(), "synth": TSynth()})
    monkeypatch.setattr(cli, "_tokenizer", lambda args: WordTok())
    got = cli.main(argv + ["--tokenizer", "toy", "--batch_size", "4",
                           "--device", "cpu", "--table"])
    out = capsys.readouterr().out.strip().splitlines()
    lm = th.MXQLM(tl.init_params(TCFG, 0, torch.float32, "cpu"), TCFG,
                  batch_size=4, bos_id=1, device="cpu")
    tokenize = lambda s: np.asarray(  # noqa: E731
        WordTok()(s, add_special_tokens=False)["input_ids"], np.int32)
    assert got == [TSynth().evaluate(lm, tokenize)]
    assert out[0] == json.dumps(got[0])
    assert out[1].startswith("|task") and any("|acc_norm" in r
                                              for r in out[3:])


def test_make_lm_eval_model_needs_lm_eval(dense):
    _, tp = dense
    with pytest.raises(ImportError):
        th.make_lm_eval_model(tp, TCFG, WordTok(), device="cpu")
