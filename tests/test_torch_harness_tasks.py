"""The port's task registry (mxq_tpu_torch/eval/harness.py and tasks_ext.py,
copies of mxq_tpu's) against mxq_tpu's, task by task, on the fixture rows
that tests/test_harness_fixtures.py and tests/test_harness_fixtures_ext.py
use: the ``module_rows`` fixture runs those tests with every task class's
``convert`` recording the rows it was given. The few task families those
tests give no rows, and CrowS-Pairs' bias types, get rows of their
datasets' schemas here (EXTRA_ROWS).

For each of the 291 tasks, with each package in turn: the same documents
from the same rows, and then ``evaluate`` (zero-shot and one-shot) over a
stand-in ``datasets`` (and ``sacrebleu``) module that serves those rows, a
recording tokenizer and a deterministic stand-in LM: the same strings
tokenized, the same requests, and the same result or the same error."""

import dataclasses
import inspect
import io
import sys
import types
from collections import defaultdict

import numpy as np
import pytest

from mxq_tpu.eval import harness as jh
from mxq_tpu.eval import tasks_ext as jx
from mxq_tpu_torch.eval import harness as th
from mxq_tpu_torch.eval import tasks_ext as tx

JREG = jh.all_tasks()
TREG = th.all_tasks()
NAMES = sorted(JREG)

# rows, in their datasets' schemas, for the families the fixture tests
# give none; keyed by the class that defines the loader
EXTRA_ROWS = {
    "WikiTextRolling": [{"text": " = Valkyria Chronicles = \n"},
                        {"text": " The game began development in 2010 .\n"}],
    "PilePerplexity": [{"text": f"A document of {s} .\nIts second line.",
                        "meta": {"pile_set_name": s}}
                       for s in sorted(set(jx.PILE_SETS.values()))],
    "WebQs": [{"question": "what is the name of justin bieber brother?",
               "answers": ["Jazmyn Bieber", "Jaxon Bieber"]}],
    "EthicsUtilitarianismOriginal": [
        {"activity": "I walked in the park this afternoon.",
         "baseline": "I walked in the parking lot this afternoon.",
         "rating": ""}],
    "GSM8K": [{"question": "Natalia sold clips to 48 of her friends in "
                           "April, and then she sold half as many clips in "
                           "May. How many clips did Natalia sell?",
               "answer": "Natalia sold 48/2 = <<48/2=24>>24 clips in May.\n"
                         "#### 72"}],
    "Unscramble": [{"context": "Please unscramble the letters into a word, "
                               "and write that word:\nr e!c.i p r o c a/l "
                               "=", "completion": "reciprocal"}],
    "WMTTranslation": [{"src": "Das Haus ist klein.",
                        "ref": "The house is small."}],
    # one pair of each bias type the registry filters on, beside the
    # fixture test's
    "CrowsPairs": [{"sent_more": f"The {b} one was rude.",
                    "sent_less": "The other one was rude.",
                    "bias_type": b}
                   for b in sorted({t.bias_type for t in JREG.values()
                                    if isinstance(t, jx.CrowsPairs)
                                    and t.bias_type})],
}


def _recording(cls_name, desc, rows):
    """``desc`` (a convert staticmethod, classmethod or method) recording
    the positional rows and keywords of every call that returns."""
    fn = desc.__func__ if isinstance(desc, (staticmethod, classmethod)) \
        else desc

    def call(*a, **k):
        out = fn(*a, **k)
        args = a[1:] if not isinstance(desc, staticmethod) else a
        rows[cls_name].append((list(args[0]), args[1:], k))
        return out

    if isinstance(desc, staticmethod):
        return staticmethod(call)
    if isinstance(desc, classmethod):
        return classmethod(call)
    return call


def _convert_owner(task):
    """The class in ``task``'s MRO that defines its ``convert`` (or its
    loader, for the classes without one)."""
    return next((c for c in type(task).__mro__ if "convert" in vars(c)),
                type(task))


@pytest.fixture(scope="module")
def module_rows():
    """class name -> [(rows, args, kwargs)] of every convert call the JAX
    fixture tests make (all but the model-scoring lambada metrics test,
    whose rows the prompt test also gives)."""
    import test_harness_fixtures
    import test_harness_fixtures_ext
    rows, saved = defaultdict(list), []
    for mod in (jh, jx):
        for c in vars(mod).values():
            if (inspect.isclass(c) and c.__module__ == mod.__name__
                    and "convert" in vars(c)):
                saved.append((c, vars(c)["convert"]))
                setattr(c, "convert",
                        _recording(c.__name__, vars(c)["convert"], rows))
    try:
        for mod in (test_harness_fixtures, test_harness_fixtures_ext):
            for name, fn in vars(mod).items():
                if (name.startswith("test_")
                        and name != "test_lambada_eval_metrics"):
                    fn()
    finally:
        for c, desc in saved:
            setattr(c, "convert", desc)
    for name, extra in EXTRA_ROWS.items():
        rows[name].append((extra, (), {}))
    return dict(rows)


class Rows(list):
    """A dataset split: a list of rows, and a column by name."""

    def __getitem__(self, key):
        if isinstance(key, str):
            return [r[key] for r in self]
        return super().__getitem__(key)


def stand_in_modules(rows):
    """``datasets`` whose every split is ``rows``, and ``sacrebleu`` whose
    test set is their ``src``/``ref`` and whose scores count characters."""
    ds = types.ModuleType("datasets")
    ds.load_dataset = lambda *a, **k: Rows(rows)
    sb = types.ModuleType("sacrebleu")
    sb.download_test_set = lambda testset, pair: ("src", "ref")
    sb.smart_open = lambda name: io.StringIO(
        "\n".join(str(r.get(name, "")) for r in rows))
    score = lambda preds, refs: types.SimpleNamespace(  # noqa: E731
        score=float(sum(map(len, preds)) - sum(map(len, refs[0]))))
    sb.corpus_bleu = sb.corpus_chrf = sb.corpus_ter = score
    sb.sentence_bleu = lambda hyp, refs: score([hyp], [refs])
    return {"datasets": ds, "sacrebleu": sb}


class StandInLM:
    """Scores and generations that are functions of the request tokens;
    every call recorded."""

    def __init__(self):
        self.calls = []

    def loglikelihood(self, requests):
        reqs = [(np.asarray(c).tolist(), np.asarray(g).tolist())
                for c, g in requests]
        self.calls.append(("ll", reqs))
        return [(-float((sum(c) * 7 + sum(g) * 3) % 101) / 10 - len(g),
                 bool((sum(g) + len(c)) % 2)) for c, g in reqs]

    def loglikelihood_rolling(self, streams, **kw):
        seqs = [np.asarray(s).tolist() for s in streams]
        self.calls.append(("llr", seqs, kw))
        return [-float(sum(s) % 97) - len(s) for s in seqs]

    def generate_batch(self, ctxs, max_new_tokens=64, eos_id=None):
        seqs = [np.asarray(c).tolist() for c in ctxs]
        self.calls.append(("gen", seqs, max_new_tokens, eos_id))
        return [np.asarray(s[-7:] + [10] + s[:3], np.int32) for s in seqs]

    def greedy_generate(self, ctx, max_new_tokens=64, stop_sequences=(),
                        eos_id=None):
        (out,) = self.generate_batch([ctx], max_new_tokens, eos_id)
        return out


class CharTok:
    """Characters as token ids; every string it encodes is recorded."""
    eos_token_id = 3

    def __init__(self):
        self.seen = []

    def encode(self, text):
        self.seen.append(text)
        return np.asarray([ord(ch) for ch in text], np.int32)

    def __call__(self, text, add_special_tokens=True):
        return {"input_ids": self.encode(text).tolist()}

    def decode(self, ids, skip_special_tokens=False):
        return "".join(chr(int(i)) for i in ids)


def _plain(x):
    """Documents as plain data (MCDoc of either package as its fields)."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, _plain(dataclasses.asdict(x)))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def _evaluate(harness, name, rows, num_fewshot, monkeypatch):
    """``harness.evaluate`` of one task over ``rows``: its result or its
    error, the strings tokenized and the LM calls."""
    for mod, stub in stand_in_modules(rows).items():
        monkeypatch.setitem(sys.modules, mod, stub)
    lm, tok = StandInLM(), CharTok()
    try:
        out = ("ok", harness.evaluate(lm, tok.encode, [name], tok=tok,
                                      num_fewshot=num_fewshot))
    except (RuntimeError, KeyError, ValueError) as e:
        out = ("raised", type(e).__name__, str(e))
    return out, tok.seen, lm.calls


@pytest.mark.parametrize("name", NAMES)
def test_task_matches_jax(name, module_rows, monkeypatch):
    """Same class, documents from the same rows, and the same evaluate:
    strings tokenized, requests, result (or error), zero- and one-shot."""
    jt, tt = JREG[name], TREG[name]
    assert type(tt).__name__ == type(jt).__name__
    assert type(tt).__module__.startswith("mxq_tpu_torch.")
    owner = _convert_owner(jt).__name__
    calls = module_rows.get(owner)
    assert calls, f"no rows for {owner}"
    if hasattr(jt, "convert"):
        for rows, args, kw in calls:
            assert _plain(tt.convert(rows, *args, **kw)) == \
                _plain(jt.convert(rows, *args, **kw))
    rows = [r for rs, _, _ in calls for r in rs]
    for shots in (0, 1):
        want = _evaluate(jh, name, rows, shots, monkeypatch)
        got = _evaluate(th, name, rows, shots, monkeypatch)
        assert got == want
        if shots == 0:
            assert got[0][0] == "ok", got[0]


def test_registry_names_equal_jax():
    """The same 291 names (the core TASKS with the obqa alias, then the
    extended families) in both packages, each an instance of the port."""
    assert sorted(TREG) == NAMES and len(NAMES) == 291
    assert sorted(th.TASKS) == sorted(jh.TASKS)
    assert sorted(tx.TASKS_EXT) == sorted(jx.TASKS_EXT)
    assert th.TASKS["obqa"] is th.TASKS["openbookqa"]
    assert th.MMLU_SUBJECTS == jh.MMLU_SUBJECTS


def test_zero_shot_only_tasks_raise_with_num_fewshot():
    """The families the reference holds to num_fewshot == 0 (its evaluate
    takes no num_fewshot) raise in both packages before any scoring, with
    the same message."""
    zero_shot = [n for n in NAMES if "num_fewshot" not in
                 inspect.signature(TREG[n].evaluate).parameters]
    assert zero_shot == [n for n in NAMES if "num_fewshot" not in
                         inspect.signature(JREG[n].evaluate).parameters]
    assert {"wikitext", "truthfulqa_mc", "pile_arxiv",
            "crows_pairs_english", "blimp_adjunct_island"} <= set(zero_shot)
    for name in zero_shot:
        errs = []
        for harness in (jh, th):
            lm = StandInLM()
            with pytest.raises(RuntimeError, match="zero-shot only") as e:
                harness.evaluate(lm, CharTok().encode, [name], num_fewshot=2)
            assert lm.calls == []
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def test_reference_request_hash_and_fewshot_prefixes_equal():
    """reference_loglikelihood_requests, reference_request_hash and
    fewshot_prefixes (its random.Random(42)) equal JAX's on synthetic
    documents, with and without a separate example pool."""
    rng = np.random.RandomState(0)

    def docs(mcdoc):
        return [mcdoc(f"Question {i}: {rng.randint(99)}?\nAnswer:",
                      [f"choice {j}" for j in range(rng.randint(2, 5))],
                      0) for i in range(9)]

    state = rng.get_state()
    jdocs = docs(jh.MCDoc)
    rng.set_state(state)
    tdocs = docs(th.MCDoc)

    class Task:
        name = "synthetic"

        def __init__(self, ds):
            self.ds = ds

        def docs(self):
            return list(self.ds)

    jreqs = jh.reference_loglikelihood_requests(Task(jdocs))
    treqs = th.reference_loglikelihood_requests(Task(tdocs))
    assert treqs == jreqs and len(treqs) == sum(len(d.choices)
                                                for d in tdocs)
    assert th.reference_request_hash(treqs) == jh.reference_request_hash(jreqs)
    ex = lambda d: f"{d.context} {d.choices[d.gold]}"  # noqa: E731
    for k in (0, 1, 3):
        for pool in (None, slice(0, 4)):
            jp = None if pool is None else jdocs[pool]
            tp = None if pool is None else tdocs[pool]
            assert th.fewshot_prefixes(tdocs, k, ex, pool=tp) == \
                jh.fewshot_prefixes(jdocs, k, ex, pool=jp)
    assert th.general_detokenize("it 's ( a ) \" b \" n't") == \
        jh.general_detokenize("it 's ( a ) \" b \" n't")
    with pytest.raises(RuntimeError, match="dataset unavailable"):
        th.reference_loglikelihood_requests(Task([]))
