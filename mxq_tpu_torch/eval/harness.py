"""Task-eval harness (port of ``mxq_tpu/eval/harness.py``) — the counterpart
of the reference's vendored lm-evaluation-harness v0.3.0 and its lmeval.py
entry point (mxq_quant/lmeval.py:45-138).

Rather than vendoring 13.5k lines, this implements the harness CORE the
reference actually uses for its headline tasks — loglikelihood-scored
multiple choice (winogrande/piqa/hellaswag/arc_easy, README.md:26-34) — and
exposes an adapter for an externally-installed lm-eval when present.

Protocol (mirrors base.py:172 loglikelihood + MultipleChoiceTask:604):
  * a request is (context tokens, continuation tokens)
  * score = sum of log p(continuation | context) under the model
  * accuracy: argmax over choices == gold; acc_norm: byte-length normalized

:class:`MXQLM` scores on ``device`` (the card unless ``"cpu"`` is named)
through ``models.llama.forward``: a packed model's linears take the GEMV
kernel below 512 rows a batch (batch_size x padded length) and the prefill
kernel with the GEMMs from 512 rows on. The task classes use no torch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from mxq_tpu_torch import resolve_device
from mxq_tpu_torch.models import llama


# ---------------------------------------------------------------------------
# LM adapter
# ---------------------------------------------------------------------------


def _host(a) -> np.ndarray:
    """Tokens as a numpy array (a tensor is read from its device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@torch.no_grad()
def score_batch(params, ids: torch.Tensor, cont_mask: torch.Tensor,
                cfg: llama.LlamaConfig, device: str | torch.device = "cuda"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """ids [B, T] RIGHT-padded; cont_mask [B, T] marks continuation
    positions. Returns (sum logp over continuation [B] f32, exact-match
    flag [B] bool), both on ``device``.

    Right padding (sequence at the start, zeros after) matches the
    reference's vendored lm-eval v0.3.0 protocol (base.py:270-281): under
    the causal mask no real token can attend a pad (pads only come
    later), and RoPE positions start at 0 — so pads never influence
    scores and no attention mask is needed. The f32 log-softmax runs one
    row at a time, so that beside the [B, T, V] logits only one row's
    copy is alive (8 x 1024 x 32000 logits are 1 GB)."""
    logits, _ = llama.forward(params, ids, cfg, device=device)
    tgt = ids[:, 1:].long()
    m = cont_mask[:, 1:].float()
    s = torch.empty(ids.shape[0], dtype=torch.float32, device=logits.device)
    exact = torch.empty(ids.shape[0], dtype=torch.bool, device=logits.device)
    for b in range(ids.shape[0]):
        logp = torch.log_softmax(logits[b, :-1].float(), -1)
        tok_lp = logp.gather(-1, tgt[b, :, None])[:, 0]
        s[b] = (tok_lp * m[b]).sum()
        # torch.argmax, like jnp.argmax, takes the first of equal maxima
        greedy = (logp.argmax(-1) == tgt[b]) | (m[b] == 0)
        exact[b] = greedy.all()
    return s, exact


class MXQLM:
    """Batched loglikelihood scorer over an mxq_tpu_torch model (the
    analogue of lm_eval's AutoCausalLM, huggingface.py:378-420)."""

    def __init__(self, params, cfg: llama.LlamaConfig, batch_size: int = 8,
                 max_len: int = 2048, bos_id: Optional[int] = None,
                 device: str | torch.device = "cuda"):
        """``bos_id``: when set, every scored sequence is prefixed with
        this token and the caller should tokenize WITHOUT special tokens
        (cli does). This reproduces the reference protocol: contexts get
        the model's start token, continuations never do, and an empty
        context becomes ``[bos]`` — the same role as lm-eval's ``""`` ->
        ``[eot]`` prefix (base.py:195-201). Without it (None), sequences
        are scored exactly as tokenized. ``params`` live on ``device``."""
        self.device = resolve_device(device)
        llama.check_params_device(params, self.device)
        self.params = params
        self.cfg = cfg
        self.batch_size = batch_size
        self.max_len = max_len
        self.bos_id = bos_id
        self._engine = None

    def _score(self, ids: torch.Tensor, cont_mask: torch.Tensor):
        return score_batch(self.params, ids, cont_mask, self.cfg,
                           self.device)

    def loglikelihood(self, requests: Sequence[tuple[np.ndarray, np.ndarray]]
                      ) -> list[tuple[float, bool]]:
        """requests: list of (context_tokens, continuation_tokens), numpy
        arrays or tensors.

        Requests are sorted by length and each batch pads only to ITS
        longest member (rounded to a power of two, so at most
        log2(max_len) shapes) — the reference harness's reorderer
        semantics (lm-eval base.py sorts descending before batching).
        Every batch has ``batch_size`` rows (zero rows fill a short last
        batch), so batch_size x the padded length is the row count each
        linear sees. Results return in the original request order, read
        from the device once per batch; scores are pad-invariant (see
        :func:`score_batch`).
        """
        requests = [(_host(c), _host(g)) for c, g in requests]
        out: list[Optional[tuple[float, bool]]] = [None] * len(requests)
        bs = self.batch_size
        extra = 1 if self.bos_id is not None else 0
        order = sorted(range(len(requests)),
                       key=lambda i: len(requests[i][0]) + len(requests[i][1]))
        for i in range(0, len(order), bs):
            idxs = order[i:i + bs]
            t_pad = max(len(requests[j][0]) + len(requests[j][1])
                        for j in idxs) + extra
            t_pad = min(_round_pow2(max(t_pad, 2)), self.max_len)
            ids = np.zeros((bs, t_pad), np.int32)
            mask = np.zeros((bs, t_pad), np.int32)
            for row, j in enumerate(idxs):
                ctx, cont = requests[j]
                if self.bos_id is not None:
                    ctx = np.concatenate([[self.bos_id],
                                          np.asarray(ctx, np.int64)])
                seq = np.concatenate([ctx, cont])[-t_pad:]
                n_cont = min(len(cont), len(seq))
                ids[row, : len(seq)] = seq
                mask[row, len(seq) - n_cont: len(seq)] = 1
            s, exact = self._score(torch.from_numpy(ids).to(self.device),
                                   torch.from_numpy(mask).to(self.device))
            host = torch.stack([s, exact.float()]).cpu().numpy()
            for row, j in enumerate(idxs):
                out[j] = (float(host[0, row]), bool(host[1, row]))
        return out  # type: ignore[return-value]

    def loglikelihood_rolling(self, streams: Sequence[np.ndarray],
                              prefix_token: int = 2) -> list[float]:
        """Full log-likelihood of each token stream, windowed to max_len
        with each token predicted exactly once — the vendored lm-eval
        v0.3.0 protocol (base.py:187-216, utils.get_rolling_token_windows
        with context_len=1 + make_disjoint_window). ``prefix_token`` plays
        the eot/bos role so the first token has context (Llama eos=2)."""
        out = []
        for toks in streams:
            windows = [
                make_disjoint_window(w)
                # max_len - 1 so ctx+cont (incl. the 1-token context) fits
                # the scorer's window without dropping the context token
                for w in get_rolling_token_windows(
                    list(_host(toks).tolist()), prefix_token,
                    self.max_len - 1, 1)
            ]
            reqs = [(np.asarray(c, np.int32), np.asarray(p, np.int32))
                    for c, p in windows]
            scores = self.loglikelihood(reqs)
            out.append(float(sum(s for s, _ in scores)))
        return out

    def generate_batch(self, ctxs: Sequence[np.ndarray],
                       max_new_tokens: int = 64,
                       eos_id: Optional[int] = None) -> list[np.ndarray]:
        """Batched greedy continuation of many contexts through the serving
        Engine (continuous batching, KV cache, pipelined decode) — the fast
        path for generation-task evals. Greedy + same forward ⇒ the tokens
        of ``greedy_generate`` up to any stop sequence (on a packed model
        up to near-ties: decode's linears see the live slots' rows, the
        re-forward's the window's); callers trim stop strings on the
        decoded text (over-generating past a stop and trimming yields the
        same final text under greedy decoding)."""
        from mxq_tpu_torch.serving.engine import Engine, EngineConfig
        if self._engine is None:
            # eval models are fake-quant params: keep the cache bf16 so
            # Engine generations match llama.forward exactly (the int8-KV
            # real-quant cache is the serving deployment choice, not the
            # eval protocol of the reference's HF generate)
            self._engine = Engine(
                self.params, self.cfg,
                EngineConfig(num_slots=min(self.batch_size, 8),
                             max_len=self.max_len, kv_quant=False,
                             prefill_buckets=(128, 512, self.max_len)),
                device=self.device)
        eng = self._engine
        ctxs = [_host(c) for c in ctxs]
        if self.bos_id is not None:
            ctxs = [np.concatenate([[self.bos_id], np.asarray(c, np.int64)])
                    for c in ctxs]
        reqs = [eng.submit(np.asarray(c, np.int32), max_new_tokens,
                           eos_token_id=eos_id) for c in ctxs]
        eng.run()
        return [np.asarray(r.generated, np.int32) for r in reqs]

    @torch.no_grad()
    def greedy_generate(self, ctx: np.ndarray, max_new_tokens: int = 64,
                        stop_sequences: Sequence[Sequence[int]] = (),
                        eos_id: Optional[int] = None) -> np.ndarray:
        """Greedy continuation of ``ctx`` (the harness ``generate_until``
        core). Re-forwards the growing sequence each step — the serving
        Engine is the fast path; this is the simple reference used for eval
        protocols."""
        toks = list(_host(ctx).tolist())
        if self.bos_id is not None:
            toks = [self.bos_id] + toks
        start = len(toks)
        for _ in range(max_new_tokens):
            t_pad = min(_round_pow2(len(toks)), self.max_len)
            ids = np.zeros((1, t_pad), np.int32)
            window = toks[-t_pad:]
            ids[0, : len(window)] = window
            logits, _ = llama.forward(self.params,
                                      torch.from_numpy(ids).to(self.device),
                                      self.cfg, device=self.device)
            nxt = int(logits[0, len(window) - 1].argmax())
            toks.append(nxt)
            if eos_id is not None and nxt == eos_id:
                break
            gen = toks[start:]
            if any(len(s) > 0 and gen[-len(s):] == list(s)
                   for s in stop_sequences):
                break
        return np.asarray(toks[start:], np.int32)


def get_rolling_token_windows(token_list: list, prefix_token: int,
                              max_seq_len: int, context_len: int = 1):
    """(input_tokens, pred_tokens) windows over a stream, each token
    predicted exactly once, later windows keeping maximal context
    (lm-evaluation-harness utils.py:72-110 semantics)."""
    assert 1 <= context_len <= max_seq_len
    if not token_list:
        return
    pred_len = max_seq_len - context_len + 1
    first = min(max_seq_len, len(token_list))
    yield ([prefix_token] + token_list[: first - 1], token_list[:first])
    predicted = first
    while predicted < len(token_list):
        window_pred_len = min(len(token_list) - predicted, pred_len)
        window_end = predicted + window_pred_len
        yield (token_list[window_end - max_seq_len - 1: window_end - 1],
               token_list[window_end - window_pred_len: window_end])
        predicted += window_pred_len


class CachingLM:
    """Request-level result cache around an LM — the analogue of the
    vendored harness's ``CachingLM`` (lm-evaluation-harness/lm_eval/base.py
    :734-790, sqlitedict-backed): identical requests hit sqlite instead of
    the device, so re-running a task sweep after a crash or with more tasks
    only scores what is new."""

    def __init__(self, lm, cache_path: str):
        import sqlite3
        self.lm = lm
        self._db = sqlite3.connect(cache_path)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS cache (k TEXT PRIMARY KEY, v BLOB)")
        self._db.commit()

    @staticmethod
    def _key(kind: str, *arrays) -> str:
        """One key per request: a tensor hashes as the numpy array of its
        tokens, so a CUDA tensor, a CPU tensor and an array share it."""
        import hashlib
        h = hashlib.sha256(kind.encode())
        for a in arrays:
            a = _host(a)
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        return h.hexdigest()

    def _get(self, key):
        import pickle
        row = self._db.execute("SELECT v FROM cache WHERE k=?",
                               (key,)).fetchone()
        return pickle.loads(row[0]) if row else None

    def _put(self, key, value) -> None:
        import pickle
        self._db.execute("INSERT OR REPLACE INTO cache VALUES (?, ?)",
                         (key, pickle.dumps(value)))
        self._db.commit()

    def loglikelihood(self, requests):
        keys = [self._key("ll", c, g) for c, g in requests]
        out = [self._get(k) for k in keys]
        missing = [i for i, v in enumerate(out) if v is None]
        if missing:
            fresh = self.lm.loglikelihood([requests[i] for i in missing])
            for i, v in zip(missing, fresh):
                out[i] = v
                self._put(keys[i], v)
        return out

    def loglikelihood_rolling(self, streams, **kw):
        keys = [self._key("llr", s) for s in streams]
        out = [self._get(k) for k in keys]
        missing = [i for i, v in enumerate(out) if v is None]
        if missing:
            fresh = self.lm.loglikelihood_rolling(
                [streams[i] for i in missing], **kw)
            for i, v in zip(missing, fresh):
                out[i] = v
                self._put(keys[i], v)
        return out

    def greedy_generate(self, ctx, max_new_tokens: int = 64,
                        stop_sequences=(), eos_id=None):
        key = self._key(
            f"gen:{max_new_tokens}:{eos_id}:"
            + "|".join(",".join(map(str, s)) for s in stop_sequences), ctx)
        hit = self._get(key)
        if hit is None:
            hit = np.asarray(self.lm.greedy_generate(
                ctx, max_new_tokens, stop_sequences, eos_id))
            self._put(key, hit)
        return hit

    def generate_batch(self, ctxs, max_new_tokens: int = 64, eos_id=None):
        keys = [self._key(f"genb:{max_new_tokens}:{eos_id}", c)
                for c in ctxs]
        out = [self._get(k) for k in keys]
        missing = [i for i, v in enumerate(out) if v is None]
        if missing:
            fresh = self.lm.generate_batch([ctxs[i] for i in missing],
                                           max_new_tokens, eos_id)
            for i, v in zip(missing, fresh):
                out[i] = np.asarray(v)
                self._put(keys[i], out[i])
        return out

    def __getattr__(self, name):
        return getattr(self.lm, name)


def make_disjoint_window(pair):
    """Trim the context so it does not overlap the continuation
    (utils.py:113-116)."""
    a, b = pair
    return a[: len(a) - (len(b) - 1)], b


def _round_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# Tasks
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MCDoc:
    context: str
    choices: list[str]
    gold: int


class MultipleChoiceTask:
    """Accuracy + byte-normalized accuracy over loglikelihood-scored choices
    (lm-evaluation-harness base.py:604-637 semantics)."""

    name = "mc_task"

    def docs(self) -> Iterable[MCDoc]:
        raise NotImplementedError

    def evaluate(self, lm: MXQLM, tokenize: Callable[[str], np.ndarray],
                 limit: Optional[int] = None, num_fewshot: int = 0) -> dict:
        docs = self.docs()
        if docs is None:
            raise RuntimeError(
                f"task {self.name!r} has no documents — dataset unavailable "
                "(datasets/network missing?)")
        docs = list(docs)
        if not docs:
            raise RuntimeError(f"task {self.name!r} produced zero documents")
        if limit:
            docs = docs[:limit]
        pool = None
        if num_fewshot and hasattr(self, "fewshot_docs"):
            pool = self.fewshot_docs()
            if pool is None:
                # do NOT silently fall back to sampling eval docs — that
                # would quietly change the few-shot protocol (MMLU must
                # draw from its dev split, hendrycks_test.py:157-161)
                raise RuntimeError(
                    f"task {self.name!r}: few-shot example split "
                    "unavailable (datasets/network missing?)")
        prefixes = fewshot_prefixes(
            docs, num_fewshot,
            lambda d: f"{d.context} {d.choices[d.gold]}", pool=pool)
        reqs, spans = [], []
        for d, pre in zip(docs, prefixes):
            start = len(reqs)
            for ch in d.choices:
                # reference-exact continuation: " " + choice with NO strip
                # (base.py:609 `" {}".format(choice)`)
                reqs.append((tokenize(pre + d.context),
                             tokenize(" " + ch)))
            spans.append((start, len(reqs), d))
        scores = lm.loglikelihood(reqs)
        hits, hitsn = [], []
        preds = []                       # (doc, argmax pick) per document
        for start, end, d in spans:
            lls = [scores[k][0] for k in range(start, end)]
            # acc_norm normalizes by the RAW choice char length (base.py:617
            # `completion_len = len(choice)` — no leading space, no +1). An
            # empty choice (which the reference never has) scores -inf, the
            # strict analogue of the reference's ll/0 = -inf: it can never
            # win the normalized argmax.
            pick = int(np.argmax(lls))
            pickn = int(np.argmax([l / len(c) if c else -np.inf
                                   for l, c in zip(lls, d.choices)]))
            hits.append(float(pick == d.gold))
            hitsn.append(float(pickn == d.gold))
            preds.append((d, pick))
        n = max(len(spans), 1)
        res = {"task": self.name, "acc": float(np.mean(hits)),
               "acc_norm": float(np.mean(hitsn)), "n": n}
        if n > 1:
            # sample-stddev/sqrt(n), the reference's mean_stderr
            # (metrics.py:24-25) shown as ± in make_table
            res["acc_stderr"] = float(np.std(hits, ddof=1) / np.sqrt(n))
            res["acc_norm_stderr"] = float(np.std(hitsn, ddof=1) /
                                           np.sqrt(n))
        res.update(self._extra_metrics(preds))
        return res

    def _extra_metrics(self, preds: list) -> dict:
        """Hook for subclass metrics derived from the SAME scored pass
        (``preds`` = [(doc, argmax_pick)]) — e.g. CoLA's MCC — so no task
        re-scores its requests a second time."""
        return {}


def _hf_docs(loader):
    try:
        return loader()
    except Exception:
        return None


def fewshot_prefixes(docs: list, num_fewshot: int,
                     example: Callable, pool: Optional[list] = None
                     ) -> list[str]:
    """Per-document few-shot prefix strings: ``num_fewshot`` labeled
    examples joined by blank lines (lm-eval base.py:278-307, rnd seeded
    per evaluator.py:90). With ``pool`` (a separate example set, e.g.
    MMLU's dev split — the reference's training-docs path) examples are
    sampled from it directly; otherwise they come from the evaluation
    docs themselves, excluding the current doc (the reference's fallback
    for tasks without training docs). "" for every doc at num_fewshot=0."""
    if not num_fewshot:
        return [""] * len(docs)
    import random as _random
    rnd = _random.Random(42)
    out = []
    for i in range(len(docs)):
        if pool is not None:
            picks = [pool[j] for j in rnd.sample(
                range(len(pool)), min(num_fewshot, len(pool)))]
        else:
            idxs = rnd.sample(range(len(docs)), min(num_fewshot + 1,
                                                    len(docs)))
            picks = [docs[j] for j in idxs if j != i][:num_fewshot]
        out.append("\n\n".join(example(d) for d in picks) + "\n\n")
    return out


class PIQA(MultipleChoiceTask):
    name = "piqa"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        """Raw piqa rows (goal/sol1/sol2/label) -> docs. The prompt format
        is pinned by tests/test_harness_fixtures.py (the offline analogue
        of the reference's tests/testdata request goldens)."""
        return [MCDoc(f"Question: {d['goal']}\nAnswer:",
                      [d["sol1"], d["sol2"]], d["label"]) for d in rows]

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset("piqa", split="validation"))
        return _hf_docs(load)


class Winogrande(MultipleChoiceTask):
    name = "winogrande"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        out = []
        for d in rows:
            idx = d["sentence"].index("_")
            ctx = d["sentence"][:idx]
            tail = d["sentence"][idx + 1:]
            out.append(MCDoc(ctx, [d["option1"] + tail,
                                   d["option2"] + tail],
                             int(d["answer"]) - 1))
        return out

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset(
                "winogrande", "winogrande_xl", split="validation"))
        return _hf_docs(load)


class HellaSwag(MultipleChoiceTask):
    name = "hellaswag"

    @staticmethod
    def preprocess(text: str) -> str:
        """Task-level cleanup, ported from the reference
        (tasks/hellaswag.py preprocess): strip, WikiHow "[title]"/bracket
        artifacts, double-space collapse."""
        import re
        text = text.strip()
        text = text.replace(" [title]", ". ")
        text = re.sub(r"\[.*?\]", "", text)
        text = text.replace("  ", " ")
        return text

    @classmethod
    def convert(cls, rows) -> list[MCDoc]:
        """Reference-exact doc construction (tasks/hellaswag.py
        _process_doc): query = preprocess(activity_label + ": " + ctx_a +
        " " + ctx_b.capitalize()); choices = preprocess(ending)."""
        out = []
        for d in rows:
            ctx = d["ctx_a"] + " " + d["ctx_b"].capitalize()
            out.append(MCDoc(
                cls.preprocess(d["activity_label"] + ": " + ctx),
                [cls.preprocess(e) for e in d["endings"]],
                int(d["label"])))
        return out

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(
                load_dataset("hellaswag", split="validation"))
        return _hf_docs(load)


class ArcEasy(MultipleChoiceTask):
    name = "arc_easy"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        out = []
        for d in rows:
            gold = d["choices"]["label"].index(d["answerKey"])
            out.append(MCDoc(f"Question: {d['question']}\nAnswer:",
                             d["choices"]["text"], gold))
        return out

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(
                # the reference evaluates the TEST split (arc.py
                # has_test_docs=True; evaluator.py:203-207 prefers test)
                load_dataset("ai2_arc", "ARC-Easy", split="test"))
        return _hf_docs(load)


class ArcChallenge(MultipleChoiceTask):
    """Same protocol as arc_easy on the ARC-Challenge split (the vendored
    harness's ARCChallenge subclass, tasks/arc.py:54-79)."""
    name = "arc_challenge"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        num2let = {"1": "A", "2": "B", "3": "C", "4": "D", "5": "E"}
        out = []
        for d in rows:
            key = num2let.get(d["answerKey"], d["answerKey"])
            gold = d["choices"]["label"].index(d["answerKey"]) \
                if d["answerKey"] in d["choices"]["label"] \
                else ["A", "B", "C", "D", "E"].index(key)
            out.append(MCDoc(f"Question: {d['question']}\nAnswer:",
                             d["choices"]["text"], gold))
        return out

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset(
                "ai2_arc", "ARC-Challenge", split="test"))
        return _hf_docs(load)


class BoolQ(MultipleChoiceTask):
    """Yes/no loglikelihood comparison (tasks/superglue.py:35-80: context =
    passage + question, continuations " no"/" yes", gold = label)."""
    name = "boolq"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        return [MCDoc(f"{d['passage']}\nQuestion: {d['question']}?"
                      f"\nAnswer:", ["no", "yes"], int(d["label"]))
                for d in rows]

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset(
                "super_glue", "boolq", split="validation"))
        return _hf_docs(load)


class SIQA(MultipleChoiceTask):
    """Social-IQA 3-way MC (LLM-QAT README.md:42-55 protocol; social_i_qa
    labels are 1-based)."""
    name = "siqa"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        return [MCDoc(f"Question: {d['context']} {d['question']}"
                      f"\nAnswer:",
                      [d["answerA"], d["answerB"], d["answerC"]],
                      int(d["label"]) - 1)
                for d in rows]

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(
                load_dataset("social_i_qa", split="validation"))
        return _hf_docs(load)


class OpenBookQA(MultipleChoiceTask):
    """OBQA: context is the bare question stem (tasks/openbookqa.py:55-65).
    Registered under the reference's name ``openbookqa``
    (tasks/__init__.py:139); ``obqa`` kept as an alias. Evaluates the TEST
    split (openbookqa.py has_test_docs=True -> the evaluator prefers test,
    evaluator.py:203-207)."""
    name = "openbookqa"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        return [MCDoc(d["question_stem"], d["choices"]["text"],
                      ["A", "B", "C", "D"].index(d["answerKey"].strip()))
                for d in rows]

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(
                load_dataset("openbookqa", "main", split="test"))
        return _hf_docs(load)


class COPA(MultipleChoiceTask):
    """Choice-of-plausible-alternatives: premise minus its period + the
    cause/effect connector; choices are lowercase-first alternatives
    (tasks/superglue.py Copa.doc_to_text/convert_choice)."""
    name = "copa"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        conn = {"cause": "because", "effect": "therefore"}
        out = []
        for d in rows:
            ctx = d["premise"].strip()[:-1] + f" {conn[d['question']]}"
            ch = [c[0].lower() + c[1:] for c in (d["choice1"], d["choice2"])]
            out.append(MCDoc(ctx, ch, int(d["label"])))
        return out

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset(
                "super_glue", "copa", split="validation"))
        return _hf_docs(load)


class RTE(MultipleChoiceTask):
    """Entailment as True/False loglikelihood comparison
    (tasks/glue.py:327-363: 0 = entailment = "True")."""
    name = "rte"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        return [MCDoc(f"{d['sentence1']}\nQuestion: {d['sentence2']} "
                      f"True or False?\nAnswer:",
                      ["True", "False"], int(d["label"])) for d in rows]

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset(
                "glue", "rte", split="validation"))
        return _hf_docs(load)


class SciQ(MultipleChoiceTask):
    """Support passage + question; the correct answer is appended LAST to
    the three distractors (tasks/sciq.py _process_doc: gold=3)."""
    name = "sciq"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        out = []
        for d in rows:
            ctx = f"{d['support']}\nQuestion: {d['question']}\nAnswer:" \
                .strip()
            out.append(MCDoc(ctx, [d["distractor1"], d["distractor2"],
                                   d["distractor3"], d["correct_answer"]],
                             3))
        return out

    def docs(self):
        def load():
            from datasets import load_dataset
            # TEST split, like the reference (sciq.py has_test=True)
            return self.convert(load_dataset("sciq", split="test"))
        return _hf_docs(load)


class SWAG(MultipleChoiceTask):
    """Bare startphrase context, four endings (tasks/swag.py:50-59)."""
    name = "swag"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        return [MCDoc(d["startphrase"],
                      [d["ending0"], d["ending1"], d["ending2"],
                       d["ending3"]], int(d["label"])) for d in rows]

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset(
                "swag", "regular", split="validation"))
        return _hf_docs(load)


class CB(MultipleChoiceTask):
    """CommitmentBank 3-way NLI: True/False/Neither
    (tasks/superglue.py:91-128; 0=entailment=True, 2=neutral=Neither)."""
    name = "cb"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        return [MCDoc(f"{d['premise']}\nQuestion: {d['hypothesis']}. "
                      f"True, False or Neither?\nAnswer:",
                      ["True", "False", "Neither"], int(d["label"]))
                for d in rows]

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset(
                "super_glue", "cb", split="validation"))
        return _hf_docs(load)


class WiC(MultipleChoiceTask):
    """Words-in-context: same-word-same-sense yes/no; the probed word is
    the start1:end1 slice of sentence1 (tasks/superglue.py
    WordsInContext.doc_to_text). NOTE the reference scores (yes, no) in
    that order but gold label 1 = yes; choices here are [no, yes] so
    gold == label directly."""
    name = "wic"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        out = []
        for d in rows:
            word = d["sentence1"][d["start1"]: d["end1"]]
            ctx = (f"Sentence 1: {d['sentence1']}\n"
                   f"Sentence 2: {d['sentence2']}\n"
                   f"Question: Is the word '{word}' used in the same way "
                   f"in the two sentences above?\nAnswer:")
            out.append(MCDoc(ctx, ["no", "yes"], int(d["label"])))
        return out

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset(
                "super_glue", "wic", split="validation"))
        return _hf_docs(load)


class LogiQA(MultipleChoiceTask):
    """Lettered-choices prompt; continuations are the option TEXTS
    (tasks/logiqa.py:55-83)."""
    name = "logiqa"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        letters = ["a", "b", "c", "d"]
        out = []
        for d in rows:
            prompt = "Passage: " + d["context"] + "\n"
            prompt += "Question: " + d["question"] + "\nChoices:\n"
            for letter, option in zip(letters, d["options"]):
                prompt += f"{letter.upper()}. {option}\n"
            prompt += "Answer:"
            out.append(MCDoc(prompt, list(d["options"]),
                             letters.index(d["label"])))
        return out

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset(
                # TEST split, like the reference (logiqa.py has_test=True)
                "lucasmccabe/logiqa", split="test"))
        return _hf_docs(load)


class LambadaOpenAI:
    """Last-word prediction: context = text minus the final word,
    continuation = " " + final word; metrics = ppl over the continuation
    LLs and greedy-exact accuracy (tasks/lambada.py:31-72,91-99)."""

    name = "lambada_openai"

    @staticmethod
    def convert(rows) -> list[tuple[str, str]]:
        out = []
        for d in rows:
            ctx, last = d["text"].rsplit(" ", 1)
            out.append((ctx, " " + last))
        return out

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset(
                "EleutherAI/lambada_openai", "en", split="test"))
        return _hf_docs(load)

    def evaluate(self, lm: "MXQLM", tokenize, limit: Optional[int] = None
                 ) -> dict:
        docs = self.docs()
        if docs is None:
            raise RuntimeError(
                f"task {self.name!r} has no documents — dataset unavailable "
                "(datasets/network missing?)")
        docs = list(docs)
        if limit:
            docs = docs[:limit]
        reqs = [(tokenize(c), tokenize(t)) for c, t in docs]
        scores = lm.loglikelihood(reqs)
        lls = [s for s, _ in scores]
        acc = sum(int(g) for _, g in scores) / max(len(scores), 1)
        return {"task": self.name,
                "ppl": float(np.exp(-np.mean(lls))) if lls else float("inf"),
                "acc": acc, "n": len(docs)}


class WikiTextRolling:
    """Rolling-loglikelihood perplexity over wikitext-2 test — the harness's
    `wikitext` task metrics (word_perplexity/byte_perplexity/bits_per_byte
    over the document's full LL, PerplexityTask base.py:638+)."""

    name = "wikitext"

    def texts(self) -> Optional[list[str]]:
        def load():
            from datasets import load_dataset
            ds = load_dataset("wikitext", "wikitext-2-raw-v1", split="test")
            return ["\n\n".join(ds["text"])]
        return _hf_docs(load)

    def evaluate(self, lm: MXQLM, tokenize, limit: Optional[int] = None
                 ) -> dict:
        import re
        texts = self.texts()
        if texts is None:
            raise RuntimeError(
                "task 'wikitext' has no documents — dataset unavailable "
                "(datasets/network missing?)")
        if limit:
            texts = [t[: limit * 2048] for t in texts]
        lls = lm.loglikelihood_rolling([tokenize(t) for t in texts])
        words = sum(len(re.split(r"\s+", t)) for t in texts)
        bytes_ = sum(len(t.encode("utf-8")) for t in texts)
        total = sum(lls)
        return {"task": self.name,
                "word_perplexity": float(np.exp(-total / max(words, 1))),
                "byte_perplexity": float(np.exp(-total / max(bytes_, 1))),
                "bits_per_byte": float(-total / max(bytes_, 1) / np.log(2)),
                "n": len(texts)}


def general_detokenize(s: str) -> str:
    """Undo PTB-style tokenization spacing (lm-eval utils.py:62-69 semantics,
    re-derived): used by the GLUE sentence tasks below."""
    import re as _re
    s = s.replace(" n't", "n't").replace(" )", ")").replace("( ", "(")
    s = s.replace('" ', '"').replace(' "', '"')
    return _re.sub(r" (['.,])", r"\1", s)


MMLU_SUBJECTS = [
    "abstract_algebra", "anatomy", "astronomy", "business_ethics",
    "clinical_knowledge", "college_biology", "college_chemistry",
    "college_computer_science", "college_mathematics", "college_medicine",
    "college_physics", "computer_security", "conceptual_physics",
    "econometrics", "electrical_engineering", "elementary_mathematics",
    "formal_logic", "global_facts", "high_school_biology",
    "high_school_chemistry", "high_school_computer_science",
    "high_school_european_history", "high_school_geography",
    "high_school_government_and_politics", "high_school_macroeconomics",
    "high_school_mathematics", "high_school_microeconomics",
    "high_school_physics", "high_school_psychology",
    "high_school_statistics", "high_school_us_history",
    "high_school_world_history", "human_aging", "human_sexuality",
    "international_law", "jurisprudence", "logical_fallacies",
    "machine_learning", "management", "marketing", "medical_genetics",
    "miscellaneous", "moral_disputes", "moral_scenarios", "nutrition",
    "philosophy", "prehistory", "professional_accounting",
    "professional_law", "professional_medicine", "professional_psychology",
    "public_relations", "security_studies", "sociology",
    "us_foreign_policy", "virology", "world_religions",
]


class MMLU(MultipleChoiceTask):
    """Hendrycks MMLU, one task per subject (tasks/hendrycks_test.py:129-154:
    "Question: ...\\nChoices:\\nA. ...\\nAnswer:"; continuations are the
    choice TEXTS, not the letters)."""

    def __init__(self, subject: str):
        self.subject = subject
        self.name = f"hendrycksTest-{subject}"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        keys = ["A", "B", "C", "D"]
        out = []
        for d in rows:
            prompt = "Question: " + d["question"] + "\nChoices:\n"
            prompt += "".join(f"{k}. {c}\n" for k, c in zip(keys,
                                                            d["choices"]))
            prompt += "Answer:"
            gold = (keys.index(d["answer"]) if isinstance(d["answer"], str)
                    else int(d["answer"]))
            out.append(MCDoc(prompt, list(d["choices"]), gold))
        return out

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset(
                "cais/mmlu", self.subject, split="test"))
        return _hf_docs(load)

    def fewshot_docs(self):
        """5-shot examples come from the DEV split, like the reference
        (hendrycks_test.py:157-161 uses dev, not sampled test docs)."""
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset(
                "cais/mmlu", self.subject, split="dev"))
        return _hf_docs(load)


class RACE(MultipleChoiceTask):
    """RACE-high reading comprehension, collated ONE DOC PER ARTICLE with
    earlier questions answered inline (tasks/race.py:60-127 — the GPT-3
    paper's construction, not HF's per-question rows)."""
    name = "race"
    letter_to_num = {"A": 0, "B": 1, "C": 2, "D": 3}

    @classmethod
    def convert(cls, rows) -> list[MCDoc]:
        import collections
        by_article = collections.defaultdict(list)
        for r in rows:
            by_article[r["article"]].append(r)
        out = []
        for article, problems in by_article.items():
            text = "Article: " + article + "\n\n"
            for p in problems[:-1]:
                answer = p["options"][cls.letter_to_num[p["answer"]]]
                if p["question"][-6:] == "  _  .":
                    # cloze-style: splice the answer into the blank
                    # (race.py:107-110 uses question[-5:] verbatim)
                    text += p["question"][-5:] + answer + "\n"
                else:
                    text += ("Question: " + p["question"] + "\n"
                             + "Answer: " + answer + "\n")
            last = problems[-1]
            text += last["question"]
            out.append(MCDoc(text, list(last["options"]),
                             cls.letter_to_num[last["answer"]]))
        return out

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset("race", "high", split="test"))
        return _hf_docs(load)


class MathQA(MultipleChoiceTask):
    """Options parsed out of the "a ) ... , b ) ..." string
    (tasks/mathqa.py:52-64)."""
    name = "mathqa"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        import re as _re
        out = []
        for d in rows:
            gold = ["a", "b", "c", "d", "e"].index(d["correct"])
            choices = [c[4:].rstrip(" ,") for c in _re.findall(
                r"[abcd] \) .*?, |e \) .*?$", d["options"])]
            out.append(MCDoc("Question: " + d["Problem"] + "\nAnswer:",
                             choices, gold))
        return out

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset("math_qa", split="test"))
        return _hf_docs(load)


class PubMedQA(MultipleChoiceTask):
    """Abstract + question -> yes/no/maybe (tasks/pubmedqa.py:53-66)."""
    name = "pubmedqa"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        out = []
        for d in rows:
            ctxs = "\n".join(d["context"]["contexts"])
            prompt = "Abstract: {}\nQuestion: {}\nAnswer:".format(
                ctxs, d["question"])
            gold = ["yes", "no", "maybe"].index(d["final_decision"])
            out.append(MCDoc(prompt, ["yes", "no", "maybe"], gold))
        return out

    def docs(self):
        def load():
            from datasets import load_dataset
            # HF labels the eval rows "train" (pubmedqa.py:49-51)
            return self.convert(load_dataset(
                "pubmed_qa", "pqa_labeled", split="train"))
        return _hf_docs(load)


class ANLI(MultipleChoiceTask):
    """Adversarial NLI round r (tasks/anli.py:62-84: label order
    True/Neither/False)."""

    def __init__(self, round_: int):
        self.round = round_
        self.name = f"anli_r{round_}"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        return [MCDoc(d["premise"] + "\nQuestion: " + d["hypothesis"]
                      + " True, False, or Neither?\nAnswer:",
                      ["True", "Neither", "False"], int(d["label"]))
                for d in rows]

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset(
                "anli", split=f"test_r{self.round}"))
        return _hf_docs(load)


class MNLI(MultipleChoiceTask):
    """GLUE MNLI matched (tasks/glue.py:180-192); hypothesis gets a
    trailing period if missing."""
    name = "mnli"
    split = "validation_matched"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        out = []
        for d in rows:
            hyp = d["hypothesis"].strip()
            hyp += "" if hyp.endswith(".") else "."
            out.append(MCDoc("{}\nQuestion: {} True, False or Neither?"
                             "\nAnswer:".format(d["premise"], hyp),
                             ["True", "Neither", "False"], int(d["label"])))
        return out

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset("glue", "mnli",
                                             split=self.split))
        return _hf_docs(load)


class MNLIMismatched(MNLI):
    name = "mnli_mismatched"
    split = "validation_mismatched"


class QNLI(MultipleChoiceTask):
    """tasks/glue.py:245-258: 0 = entailment = "yes"."""
    name = "qnli"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        return [MCDoc("{}\n{}\nQuestion: Does this response answer the "
                      "question?\nAnswer:".format(d["question"],
                                                  d["sentence"]),
                      ["yes", "no"], int(d["label"])) for d in rows]

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset("glue", "qnli",
                                             split="validation"))
        return _hf_docs(load)


class QQP(MultipleChoiceTask):
    """tasks/glue.py:455-467: label 1 = duplicate = "yes"."""
    name = "qqp"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        return [MCDoc("Question 1: {}\nQuestion 2: {}\nQuestion: Do both "
                      "questions ask the same thing?\nAnswer:".format(
                          d["question1"], d["question2"]),
                      ["no", "yes"], int(d["label"])) for d in rows]

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset("glue", "qqp",
                                             split="validation"))
        return _hf_docs(load)


class MRPC(MultipleChoiceTask):
    """tasks/glue.py:403-415 (detokenized sentences)."""
    name = "mrpc"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        return [MCDoc("Sentence 1: {}\nSentence 2: {}\nQuestion: Do both "
                      "sentences mean the same thing?\nAnswer:".format(
                          general_detokenize(d["sentence1"]),
                          general_detokenize(d["sentence2"])),
                      ["no", "yes"], int(d["label"])) for d in rows]

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset("glue", "mrpc",
                                             split="validation"))
        return _hf_docs(load)


class SST(MultipleChoiceTask):
    """tasks/glue.py:124-139: positive/negative over the detokenized
    sentence."""
    name = "sst"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        return [MCDoc("{}\nQuestion: Is this sentence positive or negative?"
                      "\nAnswer:".format(general_detokenize(d["sentence"])),
                      ["negative", "positive"], int(d["label"]))
                for d in rows]

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset("glue", "sst2",
                                             split="validation"))
        return _hf_docs(load)


class WNLI(MultipleChoiceTask):
    """tasks/glue.py:298-311: 1 = entailment = "True"."""
    name = "wnli"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        return [MCDoc("{}\nQuestion: {} True or False?\nAnswer:".format(
            d["sentence1"], d["sentence2"]),
            ["False", "True"], int(d["label"])) for d in rows]

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset("glue", "wnli",
                                             split="validation"))
        return _hf_docs(load)


class CoLA(MultipleChoiceTask):
    """tasks/glue.py:70-93: yes/no over grammaticality, scored with
    Matthews correlation instead of accuracy."""
    name = "cola"

    @staticmethod
    def convert(rows) -> list[MCDoc]:
        return [MCDoc("{}\nQuestion: Does this sentence make sense?"
                      "\nAnswer:".format(d["sentence"]),
                      ["no", "yes"], int(d["label"])) for d in rows]

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset("glue", "cola",
                                             split="validation"))
        return _hf_docs(load)

    def _extra_metrics(self, preds: list) -> dict:
        # MCC from the confusion matrix of the single scored pass (the
        # reference scores each request once and derives both metrics,
        # tasks/glue.py:70-93 + metrics matthews_corrcoef)
        tp = tn = fp = fn = 0
        for d, pred in preds:
            if pred and d.gold:
                tp += 1
            elif pred and not d.gold:
                fp += 1
            elif not pred and d.gold:
                fn += 1
            else:
                tn += 1
        denom = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        return {"mcc": float((tp * tn - fp * fn) / denom) if denom else 0.0}


class WSC273:
    """Winograd Schema Challenge: the CONTEXT varies per choice (pronoun
    replaced by each option) and the TARGET (everything after the pronoun)
    is fixed — the reverse of the MC tasks (tasks/wsc273.py:69-142)."""

    name = "wsc273"
    upper_pronouns = ["A", "An", "The", "She", "He", "It", "They", "My",
                      "His", "Her", "Their"]

    @classmethod
    def convert(cls, rows) -> list[tuple[list[str], str, int]]:
        """-> [(contexts per option, fixed target, gold index)]"""
        out = []
        for d in rows:
            d = dict(d)
            d["text"] = d["text"].replace("  ", " ")
            opts = [cls._normalize(d, o) for o in d["options"]]
            ctxs = [d["text"][: d["pronoun_loc"]] + o for o in opts]
            start = d["pronoun_loc"] + len(d["pronoun"])
            target = " " + d["text"][start:].strip()
            out.append((ctxs, target, int(d["label"])))
        return out

    @classmethod
    def _normalize(cls, doc, option):
        if doc["pronoun"].lower() in ["my", "his", "her", "our", "their"]:
            option += "'s"
        pronoun = option.split()[0]
        start_of_sentence = doc["text"][doc["pronoun_loc"] - 2] == "."
        if not start_of_sentence and pronoun in cls.upper_pronouns:
            return option.replace(pronoun, pronoun.lower())
        return option

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset("winograd_wsc", "wsc273",
                                             split="test"))
        return _hf_docs(load)

    def evaluate(self, lm: MXQLM, tokenize, limit: Optional[int] = None
                 ) -> dict:
        docs = self.docs()
        if docs is None:
            raise RuntimeError(
                f"task {self.name!r} has no documents — dataset unavailable "
                "(datasets/network missing?)")
        docs = list(docs)
        if limit:
            docs = docs[:limit]
        reqs, spans = [], []
        for ctxs, target, gold in docs:
            start = len(reqs)
            for c in ctxs:
                reqs.append((tokenize(c), tokenize(target)))
            spans.append((start, len(reqs), gold))
        scores = lm.loglikelihood(reqs)
        acc = sum(
            int(np.argmax([scores[k][0] for k in range(s, e)]) == gold)
            for s, e, gold in spans)
        n = max(len(spans), 1)
        return {"task": self.name, "acc": acc / n, "n": n}


class TruthfulQAMC:
    """TruthfulQA multiple-choice with the fixed zero-shot QA_PROMPT and the
    mc1/mc2 metrics (tasks/truthfulqa.py:51-159)."""

    name = "truthfulqa_mc"
    QA_PROMPT = (
        "Q: What is human life expectancy in the United States?\n"
        "A: Human life expectancy in the United States is 78 years.\n\n"
        "Q: Who was president of the United States in 1955?\n"
        "A: Dwight D. Eisenhower was president of the United States in "
        "1955.\n\n"
        "Q: Which party did he belong to?\n"
        "A: He belonged to the Republican Party.\n\n"
        "Q: What is the square root of banana?\n"
        "A: I have no comment.\n\n"
        "Q: How does a telescope work?\n"
        "A: Telescopes use lenses or mirrors to focus light and make "
        "objects appear closer.\n\n"
        "Q: Where were the 1992 Olympics held?\n"
        "A: The 1992 Olympics were held in Barcelona, Spain."
    )

    @classmethod
    def convert(cls, rows):
        """-> [(context, mc1_choices, mc2_choices, mc2_split)] — mc1 gold is
        always index 0; mc2 labels are 1s then 0s, split at mc2_split."""
        out = []
        for d in rows:
            ctx = cls.QA_PROMPT + "\n\nQ: " + d["question"] + "\nA:"
            mc2_split = list(d["mc2_targets"]["labels"]).index(0)
            out.append((ctx, list(d["mc1_targets"]["choices"]),
                        list(d["mc2_targets"]["choices"]), mc2_split))
        return out

    def docs(self):
        def load():
            from datasets import load_dataset
            return self.convert(load_dataset(
                "truthful_qa", "multiple_choice", split="validation"))
        return _hf_docs(load)

    def evaluate(self, lm: MXQLM, tokenize, limit: Optional[int] = None
                 ) -> dict:
        docs = self.docs()
        if docs is None:
            raise RuntimeError(
                f"task {self.name!r} has no documents — dataset unavailable "
                "(datasets/network missing?)")
        docs = list(docs)
        if limit:
            docs = docs[:limit]
        reqs, spans = [], []
        for ctx, mc1, mc2, split in docs:
            start = len(reqs)
            for ch in mc1 + mc2:
                # " " + target with NO strip — the reference keeps targets
                # verbatim (tasks/truthfulqa.py:125)
                reqs.append((tokenize(ctx), tokenize(" " + ch)))
            spans.append((start, len(mc1), len(mc2), split))
        scores = lm.loglikelihood(reqs)
        m1 = m2 = 0.0
        for start, n1, n2, split in spans:
            lls1 = [scores[start + k][0] for k in range(n1)]
            m1 += float(np.argmax(lls1) == 0)
            lls2 = np.array([scores[start + n1 + k][0] for k in range(n2)])
            p = np.exp(lls2)
            m2 += float(p[:split].sum() / p.sum())
        n = max(len(spans), 1)
        return {"task": self.name, "mc1": m1 / n, "mc2": m2 / n, "n": n}


TASKS = {t.name: t for t in (PIQA(), Winogrande(), HellaSwag(), ArcEasy(),
                             ArcChallenge(), BoolQ(), SIQA(), OpenBookQA(),
                             COPA(), RTE(), SciQ(), SWAG(), CB(), WiC(),
                             LogiQA(), LambadaOpenAI(),
                             WikiTextRolling(),
                             RACE(), MathQA(), PubMedQA(),
                             MNLI(), MNLIMismatched(), QNLI(), QQP(),
                             MRPC(), SST(), WNLI(), CoLA(),
                             WSC273(), TruthfulQAMC(),
                             *(ANLI(r) for r in (1, 2, 3)),
                             *(MMLU(s) for s in MMLU_SUBJECTS))}
TASKS["obqa"] = TASKS["openbookqa"]      # pre-r5 alias (reference name wins)


# ---------------------------------------------------------------------------
# Reference request-stream reproduction (testdata cross-pinning)
# ---------------------------------------------------------------------------
#
# The reference pins request construction per task with 698 golden files
# (lm-evaluation-harness/tests/testdata/<task>-v0-loglikelihood = sha256 of
# the json-dumped request list). Reproducing those hashes closes the loop
# the offline fixtures cannot: a format error made while WRITING a fixture
# is pinned, not caught. Protocol (tests/test_version_stable.py +
# evaluator.py:203-231):
#   * docs = list(test_docs() if has_test else validation_docs()) in
#     dataset source order, then random.Random(42).shuffle
#   * zero-shot ctx = doc_to_text(doc); one (ctx, " " + choice) per choice
#     (base.py:604-617, vanilla MultipleChoiceTask construct_requests)
#   * hash = sha256(json.dumps(list_of_request_tuples, sort_keys=True))


def reference_loglikelihood_requests(task) -> "list[tuple[str, str]]":
    """The reference evaluator's loglikelihood request stream for a
    vanilla-MC task, from our MCDoc docs. Valid for task families whose
    reference class inherits MultipleChoiceTask without overriding
    construct_requests (arc, headqa, hellaswag, hendrycksTest, logiqa,
    mathqa, openbookqa, piqa, prost, qa4mre, sciq, swag, toxigen); our
    docs() must return the same split in source order (it does — the
    split audit is part of this feature)."""
    import random as _random
    docs = list(task.docs() or [])
    if not docs:
        raise RuntimeError(f"task {task.name!r}: dataset unavailable")
    rnd = _random.Random()
    rnd.seed(42)
    rnd.shuffle(docs)
    reqs = []
    for d in docs:
        for ch in d.choices:
            reqs.append((d.context, " " + ch))
    return reqs


def reference_request_hash(reqs: "list[tuple[str, str]]") -> str:
    """sha256 over the json-dumped request list — byte-identical to the
    reference's assert_target_hashed (tests/test_version_stable.py:30-46:
    ``hashlib.sha256(json.dumps(ob, sort_keys=True).encode()).hexdigest()``
    where ob is the list of (ctx, continuation) tuples)."""
    import hashlib
    import json as _json
    return hashlib.sha256(
        _json.dumps(reqs, sort_keys=True).encode("utf-8")).hexdigest()


def all_tasks() -> dict:
    """The full registry: core tasks + the extended families
    (tasks_ext.py — BLiMP, CrowS-Pairs, Pile, arithmetic, ethics,
    generation tasks, ...). Lazy so importing harness alone stays cheap."""
    from mxq_tpu_torch.eval import tasks_ext
    reg = dict(TASKS)
    reg.update(tasks_ext.TASKS_EXT)
    return reg


def evaluate(lm: MXQLM, tokenize, task_names: Sequence[str],
             limit: Optional[int] = None, tok=None,
             num_fewshot: int = 0) -> list[dict]:
    """Run the named tasks (evaluator.simple_evaluate analogue,
    evaluator.py:21-138). Raises if a task's dataset is unavailable rather
    than silently reporting accuracy over zero documents.

    ``tok`` is the real tokenizer (encode+decode); generation tasks
    (gsm8k, drop, translation, ...) require it and raise without it.
    ``num_fewshot`` prepends sampled labeled examples for tasks that
    support it (MC + generation families); tasks that are inherently
    zero-shot (BLiMP, Pile, CrowS-Pairs, TruthfulQA) raise if asked."""
    import inspect
    registry = all_tasks()
    results = []
    for name in task_names:
        task = registry[name]
        params = inspect.signature(task.evaluate).parameters
        kwargs = {}
        if tok is not None and "tok" in params:
            kwargs["tok"] = tok
        if num_fewshot:
            if "num_fewshot" not in params:
                raise RuntimeError(
                    f"task {name!r} is zero-shot only "
                    "(the reference asserts num_fewshot == 0 for it)")
            kwargs["num_fewshot"] = num_fewshot
        res = task.evaluate(lm, tokenize, limit, **kwargs)
        results.append(res)
    return results


# ---------------------------------------------------------------------------
# External lm-eval integration (when installed)
# ---------------------------------------------------------------------------


def make_lm_eval_model(params, cfg: llama.LlamaConfig, tokenizer,
                       batch_size: int = 8,
                       device: str | torch.device = "cuda"):
    """Wrap our model as an ``lm_eval.api.model.LM`` subclass if lm-eval is
    installed (pip package ``lm-eval``); raises ImportError otherwise."""
    from lm_eval.api.model import LM  # type: ignore

    inner = MXQLM(params, cfg, batch_size,
                  bos_id=getattr(tokenizer, "bos_token_id", None),
                  device=device)

    class _Wrapped(LM):
        def loglikelihood(self, requests):
            reqs = []
            enc = lambda s: np.asarray(      # noqa: E731
                tokenizer(s, add_special_tokens=False)["input_ids"])
            for r in requests:
                ctx, cont = r.args
                reqs.append((enc(ctx), enc(cont)))
            return inner.loglikelihood(reqs)

        def loglikelihood_rolling(self, requests):
            streams = [np.asarray(tokenizer(r.args[0])["input_ids"])
                       for r in requests]
            return inner.loglikelihood_rolling(streams)

        def generate_until(self, requests):
            outs = []
            for r in requests:
                ctx, gen_kwargs = r.args
                until = list(gen_kwargs.get("until", []))
                max_new = int(gen_kwargs.get("max_gen_toks", 128))
                ids = np.asarray(tokenizer(ctx)["input_ids"], np.int32)
                stops = [np.asarray(tokenizer(u, add_special_tokens=False)
                                    ["input_ids"]).tolist() for u in until]
                toks = inner.greedy_generate(ids, max_new, stops)
                text = tokenizer.decode(toks)
                for u in until:  # trim at the first stop string
                    i = text.find(u)
                    if i >= 0:
                        text = text[:i]
                outs.append(text)
            return outs

    return _Wrapped()
