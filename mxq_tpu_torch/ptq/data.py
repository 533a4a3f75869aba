"""Calibration and evaluation tokens (port of ``mxq_tpu/ptq/data.py``, the
reference's ``mxq_quant/lib/data.py``).

The reference's three corpora (wikitext2, c4, ptb) are read through the
``datasets`` package and a tokenizer when both are available; otherwise,
and always without a tokenizer, a deterministic synthetic Zipf corpus
salted per dataset name stands in, so nothing is downloaded. Its streams
equal ``mxq_tpu``'s for the same seeds (both draw from
``np.random.RandomState``). ``strict=True`` raises instead of falling
back.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

DATASETS = ("wikitext2", "c4", "ptb")


def synthetic_corpus(vocab_size: int, n_tokens: int,
                     seed: int = 0) -> np.ndarray:
    """Deterministic Zipf-distributed int32 token stream (a stand-in corpus
    with a realistic long tail)."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab_size + 1)
    p /= p.sum()
    return rng.choice(vocab_size, size=n_tokens, p=p).astype(np.int32)


def _dataset_salt(dataset: str) -> int:
    return sum(ord(c) for c in dataset) * 9973


def _tokenize(tokenizer, text: str) -> np.ndarray:
    return np.asarray(tokenizer(text)["input_ids"], dtype=np.int32)


def _load_wikitext2(tokenizer, split: str) -> Optional[np.ndarray]:
    if tokenizer is None:
        return None
    try:
        from datasets import load_dataset
        ds = load_dataset("wikitext", "wikitext-2-raw-v1", split=split)
        # the reference joins train with " " and test with "\n\n"
        joiner = " " if split == "train" else "\n\n"
        return _tokenize(tokenizer, joiner.join(ds["text"]))
    except Exception:
        return None


def _load_ptb(tokenizer, split: str) -> Optional[np.ndarray]:
    if tokenizer is None:
        return None
    try:
        from datasets import load_dataset
        ds = load_dataset("ptb_text_only", "penn_treebank", split=split)
        return _tokenize(tokenizer, "\n\n".join(ds["sentence"]))
    except Exception:
        return None


def _load_c4_docs(split: str) -> Optional[List[str]]:
    """C4 documents: the json shard named by MXQ_C4_TRAIN / MXQ_C4_VAL, or
    the hub shard."""
    env = {"train": "MXQ_C4_TRAIN", "validation": "MXQ_C4_VAL"}[split]
    try:
        from datasets import load_dataset
        path = os.environ.get(env)
        if path:
            ds = load_dataset("json", data_files=[path], split="train")
        else:
            files = {"train": "en/c4-train.00000-of-01024.json.gz",
                     "validation": "en/c4-validation.00000-of-00008.json.gz"}
            ds = load_dataset("allenai/c4", data_files={split: files[split]},
                              split=split)
        return list(ds["text"])
    except Exception:
        return None


def _corpus_tokens(dataset: str, tokenizer,
                   split: str) -> Optional[np.ndarray]:
    if tokenizer is None:
        return None
    if dataset == "wikitext2":
        return _load_wikitext2(tokenizer, split)
    if dataset == "ptb":
        # the reference evaluates ptb on the validation split
        return _load_ptb(tokenizer, "validation" if split == "test" else split)
    return None


def _check(dataset: str) -> None:
    if dataset not in DATASETS:
        raise ValueError(f"unknown dataset {dataset!r}; choose {DATASETS}")


def get_calibration_batch(nsamples: int, seqlen: int, *, tokenizer=None,
                          vocab_size: int = 32000, seed: int = 0,
                          dataset: str = "wikitext2",
                          strict: bool = False) -> np.ndarray:
    """[nsamples, seqlen] int32 calibration windows: random windows of the
    joined train corpus (wikitext2, ptb), or of random documents longer
    than seqlen (c4)."""
    _check(dataset)
    rng = np.random.RandomState(seed)
    if dataset == "c4" and tokenizer is not None:
        docs = _load_c4_docs("train")
        if docs is not None:
            out = np.empty((nsamples, seqlen), np.int32)
            for i in range(nsamples):
                for _ in range(10000):
                    toks = _tokenize(tokenizer,
                                     docs[rng.randint(0, len(docs))])
                    if len(toks) > seqlen:
                        break
                else:
                    raise RuntimeError("no c4 document longer than seqlen")
                j = (rng.randint(0, len(toks) - seqlen - 1)
                     if len(toks) > seqlen + 1 else 0)
                out[i] = toks[j:j + seqlen]
            return out
        if strict:
            raise RuntimeError("c4 dataset unavailable (set MXQ_C4_TRAIN)")
    tokens = _corpus_tokens(dataset, tokenizer, "train")
    if tokens is None:
        if strict:
            raise RuntimeError(f"{dataset} dataset unavailable")
        tokens = synthetic_corpus(vocab_size,
                                  max(nsamples * seqlen * 2, seqlen * 4 + 1),
                                  seed + _dataset_salt(dataset))
    out = np.empty((nsamples, seqlen), np.int32)
    for i in range(nsamples):
        j = rng.randint(0, len(tokens) - seqlen - 1)
        out[i] = tokens[j:j + seqlen]
    return out


def get_eval_tokens(*, tokenizer=None, vocab_size: int = 32000,
                    n_tokens: int = 2048 * 16, seed: int = 1,
                    dataset: str = "wikitext2", seqlen: int = 2048,
                    strict: bool = False) -> np.ndarray:
    """1-D token stream of the test (validation) split for stride-seqlen
    perplexity; c4 takes the first 1100 documents joined with " ", cut to
    256 * seqlen tokens."""
    _check(dataset)
    tokens = None
    if dataset == "c4" and tokenizer is not None:
        docs = _load_c4_docs("validation")
        if docs is not None:
            tokens = _tokenize(tokenizer, " ".join(docs[:1100]))[:256 * seqlen]
    else:
        tokens = _corpus_tokens(dataset, tokenizer, "test")
    if tokens is None:
        if strict:
            raise RuntimeError(f"{dataset} dataset unavailable")
        tokens = synthetic_corpus(vocab_size, n_tokens,
                                  seed + _dataset_salt(dataset))
    return tokens
