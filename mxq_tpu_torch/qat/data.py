"""QAT training data (port of ``mxq_tpu/qat/data.py``).

* :func:`chunked_dataset`: the token streams concatenated and cut into
  ``block_size`` chunks, the remainder dropped; labels are the inputs.
* :func:`read_jsonl_texts` and :func:`train_valid_split` (the first N
  entries validate).
* :func:`batches`: the chunks in the order of ``numpy.random.RandomState(
  seed).permutation``, one permutation per epoch, as ``mxq_tpu``'s.
* :func:`synthesize_corpus`: data made by the model itself: for each seed
  token 3-5 greedy tokens, then sampling to the full length, all sequences
  in lockstep through the cached ``llama.forward``.
* :func:`write_jsonl_chunk` and :func:`merge_chunks`: one worker's shard
  of generated sequences, and the shards joined into one corpus.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Sequence

import numpy as np
import torch

from mxq_tpu_torch import resolve_device
from mxq_tpu_torch.models import llama
from mxq_tpu_torch.scheme import div_const


def read_jsonl_texts(path: str, field: str = "text") -> list[str]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line)[field])
    return out


def train_valid_split(items: list, valid_size: int = 10000):
    """(train, valid): the first ``valid_size`` entries validate."""
    return items[valid_size:], items[:valid_size]


def chunked_dataset(token_streams: Sequence[np.ndarray],
                    block_size: int = 2048) -> np.ndarray:
    """The streams concatenated and cut to [N, block_size] int32, the
    trailing remainder dropped."""
    all_tokens = np.concatenate([np.asarray(t, np.int32)
                                 for t in token_streams])
    n = len(all_tokens) // block_size
    return all_tokens[: n * block_size].reshape(n, block_size)


def batches(data: np.ndarray, batch_size: int, seed: int = 0,
            epochs: int = 1,
            device: str | torch.device = "cuda") -> Iterator[dict]:
    """Batches of ``batch_size`` chunks (a partial last batch dropped), as
    int64 ``input_ids`` and ``labels`` [batch_size, block] on ``device``."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    for _ in range(epochs):
        order = rng.permutation(len(data))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            ids = torch.from_numpy(
                data[order[i:i + batch_size]].astype(np.int64)).to(dev)
            yield {"input_ids": ids, "labels": ids}


def greedy_lengths(num: int, lo: int, hi: int,
                   gen: torch.Generator) -> torch.Tensor:
    """The greedy prefix length of each of ``num`` sequences, uniform in
    [lo, hi], drawn first from ``gen``: positions 1 .. length-1 are
    greedy."""
    return torch.randint(lo, hi + 1, (num,), generator=gen,
                         device=gen.device)


@torch.no_grad()
def synthesize_corpus(params, cfg: llama.LlamaConfig,
                      seed_tokens: np.ndarray, length: int = 2048,
                      greedy_prefix_min: int = 3, greedy_prefix_max: int = 5,
                      temperature: float = 1.0, seed: int = 0,
                      device: str | torch.device = "cuda") -> np.ndarray:
    """For each seed token: ``greedy_prefix_min``-``greedy_prefix_max``
    greedy tokens, then tokens sampled at ``temperature`` to ``length``.
    The lengths and the samples come from one ``torch.Generator`` on the
    device seeded with ``seed`` (the draws differ from ``mxq_tpu``'s
    ``jax.random``; the greedy tokens do not). One decode step per
    position advances every sequence through an f32 cache; the tokens stay
    on the device and cross to the host once. Returns [num_seeds, length]
    int32."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = len(seed_tokens)
    greedy_len = greedy_lengths(b, greedy_prefix_min, greedy_prefix_max,
                                gen)
    caches = llama.init_cache(cfg, b, length, dtype=torch.float32,
                              device=dev)
    tok = torch.as_tensor(np.asarray(seed_tokens, np.int64),
                          device=dev)[:, None]
    toks = [tok]
    for pos in range(length - 1):
        logits, _ = llama.forward(params, tok, cfg, caches=caches,
                                  cache_pos=pos, device=dev)
        lg = logits[:, -1]
        greedy = lg.argmax(-1)
        # Gumbel-max: argmax(lg / T + Gumbel noise) samples softmax(lg / T)
        u = torch.rand(lg.shape, generator=gen, device=dev)
        sampled = (div_const(lg, temperature) - torch.log(-torch.log(
            u.clamp_min(torch.finfo(u.dtype).tiny)))).argmax(-1)
        tok = torch.where(pos + 1 < greedy_len, greedy, sampled)[:, None]
        toks.append(tok)
    return torch.cat(toks, dim=1).cpu().numpy().astype(np.int32)


def write_jsonl_chunk(path: str, sequences: np.ndarray,
                      detokenize=None) -> None:
    """One worker's shard: a ``{"text": ...}`` line per sequence (its
    tokens joined by spaces unless ``detokenize`` is given)."""
    with open(path, "w") as f:
        for seq in sequences:
            text = (detokenize(seq) if detokenize is not None
                    else " ".join(map(str, seq.tolist())))
            f.write(json.dumps({"text": text}) + "\n")


def merge_chunks(chunk_dir: str, out_path: str,
                 pattern: str = "gen.chunk") -> int:
    """Concatenate the shards of ``chunk_dir`` (names holding ``pattern``
    and ending in ``.jsonl``, in sorted order) into ``out_path``; returns
    the lines written."""
    n = 0
    with open(out_path, "w") as out:
        for name in sorted(os.listdir(chunk_dir)):
            if pattern in name and name.endswith(".jsonl"):
                with open(os.path.join(chunk_dir, name)) as f:
                    for line in f:
                        if line.strip():
                            out.write(line)
                            n += 1
    return n
