"""Perplexity evaluation (port of ``mxq_tpu/eval/ppl.py``, the reference's
``mxq_quant/lib/eval.py:10-76``).

Protocol: split a 1-D token stream into non-overlapping ``seqlen``-token
windows (stride == seqlen), sum the shifted NLL (logits[:-1] against
ids[1:], log-softmax in f32) over the windows, and return
``exp(total / (n * (seqlen - 1)))``.
"""

from __future__ import annotations

import numpy as np
import torch

from mxq_tpu_torch import resolve_device
from mxq_tpu_torch.models import llama


def window_nll(params, ids: torch.Tensor, cfg: llama.LlamaConfig,
               device: str | torch.device = "cuda") -> torch.Tensor:
    """Sum of the shifted NLL over one [B, T] window batch, f32 scalar
    (``_window_nll``, mxq_tpu/eval/ppl.py:19-28)."""
    logits, _ = llama.forward(params, ids, cfg, device=device)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = ids[:, 1:].long()
    return -logp.gather(-1, tgt[..., None])[..., 0].sum()


def eval_ppl(params, cfg: llama.LlamaConfig, tokens: np.ndarray,
             seqlen: int = 2048, batch: int = 1,
             max_windows: int | None = None,
             device: str | torch.device = "cuda") -> float:
    """Stride-``seqlen`` perplexity of ``params`` (on ``device``) over a
    1-D token stream, ``batch`` windows per forward."""
    dev = resolve_device(device)
    n = len(tokens) // seqlen
    if max_windows is not None:
        n = min(n, max_windows)
    if n <= 0:
        raise ValueError(f"{len(tokens)} tokens make no window of {seqlen}")
    total, count = 0.0, 0
    with torch.inference_mode():
        for i in range(0, n, batch):
            b = min(batch, n - i)
            ids = torch.as_tensor(np.stack(
                [tokens[(i + j) * seqlen:(i + j + 1) * seqlen]
                 for j in range(b)]), device=dev)
            total += float(window_nll(params, ids, cfg, dev))
            count += b * (seqlen - 1)
    return float(np.exp(total / count))
