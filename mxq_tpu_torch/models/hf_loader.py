"""HuggingFace Llama checkpoint loader (port of
``mxq_tpu/models/hf_loader.py``): a local directory of ``config.json`` and
``model.safetensors`` (or shards listed in ``model.safetensors.index.json``)
into the port's params, linear weights transposed to ``[in, out]`` and
stacked per layer. The files are read by ``utils.safetensors_io``; nothing
is downloaded and neither ``transformers`` nor ``safetensors`` is needed.
Tied embeddings leave ``lm_head`` absent (``llama.lm_head`` then uses
``embed_tokens``).
"""

from __future__ import annotations

import json
import os

import torch

from mxq_tpu_torch import resolve_device
from mxq_tpu_torch.models import llama
from mxq_tpu_torch.utils import safetensors_io

_NORMS = ("input_layernorm", "post_attention_layernorm")


def load_config(path: str) -> llama.LlamaConfig:
    """The ``LlamaConfig`` of an HF ``config.json``."""
    with open(os.path.join(path, "config.json")) as f:
        c = json.load(f)
    return llama.LlamaConfig(
        vocab_size=c["vocab_size"],
        hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"],
        num_hidden_layers=c["num_hidden_layers"],
        num_attention_heads=c["num_attention_heads"],
        num_key_value_heads=c.get("num_key_value_heads",
                                  c["num_attention_heads"]),
        max_position_embeddings=c.get("max_position_embeddings", 2048),
        rms_norm_eps=c.get("rms_norm_eps", 1e-6),
        rope_theta=c.get("rope_theta", 10000.0),
        tie_word_embeddings=c.get("tie_word_embeddings", False),
    )


def _shard_files(path: str) -> list[str]:
    """The safetensors files of a checkpoint directory."""
    idx_file = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(idx_file):
        with open(idx_file) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
    else:
        shards = ["model.safetensors"]
    return [os.path.join(path, s) for s in shards]


def load_params(path: str, cfg: llama.LlamaConfig | None = None,
                dtype=torch.bfloat16,
                device: str | torch.device = "cuda"
                ) -> tuple[llama.LlamaConfig, dict]:
    """Load an HF Llama directory into ``(config, params)`` on ``device``,
    every tensor cast to ``dtype``. Each tensor goes to the device as it is
    read, into stacks allocated once."""
    dev = resolve_device(device)
    cfg = cfg or load_config(path)
    nl = cfg.num_hidden_layers
    stacks: dict[str, torch.Tensor] = {}
    filled = {}
    params: dict = {"layers": stacks}

    def put(name, idx, t):
        if name not in stacks:
            stacks[name] = torch.empty((nl,) + tuple(t.shape), dtype=dtype,
                                       device=dev)
            filled[name] = [False] * nl
        stacks[name][idx] = t
        filled[name][idx] = True

    for f in _shard_files(path):
        for name, t in safetensors_io.iter_tensors(f):
            if name == "model.embed_tokens.weight":
                params["embed_tokens"] = t.to(dev, dtype)
            elif name == "model.norm.weight":
                params["norm"] = t.to(dev, dtype)
            elif name == "lm_head.weight":
                params["lm_head"] = t.to(dev, dtype).T.contiguous()
            elif (name.startswith("model.layers.")
                  and name.endswith(".weight")):
                parts = name.split(".")
                idx = int(parts[2])
                if parts[4] in llama.LAYER_LINEARS:
                    put(parts[4], idx, t.to(dev, dtype).T)
                elif parts[3] in _NORMS:
                    put(parts[3], idx, t.to(dev, dtype))

    for name in llama.LAYER_LINEARS + _NORMS:
        missing = ([i for i, ok in enumerate(filled[name]) if not ok]
                   if name in filled else list(range(nl)))
        if missing:
            raise ValueError(f"{path}: no {name} for layers {missing}")
    for name in ("embed_tokens", "norm"):
        if name not in params:
            raise ValueError(f"{path}: no {name}")
    return cfg, params
