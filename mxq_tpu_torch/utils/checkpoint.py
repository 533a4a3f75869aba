"""Model artifacts on disk (port of ``mxq_tpu/utils/checkpoint.py``): dense
params (floating point or quant-dequantized) and packed params.

A checkpoint is a directory of two files:

* ``params.safetensors``: every tensor under its path in the params dict
  joined by dots (``embed_tokens``, ``layers.q_proj``); a packed linear
  stores its fields under its path (``layers.qkv_proj.w2``, ...).
* ``mxq_config.json``: ``config`` (the ``LlamaConfig`` fields, with the
  scheme's under ``scheme``) and ``packed`` (each packed linear's
  ``in_features`` and ``out_features``), the schema ``mxq_tpu`` writes.

``mxq_tpu`` keeps the tensors in an orbax ``state/`` directory instead, so
neither package reads the other's checkpoints; the JSON file is the same.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from mxq_tpu_torch import resolve_device
from mxq_tpu_torch.config import MXQConfig
from mxq_tpu_torch.models import llama
from mxq_tpu_torch.packfmt import FIELDS, PackedMXQLinear
from mxq_tpu_torch.utils import safetensors_io

TENSORS = "params.safetensors"
CONFIG = "mxq_config.json"


def _cfg_from_json(d: dict) -> llama.LlamaConfig:
    d = dict(d)
    d["scheme"] = MXQConfig(**d["scheme"])
    return llama.LlamaConfig(**d)


def _flatten(params: dict, prefix: str = ""):
    """(tensors by dotted path, packed meta by layer name)."""
    tensors, meta = {}, {}
    for k, v in params.items():
        path = prefix + k
        if isinstance(v, PackedMXQLinear):
            tensors.update({f"{path}.{f}": getattr(v, f) for f in FIELDS})
            meta[k] = {"in_features": v.in_features,
                       "out_features": v.out_features}
        elif isinstance(v, dict):
            t, m = _flatten(v, path + ".")
            tensors.update(t)
            meta.update(m)
        elif isinstance(v, torch.Tensor):
            tensors[path] = v
        else:
            raise TypeError(f"cannot save {path}: {type(v).__name__}")
    return tensors, meta


def save_params(path: str, params: dict, cfg: llama.LlamaConfig) -> None:
    """Write ``params`` (dense tensors and packed linears, on any device)
    and ``cfg`` to the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    tensors, meta = _flatten(params)
    safetensors_io.save_file(tensors, os.path.join(path, TENSORS))
    with open(os.path.join(path, CONFIG), "w") as f:
        json.dump({"config": dataclasses.asdict(cfg), "packed": meta}, f,
                  indent=2)


def load_params(path: str, device: str | torch.device = "cuda"
                ) -> tuple[llama.LlamaConfig, dict]:
    """``(cfg, params)`` of a checkpoint directory, on ``device``."""
    dev = resolve_device(device)
    with open(os.path.join(path, CONFIG)) as f:
        info = json.load(f)
    params: dict = {}
    for name, t in safetensors_io.iter_tensors(os.path.join(path, TENSORS)):
        *parents, leaf = name.split(".")
        node = params
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t.to(dev)
    for name, m in info["packed"].items():
        d = params["layers"][name]
        params["layers"][name] = PackedMXQLinear(
            *(d[f] for f in FIELDS), in_features=m["in_features"],
            out_features=m["out_features"])
    return _cfg_from_json(info["config"]), params
