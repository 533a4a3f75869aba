"""Shared helpers of the tests that hold ``mxq_tpu_torch`` against
``mxq_tpu``: moving arrays and parameter trees from JAX to the port."""

from __future__ import annotations

import numpy as np
import torch

from mxq_tpu import packfmt as jpackfmt
from mxq_tpu.ops import uniform4 as juniform4
from mxq_tpu_torch import weights

# The suite runs in several worker processes on a few cores; one intra-op
# thread per process keeps torch's thread pools from spinning against
# each other (with one pool per core each, a worker's tiny ops ran 50x
# slower than alone).
torch.set_num_threads(1)


def to_torch(a) -> torch.Tensor:
    """A JAX or numpy array as a CPU tensor (bf16 by its raw bits)."""
    return weights.tensor_from_numpy(np.asarray(a), "cpu")


def to_numpy_tree(tree):
    """JAX params -> the numpy tree ``weights.params_from_numpy`` takes."""
    if isinstance(tree, jpackfmt.PackedMXQLinear):
        out = {f: np.asarray(getattr(tree, f)) for f in
               ("w2", "w4", "meta2", "qscale", "qmin", "smeta4")}
        out.update(in_features=tree.in_features,
                   out_features=tree.out_features)
        return out
    if isinstance(tree, (juniform4.PackedU4Linear, juniform4.PackedU2Linear)):
        return dict(w=np.asarray(tree.w), s=np.asarray(tree.s),
                    z=np.asarray(tree.z), in_features=tree.in_features,
                    out_features=tree.out_features)
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def port_params(jax_params):
    """The port's CPU params holding the same weights as ``jax_params``."""
    return weights.params_from_numpy(to_numpy_tree(jax_params), "cpu")


def bits(t: torch.Tensor) -> torch.Tensor:
    """Exact-comparison view: bf16 as its int16 bits, else the tensor."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def rel(a, b) -> float:
    """max |a - b| / max |b|."""
    a = a.float() if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a, np.float32))
    b = b.float() if isinstance(b, torch.Tensor) else torch.from_numpy(
        np.array(b, np.float32))
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
