"""Parameters as numpy trees: the bridge that lets ``mxq_tpu`` and this
port compute from the same weights, and lets one port model move between
devices.

A numpy tree is the parameter dict with numpy arrays for dense leaves and,
for each packed linear, a dict of its fields (``w2``, ``w4``, ``meta2``,
``qscale``, ``qmin``, ``smeta4`` arrays plus the ``in_features`` and
``out_features`` ints); a packed uniform-4b or -2b linear (``w``, ``s``,
``z`` and the two ints) is told apart by its shapes: ``w`` has 16 rows per
row of ``s`` at 4 bits, 8 at 2 bits. bf16 arrays are ``ml_dtypes.bfloat16`` (what
``np.asarray`` gives for a JAX bf16 array); they cross as their raw 16 bits.
:func:`pool_from_numpy` carries a paged KV pool across the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from mxq_tpu_torch import resolve_device
from mxq_tpu_torch.ops import uniform4
from mxq_tpu_torch.packfmt import FIELDS, PackedMXQLinear

_UNIFORM = (uniform4.PackedU4Linear, uniform4.PackedU2Linear)


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 comes back as ``ml_dtypes.bfloat16``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree, device: str | torch.device = "cuda"):
    """Numpy tree -> the port's params on ``device``: dense tensors, and a
    :class:`PackedMXQLinear` for every dict holding the packed fields."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        if "w2" in tree:
            return PackedMXQLinear(
                *(tensor_from_numpy(tree[f], dev) for f in FIELDS),
                in_features=int(tree["in_features"]),
                out_features=int(tree["out_features"]))
        if "z" in tree:
            rows = np.shape(tree["w"])[0] // np.shape(tree["s"])[0]
            cls = {16: uniform4.PackedU4Linear,
                   8: uniform4.PackedU2Linear}[rows]
            return cls(*(tensor_from_numpy(tree[f], dev) for f in "wsz"),
                       in_features=int(tree["in_features"]),
                       out_features=int(tree["out_features"]))
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return tensor_from_numpy(tree, dev)


def params_to_numpy(params):
    """Inverse of :func:`params_from_numpy`."""
    if isinstance(params, (PackedMXQLinear,) + _UNIFORM):
        fields = FIELDS if isinstance(params, PackedMXQLinear) else "wsz"
        out = {f: tensor_to_numpy(getattr(params, f)) for f in fields}
        out.update(in_features=params.in_features,
                   out_features=params.out_features)
        return out
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return tensor_to_numpy(params)


def params_to(params, device: str | torch.device):
    """The same parameters on another device (a copy)."""
    dev = resolve_device(device)
    if isinstance(params, (PackedMXQLinear, torch.Tensor) + _UNIFORM):
        return params.to(dev)
    return {k: params_to(v, dev) for k, v in params.items()}


def pool_from_numpy(pool, k_pages, v_pages):
    """Copy a paged KV pool given as numpy into ``pool`` (a
    ``serving.paged.PagedPool``) in place: ``k_pages``/``v_pages`` are the
    bf16 pages [KVH, L*P, ps, D], or for the int8 pool dicts of ``codes``
    (int8) and ``scales`` (bf16 [KVH, L*P, 1, ps]), as ``np.asarray`` gives
    them for ``mxq_tpu``'s pool. Shapes and types must match. Returns
    ``pool``."""
    def copy(dst: torch.Tensor, src):
        t = tensor_from_numpy(src, "cpu")
        if t.shape != dst.shape or t.dtype != dst.dtype:
            raise ValueError(f"pool array {t.dtype} {tuple(t.shape)} does "
                             f"not fit {dst.dtype} {tuple(dst.shape)}")
        dst.copy_(t)

    for dst, src in ((pool.k_pages, k_pages), (pool.v_pages, v_pages)):
        if isinstance(dst, dict):
            for name in ("codes", "scales"):
                copy(dst[name], src[name])
        else:
            copy(dst, src)
    return pool
