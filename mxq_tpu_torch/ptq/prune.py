"""Pruning (port of ``mxq_tpu/ptq/prune.py``; the Wanda side of the
reference, mxq_quant/lib/prune.py:17-324, layerwrapper.py,
weight_permutation.py): magnitude and Wanda masks, unstructured or n:m,
Wanda's alpha search, SparseGPT (OBS with error propagation), GPTQ-style
1-bit/4-bit quantization, the activation-order permutations and the
layer-sequential ``prune_model``.

Ranks use stable sorts, as ``jnp.argsort`` does, so ties rank alike. The
quantile is ``jnp.quantile``'s linear method computed from a sort along
one axis (``torch.quantile`` refuses inputs of more than 2^24 elements).
SparseGPT and GPTQ visit the input columns in a Python loop with the
reference's order of operations, each update confined to the columns
after the current one.
"""

from __future__ import annotations

import numpy as np
import torch

from mxq_tpu_torch import resolve_device, scheme
from mxq_tpu_torch.models import llama
from mxq_tpu_torch.ptq import calibrate

METHODS = ("wanda", "magnitude", "sparsegpt")


def quantile(x: torch.Tensor, q: float, dim: int | None = None
             ) -> torch.Tensor:
    """``jnp.quantile(x, q, axis=dim, keepdims=True)`` (linear
    interpolation, weights computed in f32); ``dim=None`` over all of
    ``x``, as a 0-dim tensor."""
    if dim is None:
        return quantile(x.reshape(-1), q, 0)[0]
    n = x.shape[dim]
    pos = np.float32(q) * np.float32(n - 1)
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = np.float32(pos - lo)
    w_lo = np.float32(1) - w_hi
    a = torch.sort(x, dim=dim).values
    lo, hi = (int(min(max(v, 0), n - 1)) for v in (lo, hi))
    return (a.narrow(dim, lo, 1) * float(w_lo)
            + a.narrow(dim, hi, 1) * float(w_hi))


def _nm_rank(metric: torch.Tensor, dim: int, descending: bool):
    """Rank of each entry within its group along ``dim`` (stable)."""
    order = torch.argsort(-metric if descending else metric, dim=dim,
                          stable=True)
    return torch.argsort(order, dim=dim, stable=True)


def _mask_from_metric(metric: torch.Tensor, sparsity: float, n: int,
                      m: int) -> torch.Tensor:
    """Keep-mask of ``metric`` [in, out] per output channel: n:m when
    ``n > 0`` (the n largest of every m consecutive inputs,
    prune.py:160-171), else the entries at or above the channel's
    ``sparsity`` quantile."""
    if n > 0:
        k, o = metric.shape
        rank = _nm_rank(metric.reshape(k // m, m, o), 1, descending=True)
        return (rank < n).reshape(k, o)
    return metric >= quantile(metric, sparsity, 0)


def magnitude_mask(w_io: torch.Tensor, sparsity: float = 0.5, n: int = 0,
                   m: int = 0) -> torch.Tensor:
    """Keep-mask by |W| (prune.py:111-131); ``w_io`` [in, out]."""
    return _mask_from_metric(w_io.abs(), sparsity, n, m)


def wanda_mask(w_io: torch.Tensor, col_sq: torch.Tensor,
               sparsity: float = 0.5, n: int = 0, m: int = 0
               ) -> torch.Tensor:
    """Wanda keep-mask, metric |W| * ||x_col||_2 (prune.py:177)."""
    return _mask_from_metric(w_io.abs() * torch.sqrt(col_sq)[:, None],
                             sparsity, n, m)


def wanda_mask_alpha(w_io: torch.Tensor, col_sq: torch.Tensor,
                     sparsity: float = 0.5, tol: float = 1e-3
                     ) -> torch.Tensor:
    """Wanda's alpha search (prune.py:103-110,194-215): each output channel
    prunes its smallest-metric inputs until their metric sums to ``alpha``
    of the channel's total, with ``alpha`` bisected in [0, 0.8] until the
    overall sparsity is within ``tol`` of the target. Returns the
    keep-mask [in, out]."""
    mt = (w_io.abs() * torch.sqrt(col_sq)[:, None]).T     # [out, in]
    sort_res = torch.sort(mt, dim=1).values
    tmp_metric = torch.cumsum(sort_res, dim=1)
    sum_before = mt.sum(dim=1)

    def given_alpha(alpha):
        cnt = (tmp_metric <= (sum_before * alpha)[:, None]).sum(dim=1)
        idx = torch.clamp(cnt - 1, 0, mt.shape[1] - 1)
        thres = torch.gather(sort_res, 1, idx[:, None])
        thres = torch.where((cnt == 0)[:, None],
                            torch.full_like(thres, -torch.inf), thres)
        prune = mt <= thres
        return prune, float(prune.float().mean())

    alpha, hist = 0.4, [0.0, 0.8]
    prune, cur = given_alpha(alpha)
    while abs(cur - sparsity) > tol and hist[1] - hist[0] >= tol:
        if cur > sparsity:
            alpha_new = (alpha + hist[0]) / 2.0
            hist[1] = alpha
        else:
            alpha_new = (alpha + hist[1]) / 2.0
            hist[0] = alpha
        alpha = alpha_new
        prune, cur = given_alpha(alpha)
    return ~prune.T


def check_sparsity(params: dict) -> float:
    """Fraction of zeros over the dense projection weights
    (prune.py:38-62)."""
    zeros = total = 0
    for name in llama.LAYER_LINEARS:
        w = params["layers"].get(name)
        if w is None:
            continue
        zeros += int((w == 0).sum())
        total += w.numel()
    return zeros / max(total, 1)


def act_order_permutation(diag_h: torch.Tensor) -> torch.Tensor:
    """Descending diag(H) column order (weight_permutation.py:41)."""
    return torch.argsort(-diag_h, stable=True)


def sparse_act_order_permutation(w_io: torch.Tensor, h: torch.Tensor,
                                 percdamp: float = 1.0) -> torch.Tensor:
    """2:4-aware activation order (weight_permutation.py:42-71): columns by
    descending sum_rows W^2 / diag(cholesky(inv(H_damped)))^2, then each
    position i of the first half with i % 4 in {2, 3} swapped with
    i + K/2 - 2, so every group of 4 keeps 2 strong candidates."""
    k = w_io.shape[0]
    dead, hc = scheme.damped_hinv_chol(h, percdamp)
    w = torch.where(dead[:, None], 0.0, w_io.float())    # [in, out]
    diag = torch.diagonal(hc)
    tmp = ((w ** 2) / (diag[:, None] ** 2)).sum(dim=1)
    perm = torch.argsort(-tmp, stable=True).cpu().numpy()
    out = perm.copy()
    half = k // 2
    for i in range(half):
        if i % 4 in (2, 3):
            out[i] = perm[i + half - 2]
            out[i + half - 2] = perm[i]
    return torch.from_numpy(out).to(w_io.device)


def sparsegpt_prune(w_io: torch.Tensor, h: torch.Tensor,
                    sparsity: float = 0.5, blocksize: int = 128,
                    percdamp: float = 0.01, n: int = 0, m: int = 0
                    ) -> torch.Tensor:
    """OBS pruning of the [in, out] weight ``w_io`` with Hessian ``h``
    [in, in] (sparsegpt.py:54-117): dampen H, take the upper Cholesky
    factor of its inverse, pick the mask by w^2 / diag^2 (n:m or the
    per-output ``sparsity`` quantile), then visit the inputs in order,
    zeroing the pruned weights and pushing their error into the later
    inputs. ``blocksize`` is the reference's and does not change the
    result. Works in f32; returns ``w_io``'s dtype."""
    k = w_io.shape[0]
    dead, hc = scheme.damped_hinv_chol(h, percdamp)
    # [in, out]: row j is the reference's input column j
    w = torch.where(dead[:, None], 0.0, w_io.float())
    diag = torch.diagonal(hc)
    metric = w ** 2 / diag[:, None] ** 2
    if n > 0:
        o = w.shape[1]
        rank = _nm_rank(metric.reshape(k // m, m, o), 1, descending=True)
        keep = (rank < n).reshape(k, o)
    else:
        keep = metric >= quantile(metric, sparsity, 0)
    for idx in range(k):
        row = w[idx]
        pruned = ~keep[idx]
        err = torch.where(pruned, row, 0.0) / hc[idx, idx]
        w[idx + 1:] -= hc[idx, idx + 1:, None] * err[None, :]
        w[idx] = torch.where(pruned, 0.0, row)
    return w.to(w_io.dtype)


def _gptq_block(w1: torch.Tensor, hinv1: torch.Tensor, sparsity: float,
                n: int, m: int, split_sign: bool) -> torch.Tensor:
    """One block of :func:`gptq_quantize_1b4b`: ``w1`` [out, cnt] with its
    block of the inverse Cholesky factor; returns the quantized block."""
    cnt = w1.shape[1]
    metric = w1 ** 2 / torch.diagonal(hinv1)[None, :] ** 2
    if n > 0:
        rank = _nm_rank(metric.reshape(w1.shape[0], cnt // m, m), 2,
                        descending=False)
        mask1 = (rank < n).reshape(w1.shape[0], cnt)    # lowest n of m
    else:
        mask1 = metric <= quantile(metric, sparsity)
    pos = mask1 & (w1 >= 0)
    neg = mask1 & (w1 < 0)
    if split_sign:                                      # sparsegpt.py:748
        avg_p = (w1.abs() * pos).sum(dim=1) / (pos.sum(dim=1) + 1e-9)
        avg_n = (w1.abs() * neg).sum(dim=1) / (neg.sum(dim=1) + 1e-9)
    else:                                               # sparsegpt.py:608
        avg_p = avg_n = ((w1.abs() * mask1).sum(dim=1)
                         / (mask1.sum(dim=1) + 1e-9))
    # 4-bit per-channel asymmetric params of the weights not at 1 bit,
    # zeros included (sparsegpt.py:615-619)
    w4 = w1 * ~mask1
    xmax = torch.clamp_min(w4.amax(dim=1), 0.0)
    xmin = torch.clamp_max(w4.amin(dim=1), 0.0)
    xmax = torch.where((xmax == 0) & (xmin == 0), 1.0, xmax)
    scale = scheme.div_const(xmax - xmin, 15.0)
    zero = torch.round(-xmin / scale)

    w1 = w1.clone()
    q1 = torch.zeros_like(w1)
    for i in range(cnt):
        col = w1[:, i]
        q4 = scale * (torch.clamp(torch.round(col / scale) + zero, 0.0, 15.0)
                      - zero)
        q = torch.where(pos[:, i], avg_p, torch.where(neg[:, i], -avg_n, q4))
        err = (col - q) / hinv1[i, i]
        w1[:, i + 1:] -= err[:, None] * hinv1[i, i + 1:][None, :]
        q1[:, i] = q
    return q1


def gptq_quantize_1b4b(w_io: torch.Tensor, h: torch.Tensor,
                       sparsity: float = 0.5, blocksize: int = 128,
                       percdamp: float = 0.01, n: int = 0, m: int = 0,
                       split_sign: bool = False) -> torch.Tensor:
    """GPTQ-style mixed 1-bit/4-bit quantization (sparsegpt.py:560-640,
    :720-800): per ``blocksize`` inputs, the low-saliency weights (OBS
    metric, fraction ``sparsity`` or the lowest n of m) become sign times
    the row's mean |w| (``split_sign``: separate positive and negative
    means), the rest 4-bit per-channel asymmetric, and each column's error
    propagates into the later columns. ``w_io`` [in, out], ``h`` [in, in];
    returns the quant-dequantized weight in ``w_io``'s dtype."""
    k = w_io.shape[0]
    dead, hc = scheme.damped_hinv_chol(h, percdamp)
    w = torch.where(dead[None, :], 0.0, w_io.T.float())   # [out, in]
    for i1 in range(0, k, blocksize):
        i2 = min(i1 + blocksize, k)
        w1_in = w[:, i1:i2]
        hinv1 = hc[i1:i2, i1:i2]
        q1 = _gptq_block(w1_in, hinv1, sparsity, n, m, split_sign)
        # the block's column errors from the triangular relation
        # Err1 @ triu(Hinv1) = W1_in - Q1 (sparsegpt.py:640)
        err1 = torch.linalg.solve_triangular(
            hinv1.T, (w1_in - q1).T, upper=False).T
        w[:, i1:i2] = q1
        if i2 < k:
            w[:, i2:] += -err1 @ hc[i1:i2, i2:]
    return w.T.to(w_io.dtype)


@torch.no_grad()
def prune_model(params: dict, cfg: llama.LlamaConfig, input_ids,
                method: str = "wanda", sparsity: float = 0.5, n: int = 0,
                m: int = 0, device: str | torch.device = "cuda") -> dict:
    """Layer-sequential pruning (prune.py:133-221): per layer, capture each
    linear's inputs, mask its weight, and run the pruned layer to produce
    the next layer's input. Returns params with pruned projections (the
    rest shared with ``params``)."""
    if method not in METHODS:
        raise ValueError(f"prune method must be one of {METHODS}, "
                         f"not {method!r}")
    dev = resolve_device(device)
    llama.check_params_device(params, dev)
    x, cos, sin, mask = calibrate.calibration_inputs(params, cfg, input_ids,
                                                     dev)
    stacked = params["layers"]
    out_layers = {k: (torch.empty_like(v) if k in llama.LAYER_LINEARS
                      else v) for k, v in stacked.items()}
    for i in range(cfg.num_hidden_layers):
        layer = {k: v[i] for k, v in stacked.items()}
        inputs = calibrate._layer_linear_inputs(x, layer, cfg, cos, sin,
                                                mask)
        hessians = {}
        for name in llama.LAYER_LINEARS:
            w = layer[name]
            if method == "magnitude":
                w = w * magnitude_mask(w, sparsity, n, m)
            elif method == "wanda":
                keep = wanda_mask(w, calibrate._col_sq(inputs[name]),
                                  sparsity, n, m)
                w = w * keep
            else:
                # q, k and v share their input and so their Hessian
                key = id(inputs[name])
                if key not in hessians:
                    flat = inputs[name].reshape(-1, w.shape[0]).float()
                    hessians[key] = (2.0 / flat.shape[0]) * (flat.T @ flat)
                    del flat
                w = sparsegpt_prune(w, hessians[key], sparsity, n=n, m=m)
            out_layers[name][i] = w
            layer[name] = out_layers[name][i]
        del inputs, hessians
        x = calibrate.layer_forward(x, layer, cfg, cos, sin, mask,
                                    x.shape[0])
    out = dict(params)
    out["layers"] = out_layers
    return out


def greedy_nearest_permutation(w_io, use_abs: bool = False) -> torch.Tensor:
    """Greedy nearest-neighbour column order (weight_permutation.py:4-24):
    normalise the columns, then repeatedly place the most correlated
    remaining column next. On the host, in float64."""
    wt = np.array(torch.as_tensor(w_io).detach().cpu().double().T)
    wt /= np.linalg.norm(wt, axis=-1, keepdims=True) + 1e-12
    dist = wt @ wt.T
    if use_abs:
        dist = np.abs(dist)
    n = len(wt)
    perm = np.arange(n)
    for i in range(n - 2):
        nearest = (i + 1) + int(np.argmax(dist[i, i + 1:]))
        j = i + 1
        dist[[j, nearest]] = dist[[nearest, j]]
        dist[:, [j, nearest]] = dist[:, [nearest, j]]
        perm[[j, nearest]] = perm[[nearest, j]]
    return torch.from_numpy(perm)


def spearman_permutation(w_io, use_abs: bool = False) -> torch.Tensor:
    """Spearman rank-correlation order (weight_permutation.py:36-39): the
    greedy nearest order of the per-column rank vectors."""
    w = torch.as_tensor(w_io).detach().cpu().numpy().T     # [out, in]
    rank = np.argsort(np.argsort(w, axis=0), axis=0).astype(np.float64)
    rank = rank - rank.mean(axis=0, keepdims=True)
    return greedy_nearest_permutation(torch.from_numpy(rank.T), use_abs)
