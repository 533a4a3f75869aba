"""Attention over bf16 (or float32) keys and values: K12, one-token decode
over the bf16 paged pool (``csrc/paged_attn_bf16.cu``), and K13, causal
attention from position 0, the forward of flash attention
(``csrc/flash_attn.cu``); their plain PyTorch versions and wrappers.

These replace the two upstream Pallas TPU kernels that ``mxq_tpu`` calls
from JAX's library: ``serving/paged.py`` ``paged_attend`` (:265) sends a
bf16 pool with head_dim % 128 == 0 to
``jax.experimental.pallas.ops.tpu.paged_attention`` (K12), and
``models/llama.py`` ``attention`` (:383-396) sends every prefill or
cache-less forward of 128+ tokens (``use_flash``) to
``jax.experimental.pallas.ops.tpu.flash_attention`` (K13). The backward of
flash attention (QAT's gradients) is not ported: under autograd the model
attends through PyTorch's SDPA (``models/llama.py``).

Each wrapper takes its plain version for tensors on the CPU and launches
its kernel for tensors on the card, where a failed launch raises.
"""

from __future__ import annotations

import math

import torch

from mxq_tpu_torch.ops import count_launch
from mxq_tpu_torch.ops.attn_int8 import reserve_tickets
from mxq_tpu_torch.scheme import div_const

NEG = torch.finfo(torch.float32).min
SPLIT_ROWS = 128    # history rows per block of K12 (paged_attn_bf16.cu CH)
GMAX = 16           # query heads per kv head K12 takes
HEAD_DIMS = (64, 128)


# ---------------------------------------------------------------------------
# K12: decode attention over the bf16 paged pool
# ---------------------------------------------------------------------------


def paged_decode_attention_plain(q, k_pages, v_pages, lengths, page_indices):
    """Plain version of K12 (``mxq_tpu``'s ``_paged_attend_reference``,
    serving/paged.py:301-318): gather each sequence's pages, f32 scores
    divided by sqrt(D), rows >= lengths[b] masked, f32 softmax, f32
    probabilities times f32 V, cast to q's type."""
    b, nh, d = q.shape
    kvh, _, ps, _ = k_pages.shape
    pps = page_indices.shape[1]
    idx = page_indices.long()
    # gather each sequence's pages -> [B, KVH, pps*ps, D]
    k = k_pages[:, idx].transpose(0, 1).reshape(b, kvh, pps * ps, d)
    v = v_pages[:, idx].transpose(0, 1).reshape(b, kvh, pps * ps, d)
    rep = nh // kvh
    k = torch.repeat_interleave(k, rep, dim=1).float()
    v = torch.repeat_interleave(v, rep, dim=1).float()
    scores = div_const(torch.einsum("bhd,bhsd->bhs", q.float(), k),
                       math.sqrt(d))
    pos = torch.arange(pps * ps, device=q.device)[None, None, :]
    scores = torch.where(pos < lengths[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", probs, v).to(q.dtype)


def _paged_scratch(b, hq, hkv, pps, ps, d, device):
    """K12's f32 scratch (each split's max, sum and partial context per
    (row, query head), one split per ``SPLIT_ROWS`` history rows) and the
    tickets of :func:`attn_int8.reserve_tickets`. Inside a captured chunk
    the scratch comes from the graph's pool, as K9-K11's does."""
    tickets = reserve_tickets(b * hkv, device)
    ws = torch.empty(b * hq * -(-pps * ps // SPLIT_ROWS) * (d + 2),
                     dtype=torch.float32, device=device)
    return ws, tickets


def _check(what, want):
    dev = want[0][1].device
    for name, t, dt, shape in want:
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{what} {name}: {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, contiguous={t.is_contiguous()}; "
                             f"want {dt} {shape} contiguous on {dev}")


def _paged_launch(q, k_pages, v_pages, lengths, page_indices):
    from mxq_tpu_torch import _build
    b, hq, d = q.shape
    hkv, lp, ps, _ = k_pages.shape
    pps = page_indices.shape[1]
    qf = q.float().contiguous()
    _check("K12", [("q", qf, torch.float32, (b, hq, d)),
                   ("k_pages", k_pages, torch.bfloat16, (hkv, lp, ps, d)),
                   ("v_pages", v_pages, torch.bfloat16, (hkv, lp, ps, d)),
                   ("lengths", lengths, torch.int32, (b,)),
                   ("page_indices", page_indices, torch.int32, (b, pps))])
    g = hq // hkv
    if hq % hkv or not 1 <= g <= GMAX or d not in HEAD_DIMS or pps < 1:
        raise ValueError(f"K12 takes D in {HEAD_DIMS}, 1..{GMAX} query heads "
                         f"per kv head and a table of >= 1 page, got D={d}, "
                         f"Hq={hq}, Hkv={hkv}, pages={pps}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("K12: the pages must start 16-byte aligned (the "
                         "kernel copies 16 bytes at once)")
    ws, tickets = _paged_scratch(b, hq, hkv, pps, ps, d, q.device)
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    err = _build.load("paged_attn_bf16").paged_attn_bf16(
        qf.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        lengths.data_ptr(), page_indices.data_ptr(), b, hkv, g, d, lp, ps,
        pps, math.sqrt(d), ws.data_ptr(), tickets.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "K12")
    return out


def paged_decode_attention(q, k_pages, v_pages, lengths, page_indices):
    """K12: one-token decode attention over one layer's pages of the bf16
    pool.

    q [B, Hq, D] (bf16 or float32); k/v_pages [KVH, LP, ps, D] bf16 (one
    layer's view or the whole folded pool); lengths [B] int32 (rows <
    lengths[b] are attended); page_indices [B, PPS] int32 physical page ids.
    Returns [B, Hq, D] in q's type. On the card the rows must be at least
    1 long (a row of length <= 0 gets zeros) and an engine reserves the
    tickets before it captures a chunk (``attn_int8.reserve_tickets``)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, lengths,
                                            page_indices)
    out = _paged_launch(q, k_pages, v_pages, lengths, page_indices)
    count_launch(paged_decode_attention)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# K13: causal attention from position 0 (flash attention's forward)
# ---------------------------------------------------------------------------


def flash_prefill_attention_plain(q, k, v):
    """Plain version of K13: ``mxq_tpu``'s einsum attention
    (models/llama.py:397-406) under the causal mask: f32 scores divided by
    sqrt(D), query row i over key rows j <= i, f32 softmax, probabilities
    in V's type, then the product with V; the result in q's type. q
    [B, T, Hq, D], k, v [B, >= T, Hkv, D] (rows < T are read)."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    k, v = k[:, :t], v[:, :t]
    if hkv != hq:
        k = torch.repeat_interleave(k, hq // hkv, dim=2)
        v = torch.repeat_interleave(v, hq // hkv, dim=2)
    qf = q.transpose(1, 2).float()
    kf = k.transpose(1, 2).float()
    vf = v.transpose(1, 2)
    scores = div_const(torch.einsum("bhtd,bhsd->bhts", qf, kf), math.sqrt(d))
    i = torch.arange(t, device=q.device)
    scores = scores + torch.where(i[None, :] <= i[:, None], 0.0, NEG)
    probs = torch.softmax(scores, dim=-1).to(vf.dtype)
    return torch.einsum("bhts,bhsd->bhtd", probs, vf).transpose(1, 2) \
        .to(q.dtype)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D] as the kernel reads it: heads and D contiguous, the
    batch and token strides and the start 16-byte aligned; a copy
    otherwise."""
    d, es = x.shape[-1], x.element_size()
    if (x.stride(-1) == 1 and x.stride(-2) == d
            and x.stride(0) * es % 16 == 0 and x.stride(1) * es % 16 == 0
            and x.data_ptr() % 16 == 0):
        return x
    return x.contiguous()


def flash_prefill_attention(q, k, v):
    """K13: causal attention from position 0, scale 1/sqrt(D).

    q [B, T, Hq, D]; k, v [B, S, Hkv, D] with S >= T (query row i sees key
    rows j <= i, so rows >= T are never read), one type, bfloat16 or
    float32; query head h reads kv head h // (Hq // Hkv) in place. Strided
    views (the fused qkv projection's slices) are read as they are.
    Returns [B, T, Hq, D] in q's type."""
    if q.device.type == "cpu":
        return flash_prefill_attention_plain(q, k, v)
    from mxq_tpu_torch import _build
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if (q.dtype not in (torch.bfloat16, torch.float32)
            or k.dtype != q.dtype or v.dtype != q.dtype
            or k.device != q.device or v.device != q.device
            or tuple(k.shape) != (b, s, hkv, d) or v.shape != k.shape
            or s < t or hq % hkv or d not in HEAD_DIMS):
        raise ValueError(
            f"K13 takes q [B, T, Hq, D], k, v [B, S >= T, Hkv, D] of one "
            f"type (bfloat16 or float32) on one device, D in {HEAD_DIMS}, "
            f"Hq a multiple of Hkv; got q {q.dtype} {tuple(q.shape)} on "
            f"{q.device}, k {k.dtype} {tuple(k.shape)} on {k.device}, v "
            f"{v.dtype} {tuple(v.shape)} on {v.device}")
    q, k, v = _rows(q), _rows(k), _rows(v)
    out = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    err = _build.load("flash_attn").flash_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), b, t, hq, hkv, d, int(q.dtype == torch.float32),
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "K13")
    count_launch(flash_prefill_attention)
    return out


paged_decode_attention.launches = 0
flash_prefill_attention.launches = 0
KERNELS = {"K12": paged_decode_attention, "K13": flash_prefill_attention}
