"""Attention over bf16 (or float32) keys and values: K12, one-token decode
over the bf16 paged pool (``csrc/paged_attn_bf16.cu``); K13, causal
attention from position 0, the forward of flash attention
(``csrc/flash_attn.cu``); and K13-bwd, its backward
(``csrc/flash_attn_bwd.cu``); their plain PyTorch versions and wrappers,
and :class:`FlashAttention`, K13 under autograd.

These replace the upstream Pallas TPU kernels that ``mxq_tpu`` calls from
JAX's library: ``serving/paged.py`` ``paged_attend`` (:265) sends a bf16
pool with head_dim % 128 == 0 to
``jax.experimental.pallas.ops.tpu.paged_attention`` (K12), and
``models/llama.py`` ``attention`` (:383-396) sends every prefill or
cache-less forward of 128+ tokens (``use_flash``) to
``jax.experimental.pallas.ops.tpu.flash_attention`` (K13), whose custom
VJP runs two more kernels when QAT differentiates it (K13-bwd: the dK/dV
and dQ ``pallas_call``s, flash_attention.py:1121 and :1456). The port's
model sends that attention under autograd to :class:`FlashAttention`.

Each wrapper takes its plain version for tensors on the CPU and launches
its kernel for tensors on the card, where a failed launch raises. The
kernels are templates at head_dim 64, 128 and 256; the wrappers run every
other D <= 256 at the next of them, and every D > 256 on a wide path
(upstream takes every D <= 128 and multiples of 128, ``mxq_tpu``'s XLA
attention and paged reference every D), zeros past D in their tiles:
K12 reads q, the pool's pages and its output at their width; K13 and
K13-bwd read bfloat16 q, k, v (and o, dO) in place and write the context
and the gradients at width D, by TMA where D % 8 == 0, else by the
producer warpgroup's cp.async (:func:`load_route`; only an odd D or a
view off 4 bytes takes zero-padded copies, :func:`pad_head_dim`). At D =
256 K13 and K13-bwd run smaller tiles (fewer keys a tile, fewer stages;
K13-bwd's items of 64 rows, its dK/dV kernel's two consumer warpgroups
each holding half of D's columns), and K12 takes at most 8 query heads a
launch. At float32, K13 and K13-bwd first run the split pass
(:func:`flash_split`'s kernel, inside the same launch), which writes the
inputs' bf16 hi and lo planes with zeros past D, so no padded copy is
made: the kernels then run the bf16 design's products three times
(hi.lo + lo.hi + hi.hi).

The wide path (D > 256) has sources of its own. K12's
(``csrc/paged_attn_bf16_wide.cu``) walks D in column chunks, an item per
(row, kv head, 256-row split, WIDE_CHUNK columns), each recomputing the
scores over all of D in the same order so that every chunk sees the same
softmax bits, q staged in shared memory (at most ``heads_per_launch``
heads a launch, WIDE_Q_FLOATS floats; one head a launch past that, its q
read in place). K13's and K13-bwd's (``csrc/flash_attn_wide.cu``) cut D
into ranges of 256 columns and give one work item (64 query rows of a
head; the dK/dV kernel 64 keys of a kv head) to a thread-block cluster
of a block per range (at most 8; past that, groups of 8 ranges): each
block's partial scores are summed over the
cluster in rank order, so S (and dP) is computed once per tile pair on
wgmma, and each block writes its range of the output. bf16 rows are read
in place by TMA where D % 8 == 0 (else from copies zero-padded to a
multiple of 8, :func:`wide_width`); float32 goes through the split pass
into planes of :func:`plane_width` columns. Launches count under the
same counters.
"""

from __future__ import annotations

import math

import torch

from mxq_tpu_torch.ops import count_launch
from mxq_tpu_torch.ops.attn_int8 import reserve_tickets
from mxq_tpu_torch.scheme import div_const

NEG = torch.finfo(torch.float32).min
SPLIT_ROWS = 256    # history rows per K12 work item (paged_attn_bf16.cu SPLIT)
GMAX = 16           # query heads per kv head of one K12 launch
GMAX_256 = 8        # and at the D = 256 template (paged_attn_bf16.cu)
HEAD_DIMS = (64, 128, 256)   # the kernels' head_dim templates
MAX_TILE = HEAD_DIMS[-1]     # D past it runs on the wide path
GMAX_WIDE = 8       # query heads of a K12 launch on the wide path
WIDE_Q_FLOATS = 32768   # and its q staged in shared memory: G * D floats
                        # (past it one head a launch, q read in place)
WIDE_CHUNK = 128    # columns of K12's context an item
WIDE_SLICE = 64     # columns of a TMA box (and the planes' unit)


def kernel_head_dim(d: int) -> int:
    """The width the kernels run a head_dim ``d`` at: the smallest of
    HEAD_DIMS that holds it, or past 256 ``d`` itself (the wide path,
    which reads rows at their width in column chunks)."""
    if d < 1:
        raise ValueError(f"the bf16 attention kernels take head_dim >= 1, "
                         f"got {d}")
    return next((w for w in HEAD_DIMS if d <= w), d)


def is_wide(w: int) -> bool:
    """Whether kernel width ``w`` (:func:`kernel_head_dim`) is the wide
    path's."""
    return w > MAX_TILE


def plane_width(d: int) -> int:
    """The width of the float32 path's hi and lo planes on the wide path:
    D rounded up to whole TMA boxes (zeros past D)."""
    return -(-d // WIDE_SLICE) * WIDE_SLICE


def wide_width(d: int) -> int:
    """The row width at which K13's and K13-bwd's wide path reads bf16
    inputs of head_dim ``d``: d itself where rows of d elements are whole
    16-byte units (what TMA reads), else d rounded up to a multiple of 8
    on zero-padded copies."""
    return -(-d // 8) * 8


def heads_per_launch(w: int) -> int:
    """The most query heads per kv head one K12 launch takes at width
    ``w``: GMAX, or GMAX_256 at 256 (a lane group's q and context
    registers grow with D); on the wide path GMAX_WIDE, fewer where their
    q would pass WIDE_Q_FLOATS, and one past WIDE_Q_FLOATS (the kernel
    then reads that head's q in place instead of staging it)."""
    if is_wide(w):
        return max(1, min(GMAX_WIDE, WIDE_Q_FLOATS // w))
    return GMAX if w <= 128 else GMAX_256


def pad_head_dim(x: torch.Tensor, w: int) -> torch.Tensor:
    """x [..., D] with zero columns up to ``w`` (one copy; x itself when D
    is w). Zero columns add nothing to q . k, and give zero context and
    zero dQ, dK and dV columns, so a head_dim D < w runs at w on padded
    copies (with 1/sqrt(D) of the true D) with the results sliced back to
    D. The kernels' tiles hold such zeros when they read rows in place;
    real copies are left only to K13 and K13-bwd on :func:`load_route`'s
    "copy" route (an odd D, a view off 4 bytes) and on their wide path at
    D % 8 != 0. The split pass's planes and the plain versions' tests pad
    the same way."""
    d = x.shape[-1]
    return x if d == w else torch.nn.functional.pad(x, (0, w - d))


# ---------------------------------------------------------------------------
# K12: decode attention over the bf16 paged pool
# ---------------------------------------------------------------------------


def paged_decode_attention_plain(q, k_pages, v_pages, lengths, page_indices,
                                 head_dim=None):
    """Plain version of K12 (``mxq_tpu``'s ``_paged_attend_reference``,
    serving/paged.py:301-318): gather each sequence's pages, f32 scores
    divided by sqrt(D), rows >= lengths[b] masked, f32 softmax, f32
    probabilities times f32 V, cast to q's type. ``head_dim``: the D of
    the scale, q's last dimension by default (zero-padded inputs give it
    their true D)."""
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
                       math.sqrt(head_dim or d))
    pos = torch.arange(pps * ps, device=q.device)[None, None, :]
    scores = torch.where(pos < lengths[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", probs, v).to(q.dtype)


def _paged_scratch(b, g, hkv, pps, ps, w, device):
    """K12's f32 scratch (each split's max, sum and partial context per
    (row, kv head, query head of the launch), one split per ``SPLIT_ROWS``
    history rows the table holds) and the tickets of
    :func:`attn_int8.reserve_tickets`. Inside a captured chunk the scratch
    comes from the graph's pool, as K9-K11's does."""
    tickets = reserve_tickets(b * hkv, device)
    ws = torch.empty(b * hkv * g * -(-pps * ps // SPLIT_ROWS) * (w + 2),
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


def _paged_check(q, k_pages, v_pages, lengths, page_indices):
    """K12's checks on its inputs (q bf16 or float32, contiguous): G, the
    query heads per kv head, or a ValueError."""
    b, hq, d = q.shape
    hkv, lp, ps, _ = k_pages.shape
    pps = page_indices.shape[1]
    qt = q.dtype if q.dtype in (torch.bfloat16, torch.float32) \
        else torch.float32
    _check("K12", [("q", q, qt, (b, hq, d)),
                   ("k_pages", k_pages, torch.bfloat16, (hkv, lp, ps, d)),
                   ("v_pages", v_pages, torch.bfloat16, (hkv, lp, ps, d)),
                   ("lengths", lengths, torch.int32, (b,)),
                   ("page_indices", page_indices, torch.int32, (b, pps))])
    if hq % hkv or pps < 1 or d < 1:
        raise ValueError(f"K12 takes D >= 1, Hq a multiple of Hkv and a "
                         f"table of >= 1 page, got D={d}, Hq={hq}, "
                         f"Hkv={hkv}, pages={pps}")
    return hq // hkv


def _paged_launch(q, k_pages, v_pages, lengths, page_indices, out, g0, g):
    """One K12 launch: query heads g0 .. g0 + g - 1 (g <=
    :func:`heads_per_launch`) of each kv
    head, q [B, Hq, D] bf16 or float32 contiguous read at its width D,
    the pages [Hkv, LP, ps, D] read in place, those heads of ``out``
    (shaped and typed as q) written."""
    from mxq_tpu_torch import _build
    b, hq, d = q.shape
    hkv, lp, ps, _ = k_pages.shape
    pps = page_indices.shape[1]
    w = kernel_head_dim(d)
    ws, tickets = _paged_scratch(b, g, hkv, pps, ps, w, q.device)
    name = "paged_attn_bf16_wide" if is_wide(w) else "paged_attn_bf16"
    err = getattr(_build.load(name), name)(
        q.data_ptr(), int(q.dtype == torch.float32), k_pages.data_ptr(),
        v_pages.data_ptr(), lengths.data_ptr(), page_indices.data_ptr(), b,
        hkv, hq // hkv, g0, g, w, d, lp, ps, pps, math.sqrt(d),
        ws.data_ptr(), tickets.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "K12")
    count_launch(paged_decode_attention)


def paged_decode_blocks(w: int, g: int) -> int:
    """Blocks of K12's kernel at template width ``w`` and ``g`` query
    heads a launch that one SM of the current card holds at once (the
    grid is this times the SMs, or the most items a call can have)."""
    import ctypes

    from mxq_tpu_torch import _build
    n = ctypes.c_int(0)
    _build.check(_build.load("paged_attn_bf16").paged_attn_bf16_blocks(
        w, g, ctypes.byref(n)), "K12 occupancy")
    return n.value


def paged_decode_attention(q, k_pages, v_pages, lengths, page_indices):
    """K12: one-token decode attention over one layer's pages of the bf16
    pool.

    q [B, Hq, D] (bf16 or float32); k/v_pages [KVH, LP, ps, D] bf16 (one
    layer's view or the whole folded pool); lengths [B] int32 (rows <
    lengths[b] are attended); page_indices [B, PPS] int32 physical page ids.
    Returns [B, Hq, D] in q's type. On the card the rows must be at least
    1 long (a row of length <= 0 gets zeros) and an engine reserves the
    tickets before it captures a chunk (``attn_int8.reserve_tickets``).
    The kernel reads q and writes the result in q's type at its width D
    (any D <= 256, run at the next of HEAD_DIMS with zeros past D in its
    tiles; any D > 256 on the wide path) and reads the pages in place:
    one launch a call, and one more per :func:`heads_per_launch` query
    heads of a kv head beyond the first, each counted."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, lengths,
                                            page_indices)
    q = q.contiguous()
    g = _paged_check(q, k_pages, v_pages, lengths, page_indices)
    out = torch.empty_like(q)
    per = heads_per_launch(kernel_head_dim(q.shape[-1]))
    for g0 in range(0, g, per):
        _paged_launch(q, k_pages, v_pages, lengths, page_indices, out, g0,
                      min(per, g - g0))
    return out


# ---------------------------------------------------------------------------
# K13: causal attention from position 0 (flash attention's forward)
# ---------------------------------------------------------------------------


def _causal_scores(q, k, head_dim=None):
    """The f32 scores [B, Hq, T, T] of q [B, T, Hq, D] against the first T
    rows of k [B, >= T, Hkv, D] (repeated to Hq heads), divided by
    sqrt(head_dim) (D by default), with the causal mask added (query row i
    over key rows j <= i)."""
    b, t, hq, d = q.shape
    k = k[:, :t]
    if k.shape[2] != hq:
        k = torch.repeat_interleave(k, hq // k.shape[2], dim=2)
    scores = div_const(torch.einsum("bhtd,bhsd->bhts", q.transpose(1, 2)
                                    .float(), k.transpose(1, 2).float()),
                       math.sqrt(head_dim or d))
    i = torch.arange(t, device=q.device)
    return scores + torch.where(i[None, :] <= i[:, None], 0.0, NEG)


def _flash_plain(q, k, v, head_dim=None):
    """The context of K13's plain version and the scores it came from."""
    t, hq = q.shape[1], q.shape[2]
    v = v[:, :t]
    if v.shape[2] != hq:
        v = torch.repeat_interleave(v, hq // v.shape[2], dim=2)
    vf = v.transpose(1, 2)
    scores = _causal_scores(q, k, head_dim)
    probs = torch.softmax(scores, dim=-1).to(vf.dtype)
    ctx = torch.einsum("bhts,bhsd->bhtd", probs, vf).transpose(1, 2) \
        .to(q.dtype)
    return ctx, scores


def flash_prefill_attention_plain(q, k, v, head_dim=None):
    """Plain version of K13: ``mxq_tpu``'s einsum attention
    (models/llama.py:397-406) under the causal mask: f32 scores divided by
    sqrt(D), query row i over key rows j <= i, f32 softmax, probabilities
    in V's type, then the product with V; the result in q's type. q
    [B, T, Hq, D], k, v [B, >= T, Hkv, D] (rows < T are read).
    ``head_dim``: the D of the scale, q's last dimension by default
    (zero-padded inputs give it their true D), here and in the other
    plain versions."""
    return _flash_plain(q, k, v, head_dim)[0]


def flash_attention_forward_plain(q, k, v, head_dim=None):
    """Plain version of K13 with its row log-sum-exp: the context of
    :func:`flash_prefill_attention_plain`, bit for bit, and lse [B, Hq, T]
    f32, the logsumexp of each row's masked scores in the units the
    backward recomputes them in (divided by sqrt(D))."""
    ctx, scores = _flash_plain(q, k, v, head_dim)
    return ctx, torch.logsumexp(scores, dim=-1)


def flash_attention_bwd_plain(q, k, v, o, lse, do, head_dim=None):
    """Plain version of K13-bwd, flash attention's backward as upstream's
    VJP computes it (flash_attention.py:254-318, :796-939, :1146-1285):
    di = rowsum(o . dO) in f32, p = exp(s - lse) over the masked scores s
    of :func:`_causal_scores`, dV = p^T . dO with p in dO's type, dP = dO .
    V^T, dS = (dP - di) * p / sqrt(D), dK = dS^T . Q and dQ = dS . K with
    dS in the input type, every product in f32. Takes the shapes and
    strides of :func:`flash_prefill_attention_plain` with o and dO [B, T,
    Hq, D] and lse [B, Hq, T] f32; returns dq [B, T, Hq, D] and dk, dv
    shaped like k, v (summed over each kv head's query heads; rows >= T
    zero), in q's type."""
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    kf, vf = k[:, :t], v[:, :t]
    if g > 1:
        kf = torch.repeat_interleave(kf, g, dim=2)
        vf = torch.repeat_interleave(vf, g, dim=2)
    qf, kf, vf, of, dof = (a.transpose(1, 2).float()
                           for a in (q, kf, vf, o, do))
    di = (of * dof).sum(-1)                                  # [B, Hq, T]
    p = torch.exp(_causal_scores(q, k, head_dim) - lse[..., None])
    dv = torch.einsum("bhts,bhtd->bhsd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bhtd,bhsd->bhts", dof, vf)
    ds = ((dp - di[..., None]) * p * (1.0 / math.sqrt(head_dim or d))) \
        .to(q.dtype).float()
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kf)
    dk = torch.einsum("bhts,bhtd->bhsd", ds, qf)
    dk, dv = (x.view(b, hkv, g, t, d).sum(2).transpose(1, 2)
              for x in (dk, dv))
    if s > t:
        dk, dv = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, s - t))
                  for x in (dk, dv))
    return (dq.transpose(1, 2).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


def flash_split_plain(x: torch.Tensor, w: int):
    """Plain version of the split pass (``csrc/flash_split.cuh``): float32
    x [B, T, H, D] -> bf16 planes hi = bf16(x) and lo = bf16(x - hi),
    each [B, T, H, w] with zeros in columns D .. w. x = hi + lo to about
    16 significant bits (|x - hi - lo| <= 2^-16 |x|)."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return pad_head_dim(hi, w), pad_head_dim(lo, w)


def split_plane_elems(b, t, hq, hkv, w, backward=False) -> int:
    """The bf16 elements of the planes K13 (or, with ``backward``, K13-bwd)
    takes at float32: hi and lo of q, k and v (and dO), each [B, T, H, w];
    k's and v's first T rows only."""
    return 2 * b * t * w * ((2 if backward else 1) * hq + 2 * hkv)


def flash_split(x: torch.Tensor, w: int):
    """The split pass alone (the kernel K13 and K13-bwd launch first at
    float32): float32 x [B, T, H, D] (heads and D contiguous, any batch and
    token strides) -> (hi, lo), bf16 [B, T, H, w] each, zeros past D, the
    bits of :func:`flash_split_plain`. It runs inside K13's and K13-bwd's
    launches and counts none of its own."""
    if x.device.type == "cpu":
        return flash_split_plain(x, w)
    from mxq_tpu_torch import _build
    b, t, h, d = x.shape
    if x.dtype != torch.float32 or not 1 <= d <= w or w not in HEAD_DIMS:
        raise ValueError(f"the split pass takes float32 [B, T, H, D], D <= "
                         f"w in {HEAD_DIMS}; got {x.dtype} {tuple(x.shape)}, "
                         f"w={w}")
    x = _rows(x)
    planes = torch.empty((2, b, t, h, w), dtype=torch.bfloat16,
                         device=x.device)
    err = _build.load("flash_attn").flash_split(
        x.data_ptr(), x.stride(0), x.stride(1), planes.data_ptr(), b, t, h,
        d, w, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "K13 split pass")
    return planes[0], planes[1]


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D] as the kernels read it (the bf16 tensor maps, the
    split pass's 16-byte loads, the wide path's 16-byte copies): heads
    and D contiguous, the batch and token strides and the start 16-byte
    aligned; else a copy into new contiguous rows (a contiguous view that
    starts off 16 bytes is copied too; where D is not a multiple of 4 the
    split pass reads a float at a time)."""
    d, es = x.shape[-1], x.element_size()
    if (x.stride(-1) == 1 and x.stride(-2) == d
            and x.stride(0) * es % 16 == 0 and x.stride(1) * es % 16 == 0
            and x.data_ptr() % 16 == 0):
        return x
    return torch.empty(x.shape, dtype=x.dtype, device=x.device).copy_(x)


def _head_rows(x: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D] with heads and D contiguous, as the bf16 kernels
    read rows in place: x itself, or (a transposed view, say) a copy into
    new contiguous rows of its width."""
    if x.stride(-1) == 1 and x.stride(-2) == x.shape[-1]:
        return x
    return x.contiguous()


def _aligned(x: torch.Tensor, nbytes: int) -> bool:
    """Whether rows x [B, S, H, D] (heads and D contiguous) start and step
    (batch, token and head strides) on multiples of ``nbytes``."""
    es = x.element_size()
    return (x.data_ptr() % nbytes == 0 and x.stride(0) * es % nbytes == 0
            and x.stride(1) * es % nbytes == 0
            and x.shape[-1] * es % nbytes == 0)


def load_route(d: int, tensors) -> str:
    """How K13 and K13-bwd read bf16 tensors [B, S, H, d] of head_dim d <=
    256 (q, k, v; and o, dO for the backward): "tma", by tensor maps, where
    a row of d is whole 16-byte units (d % 8 == 0) and every tensor's start
    and batch and token strides are 16-byte aligned; "cp_async", by the
    producer warpgroup's cp.async of :func:`cp_async_bytes` each, where d is
    even and they are 4-byte aligned (open_llama_3b's d = 100: a head
    stride of 200 bytes, which TMA refuses); else "copy" (an odd d, a start
    off 4 bytes, heads and d not contiguous): zero-padded copies at the
    template width. Each route but "copy" reads the rows in place and
    leaves zeros past d in the kernels' tiles."""
    if any(x.stride(-1) != 1 or x.stride(-2) != d for x in tensors):
        return "copy"
    if d % 8 == 0 and all(_aligned(x, 16) for x in tensors):
        return "tma"
    if d % 2 == 0 and all(_aligned(x, 4) for x in tensors):
        return "cp_async"
    return "copy"


def cp_async_bytes(d: int, tensors) -> int:
    """The bytes of each cp.async on the "cp_async" route: 8 where d % 4 ==
    0 and every tensor is 8-byte aligned (:func:`load_route`), else 4."""
    return 8 if d % 4 == 0 and all(_aligned(x, 8) for x in tensors) else 4


def _bf16_loads(d: int, w: int, tensors):
    """The bf16 tensors as K13 and K13-bwd read them: (tensors, the
    head_dim the kernels take, the C entries' ``load``: 0 TMA, 8 or 4
    cp.async bytes). Rows are read in place at width d (a view whose heads
    and d are not contiguous first copied into contiguous rows); only on
    the "copy" route of :func:`load_route` are they zero-padded copies at
    width w, which the kernels then take as their head_dim."""
    tensors = [_head_rows(x) for x in tensors]
    route = load_route(d, tensors)
    if route == "copy":
        return [_rows(pad_head_dim(x, w)) for x in tensors], w, 0
    return tensors, d, (cp_async_bytes(d, tensors) if route == "cp_async"
                        else 0)


def _flash_check(what, q, k, v):
    """K13's and K13-bwd's checks on q, k, v; the kernels' head_dim
    (:func:`kernel_head_dim`) or a ValueError."""
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if (q.dtype not in (torch.bfloat16, torch.float32)
            or k.dtype != q.dtype or v.dtype != q.dtype
            or k.device != q.device or v.device != q.device
            or tuple(k.shape) != (b, s, hkv, d) or v.shape != k.shape
            or s < t or hq % hkv or d < 1):
        raise ValueError(
            f"{what} takes q [B, T, Hq, D], k, v [B, S >= T, Hkv, D] of one "
            f"type (bfloat16 or float32) on one device, D >= 1, Hq a "
            f"multiple of Hkv; got q {q.dtype} "
            f"{tuple(q.shape)} on {q.device}, k {k.dtype} {tuple(k.shape)} "
            f"on {k.device}, v {v.dtype} {tuple(v.shape)} on {v.device}")
    return kernel_head_dim(d)


def _k13_launch(q, k, v, lse):
    """K13 on the card; ``lse`` [B, Hq, T] f32 receives the row
    log-sum-exp, or None (the kernel writes none). A head_dim D that is not
    one of HEAD_DIMS runs at the next one with zeros past D in the kernel's
    tiles: bfloat16 rows read in place (:func:`_bf16_loads`), float32 on
    the split pass's planes; the output is written at width D."""
    from mxq_tpu_torch import _build
    w = _flash_check("K13", q, k, v)
    if is_wide(w):
        return _k13_wide_launch(q, k, v, lse)
    b, t, hq, d = q.shape
    f32 = q.dtype == torch.float32
    planes = None
    dw, load = d, 0                     # the output's width
    if f32:
        q, k, v = (_rows(x) for x in (q, k, v))
        planes = torch.empty(split_plane_elems(b, t, hq, k.shape[2], w),
                             dtype=torch.bfloat16, device=q.device)
    else:
        (q, k, v), dw, load = _bf16_loads(d, w, (q, k, v))
    out = torch.empty((b, t, hq, dw), dtype=q.dtype, device=q.device)
    err = _build.load("flash_attn").flash_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), v.stride(0), v.stride(1), b, t, hq,
        k.shape[2], w, dw, int(f32), load, 1.0 / math.sqrt(d),
        None if planes is None else planes.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "K13")
    count_launch(flash_prefill_attention)
    return out if dw == d else out[..., :d].contiguous()


def _k13_wide_launch(q, k, v, lse):
    """K13's wide path (D > 256, ``csrc/flash_attn_wide.cu``): bf16 rows
    read in place by TMA (:func:`_rows`; at D % 8 != 0 zero-padded copies
    of :func:`wide_width` columns), float32 through the split pass's
    planes of :func:`plane_width` columns; the output [B, T, Hq, D] at
    its width."""
    from mxq_tpu_torch import _build
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    f32 = q.dtype == torch.float32
    w = d if f32 else wide_width(d)
    q, k, v = (_rows(pad_head_dim(x, w)) for x in (q, k, v))
    planes = torch.empty(split_plane_elems(b, t, hq, hkv, plane_width(d)),
                         dtype=torch.bfloat16, device=q.device) if f32 \
        else None
    out = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    err = _build.load("flash_attn_wide").flash_attn_wide(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), v.stride(0), v.stride(1), b, t, hq, hkv, w,
        d, int(f32), 1.0 / math.sqrt(d),
        None if planes is None else planes.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "K13")
    count_launch(flash_prefill_attention)
    return out


def flash_prefill_attention(q, k, v):
    """K13: causal attention from position 0, scale 1/sqrt(D).

    q [B, T, Hq, D]; k, v [B, S, Hkv, D] with S >= T (query row i sees key
    rows j <= i, so rows >= T are never read), one type, bfloat16 or
    float32, any D >= 1; query head h reads kv head h // (Hq // Hkv) in
    place. Strided views (the fused qkv projection's slices) are read as
    they are. Returns [B, T, Hq, D] in q's type."""
    if q.device.type == "cpu":
        return flash_prefill_attention_plain(q, k, v)
    return _k13_launch(q, k, v, None)


def flash_attention_forward(q, k, v):
    """K13 with its row log-sum-exp, the forward :class:`FlashAttention`
    saves for its backward: (ctx, lse [B, Hq, T] f32). The context has the
    bits of :func:`flash_prefill_attention` on the same inputs; a launch
    counts as K13's."""
    if q.device.type == "cpu":
        return flash_attention_forward_plain(q, k, v)
    b, t, hq, _ = q.shape
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    return _k13_launch(q, k, v, lse), lse


def _bwd_scratch(lib, b, t, hq, hkv, w, f32, device):
    """K13-bwd's f32 scratch and tickets, as the library sizes them for
    this card and type (``flash_attn_bwd_scratch``): the row log-sum-exp
    and di that the dQ kernel (bf16) or the split pass (float32) writes
    for the dK/dV kernel, and, where a kv head's query heads are split
    over blocks, the partial dK and dV and one ticket per (key tile, kv
    head, batch row)."""
    import ctypes
    sizes = (ctypes.c_longlong * 4)()
    err = lib.flash_attn_bwd_scratch(b, t, hq, hkv, w, f32, sizes)
    if err:
        raise RuntimeError(f"K13-bwd: CUDA error {err} sizing its scratch")
    ws = torch.empty(sizes[0], dtype=torch.float32, device=device)
    tickets = reserve_tickets(sizes[1], device) if sizes[1] else None
    return ws, tickets


def flash_attention_backward(q, k, v, o, lse, do):
    """K13-bwd: the gradients of K13 (``csrc/flash_attn_bwd.cu``, its dQ
    kernel then its dK/dV kernel; one launch counted per call).

    q, k, v as :func:`flash_prefill_attention` took them, o its output,
    lse from :func:`flash_attention_forward`, do the output's gradient
    [B, T, Hq, D] (any strides). Returns dq [B, T, Hq, D] and dk, dv shaped
    like k, v (summed over each kv head's query heads; rows >= T zero), in
    q's type. di = rowsum(o . dO): at bf16 the dQ kernel computes it from
    the o and dO tiles it loads; at float32 the split pass computes it in
    f32 from o and dO as it splits q, k, v and dO into their bf16 hi and
    lo planes. A head_dim that is not one of HEAD_DIMS runs at the next
    one with zeros past D in the kernels' tiles (bfloat16 rows read in
    place, :func:`_bf16_loads`; float32 on the planes) and the gradients
    written at width D; past 256 on the wide path (a pass of its own
    computes di over all of D)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do)
    from mxq_tpu_torch import _build
    w = _flash_check("K13-bwd", q, k, v)
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if (tuple(o.shape) != (b, t, hq, d) or do.shape != o.shape
            or o.dtype != q.dtype or do.dtype != q.dtype
            or lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, t)
            or not lse.is_contiguous()
            or any(x.device != q.device for x in (o, lse, do))):
        raise ValueError(
            f"K13-bwd takes o and do [B, T, Hq, D] in q's type and lse "
            f"[B, Hq, T] float32 contiguous, on q's device; got o {o.dtype} "
            f"{tuple(o.shape)}, do {do.dtype} {tuple(do.shape)}, lse "
            f"{lse.dtype} {tuple(lse.shape)} for q {q.dtype} "
            f"{tuple(q.shape)}")
    if is_wide(w):
        return _k13_bwd_wide_launch(q, k, v, o, lse, do)
    f32 = int(q.dtype == torch.float32)
    planes = None
    dw, load = d, 0                     # the gradients' width
    if f32:
        q, k, v, o, do = (_rows(x) for x in (q, k, v, o, do))
        planes = torch.empty(split_plane_elems(b, t, hq, hkv, w, True),
                             dtype=torch.bfloat16, device=q.device)
    else:
        (q, k, v, o, do), dw, load = _bf16_loads(d, w, (q, k, v, o, do))
    lib = _build.load("flash_attn_bwd")
    ws, tickets = _bwd_scratch(lib, b, t, hq, hkv, w, f32, q.device)
    dq = torch.empty((b, t, hq, dw), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, hkv, dw), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if s > t:
        dk[:, t:].zero_()
        dv[:, t:].zero_()
    ptr = (lambda x: None if x is None else x.data_ptr())
    err = lib.flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), ptr(planes), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), ptr(ws), ptr(tickets), q.stride(0),
        q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        o.stride(0), o.stride(1), do.stride(0), do.stride(1), s * hkv * dw,
        b, t, hq, hkv, w, dw, f32, load, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "K13-bwd")
    count_launch(flash_attention_backward)
    if dw != d:
        dq, dk, dv = (x[..., :d].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv


def _k13_bwd_wide_launch(q, k, v, o, lse, do):
    """K13-bwd's wide path (D > 256, ``csrc/flash_attn_wide.cu``): the di
    pass, at float32 the split pass, then the dQ and the dK/dV kernels;
    bf16 rows read in place (as :func:`_k13_wide_launch` reads them; o
    read at its width by the di pass)."""
    from mxq_tpu_torch import _build
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    f32 = int(q.dtype == torch.float32)
    w = d if f32 else wide_width(d)
    q, k, v, do = (_rows(pad_head_dim(x, w)) for x in (q, k, v, do))
    o = _rows(o)
    planes = torch.empty(split_plane_elems(b, t, hq, hkv, plane_width(d),
                                           True),
                         dtype=torch.bfloat16, device=q.device) if f32 \
        else None
    ws = torch.empty(2 * b * hq * t, dtype=torch.float32, device=q.device)
    dq = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, hkv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if s > t:
        dk[:, t:].zero_()
        dv[:, t:].zero_()
    err = _build.load("flash_attn_wide").flash_attn_bwd_wide(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(),
        None if planes is None else planes.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), ws.data_ptr(), q.stride(0),
        q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        o.stride(0), o.stride(1), do.stride(0), do.stride(1), s * hkv * d,
        b, t, hq, hkv, w, d, f32, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "K13-bwd")
    count_launch(flash_attention_backward)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K13 under autograd: the forward is :func:`flash_attention_forward`
    (K13 with its lse), the backward :func:`flash_attention_backward`
    (K13-bwd), each its plain version on the CPU; ``apply(q, k, v)`` takes
    and returns what :func:`flash_prefill_attention` does, and the
    gradients come shaped like q, k, v. The counterpart of upstream's
    ``jax.custom_vjp`` around flash attention (flash_attention.py:204-318);
    it runs under ``torch.utils.checkpoint(use_reentrant=False)``, which
    calls the forward again in the backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_forward(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        return flash_attention_backward(*ctx.saved_tensors, do)


paged_decode_attention.launches = 0
flash_prefill_attention.launches = 0
flash_attention_backward.launches = 0
KERNELS = {"K12": paged_decode_attention, "K13": flash_prefill_attention,
           "K13-bwd": flash_attention_backward}
