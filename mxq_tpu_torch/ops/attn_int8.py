"""One-token decode attention straight off the int8 KV cache: the plain
PyTorch versions, the wrappers of the K4 family (``csrc/attn_int8.cu``,
one kernel with two flags) and of the paged kernels K9-K11
(``csrc/paged_attn_int8.cu``), and the dispatch point the model and engine
share.

Port of ``mxq_tpu/ops/attn_int8.py`` (``_attend`` :50-94,
``int8_decode_attention_fused_write`` :449, ``int8_decode_attention``
:491, ``_stacked`` :287, ``_cur`` :201, ``_cur_folded`` :1123, the
dequantize-then-attend oracle :515, ``decode_attend_update`` :1149). The
fused write (K4) is the only T=1 decode path: the TPU's "folded" and
"deferred" write strategies were layout workarounds, and their kernels
(K4b, K4d) are ported as flags but have no serving caller. The
speculative verify attends all of its T queries in one K4a launch (query t
over rows s <= positions[b] + t) while G * T <= QMAX = 64, and in one
launch per floor(64 / G) tokens beyond, where ``mxq_tpu`` makes one call
per query; past 64 query heads per kv head (Falcon-7B's 71 over one) a
launch takes one token and a group of at most 64 of each kv head's query
heads (``launch_plan``), reading q and writing the context in place. Per (batch, kv head), with the
current token out of cache (K4, K4b/K4d):

    st  = (q . K_codes^T) * k_scale / sqrt(D)     cache rows s < pos
    p   = softmax over [st, st_cur]
    ctx = (bf16(p * v_scale) . V_codes + bf16(p_cur * v_scale_cur) * v_cur)

and without it (K4a/K4c) the same over cache rows s <= pos. K4 writes the
current token's code rows into the cache IN PLACE at row ``positions[b]``
of layer ``layer_idx``; its scale rows are returned for the caller to
commit after the layer loop. Requires S > max(positions) where a row is
written.

On the card each wrapper runs two kernels (``csrc/attn_split.cuh``): the
history is split over blocks of ``CHUNK`` rows, pass A scores every row,
pass B rounds bf16(p * v_scale) against the max the plain version rounds
against and sums its split, and the last block of each (batch, kv head)
adds the splits in order. The kernels take every head_dim D >= 1: 64,
128 and 256 at their templates, every other D <= 256 at the next of them,
and every D > 256 on the wide path (``csrc/attn_int8_wide.cu``: pass A
sums each score over D's chunks of WIDE_CHUNK columns in chunk order,
pass B runs a block per (split, column chunk)), reading and writing the
cache's rows in place at their true width (``code_load_bytes``). The
wide path counts its launches under the same counters.
"""

from __future__ import annotations

import math

import torch

from mxq_tpu_torch.ops import count_launch
from mxq_tpu_torch.scheme import div_const

NEG = torch.finfo(torch.float32).min
CHUNK = 128      # history rows per block of the kernels (attn_split.cuh)
QMAX = 64        # query rows per (batch, kv head) the kernels take
TILE_DIMS = (64, 128, 256)   # the kernels' head_dim templates
MAX_TILE = TILE_DIMS[-1]     # D past it runs on the wide path
WIDE_CHUNK = 256             # columns a chunk of the wide path
_TICKETS: dict = {}
_RETIRED: list = []


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def reserve_tickets(n: int, device) -> torch.Tensor:
    """The int32 tickets that the last block of each (batch, kv head)
    counts with and leaves at 0: one zeroed buffer per device, shared by
    every call on it (the calls of one stream run in order, and a graph's
    replays too, since the kernels leave it at 0), holding at least ``n``
    pairs. An engine reserves its slots x kv heads before it captures a
    graph: a captured call must not grow the buffer, and raises if it
    would. A buffer outgrown outside a capture stays allocated, since a
    graph may hold it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    tickets = _TICKETS.get(device)
    if tickets is not None and tickets.numel() >= n:
        return tickets
    if _capturing(device):
        raise RuntimeError(
            f"attention tickets: a call of {n} (batch, kv head) pairs while "
            f"a CUDA graph is captured would outgrow the "
            f"{0 if tickets is None else tickets.numel()} reserved; reserve "
            "them before the capture (reserve_tickets)")
    if tickets is not None:
        _RETIRED.append(tickets)
    tickets = _TICKETS[device] = torch.zeros(n, dtype=torch.int32,
                                             device=device)
    return tickets


def _split_scratch(b, hkv, nq, nsplit, d, device):
    """The kernels' f32 scratch (scores, split maxima, current-token
    logits, partial contexts and denominators of ``nq`` query rows per
    (batch, kv head) over ``nsplit`` splits, as ``attn_split::carve`` cuts
    it) and the tickets of :func:`reserve_tickets`."""
    tickets = reserve_tickets(b * hkv, device)
    ws = torch.empty(b * hkv * nq * (nsplit * (CHUNK + d + 2) + 1),
                     dtype=torch.float32, device=device)
    return ws, tickets


def scratch_scores(ws, b, hkv, nq, nsplit):
    """Views of pass A's f32 scores [B, Hkv, nq, nsplit * CHUNK] and
    current-token logits [B, Hkv, nq] in a scratch of ``_split_scratch``
    after a launch (``attn_split::carve``'s sc and stc)."""
    bhq = b * hkv * nq
    sc = ws[:bhq * nsplit * CHUNK].view(b, hkv, nq, nsplit * CHUNK)
    at = bhq * nsplit * (CHUNK + 1)
    return sc, ws[at:at + bhq].view(b, hkv, nq)


def kernel_entry(d: int, paged: bool) -> tuple[str, str]:
    """(library, C function) that runs head_dim ``d``: the templates'
    (``attn_int8`` / ``paged_attn_int8``) up to MAX_TILE, the wide path's
    (``attn_int8_wide``) past it."""
    if d > MAX_TILE:
        return "attn_int8_wide", ("paged_attn_int8_wide" if paged
                                  else "attn_int8_wide")
    name = "paged_attn_int8" if paged else "attn_int8"
    return name, name


def code_load_bytes(what, d, tensors) -> int:
    """The bytes a code load of the kernels reads (their ``vec``): 16 at a
    template width (64, 128, 256), whose code tensors must start 16-byte
    aligned; at any other head_dim d (the wide path's too) the widest of
    16, 4 and 1 bytes that divides d and every code tensor's start, so
    that each row, at d bytes from the last, starts aligned to it."""
    if d in TILE_DIMS:
        if any(t.data_ptr() % 16 for t in tensors):
            raise ValueError(f"{what}: code tensors must start 16-byte "
                             "aligned (the kernels load 16 codes at once)")
        return 16
    for vec in (16, 4):
        if d % vec == 0 and not any(t.data_ptr() % vec for t in tensors):
            return vec
    return 1


def _attend_plain(q, kc, ks, vc, vs, positions, cur=None):
    """The ``_attend`` math on one layer. q [B, Hkv, G, D] (bf16 values),
    kc/vc [B, Hkv, S, D] int8, ks/vs [B, Hkv, S] bf16 -> [B, Hkv, G, D] f32.
    Without ``cur`` the cache rows s <= positions[b] are attended; with
    ``cur`` = (kcur/vcur [B, Hkv, 1, D] int8, kscur/vscur [B, Hkv, 1] bf16)
    the rows s < positions[b] and the current token out of cache."""
    d = q.shape[-1]
    s = kc.shape[2]
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    st = torch.einsum("bhgd,bhsd->bhgs", qf, kc.float())
    st = st * (ks.float() * scale)[:, :, None, :]
    kpos = torch.arange(s, device=q.device)[None, None, None, :]
    pos = positions[:, None, None, None]
    st = torch.where(kpos < pos if cur is not None else kpos <= pos, st,
                     torch.full_like(st, NEG))
    m = st.amax(dim=-1, keepdim=True)
    if cur is not None:
        kcur, kscur, vcur, vscur = cur
        stc = torch.einsum("bhgd,bhsd->bhgs", qf, kcur.float())  # [B,H,G,1]
        stc = stc * (kscur.float() * scale)[:, :, None, :]
        m = torch.maximum(m, stc)
    p = torch.exp(st - m)
    denom = p.sum(dim=-1, keepdim=True)
    pv = (p * vs.float()[:, :, None, :]).to(torch.bfloat16).float()
    ctx = torch.einsum("bhgs,bhsd->bhgd", pv, vc.float())
    if cur is not None:
        pc = torch.exp(stc - m)
        denom = denom + pc
        pcb = (pc * vscur.float()[:, :, None, :]).to(torch.bfloat16).float()
        ctx = ctx + pcb * vcur.float()
    return ctx / denom


def _check_k4(what, q, k_codes, k_scale, v_codes, v_scale, cur, positions):
    l, b, hkv, s, d = k_codes.shape
    nt = q.shape[1] if q.dim() == 4 else 1
    hq = q.shape[-2]
    g = hq // hkv
    want = [
        ("q", q, torch.bfloat16,
         (b, nt, hq, d) if q.dim() == 4 else (b, hq, d)),
        ("k_codes", k_codes, torch.int8, (l, b, hkv, s, d)),
        ("v_codes", v_codes, torch.int8, (l, b, hkv, s, d)),
        ("k_scale", k_scale, torch.bfloat16, (l, b, hkv, s)),
        ("v_scale", v_scale, torch.bfloat16, (l, b, hkv, s)),
        ("positions", positions, torch.int32, (b,)),
    ]
    if cur is not None:
        want += [("kcur", cur[0], torch.int8, (b, hkv, 1, d)),
                 ("kscur", cur[1], torch.bfloat16, (b, hkv, 1)),
                 ("vcur", cur[2], torch.int8, (b, hkv, 1, d)),
                 ("vscur", cur[3], torch.bfloat16, (b, hkv, 1))]
    dev = q.device
    for name, t, dt, shape in want:
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{what} {name}: {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, contiguous={t.is_contiguous()}; "
                             f"want {dt} {shape} contiguous on {dev}")
    if hq % hkv or g < 1 or d < 1:
        raise ValueError(f"{what} takes D >= 1 and Hq a multiple of Hkv, "
                         f"got D={d}, Hq={hq}, Hkv={hkv}")
    if cur is not None and nt != 1:
        raise ValueError(f"{what}: the current token takes one query token")


def launch_plan(g: int, t: int) -> list[tuple[int, int, int, int, bool]]:
    """(t0, nt, g0, ng, write) of each launch that a call of ``t`` query
    tokens at ``g`` query heads per kv head makes, so that no launch holds
    more than QMAX query rows per kv head: tokens t0 .. t0 + nt - 1 and
    query heads g0 .. g0 + ng - 1 of each kv head. At G <= QMAX
    floor(QMAX / G) tokens a launch, every head (a verify of draft_len + 1
    tokens at llama2_70b's G = 8 takes two launches from 9 tokens on); past
    QMAX one token a launch and the heads in ceil(G / QMAX) groups of
    sizes that differ by at most one (Falcon-7B's 71 as 36 + 35), in order.
    ``write``: whether the launch may write the current token's row (K4,
    K11): only a token's first launch; the others fold the current token
    in without writing it (they read only rows before it). The plan
    depends on shapes alone, so a captured CUDA graph replays it."""
    if g < 1 or t < 1:
        raise ValueError(f"G={g} (>= 1), T={t} (>= 1)")
    if g <= QMAX:
        per = QMAX // g
        return [(i, min(per, t - i), 0, g, True) for i in range(0, t, per)]
    n = -(-g // QMAX)
    sizes = [g // n + (i < g % n) for i in range(n)]
    starts = [sum(sizes[:i]) for i in range(n)]
    return [(i, 1, g0, ng, g0 == 0) for i in range(t)
            for g0, ng in zip(starts, sizes)]


def _dense_launch(what, q, k_codes, k_scale, v_codes, v_scale, layer_idx,
                  positions, cur=None, write=False, scratch=None):
    """Check the arguments and launch the K4-family kernel over layer
    ``layer_idx`` of the stacked cache (``cur`` and ``write`` are its
    compile-time flags), once per launch of :func:`launch_plan`: the
    launch of tokens t0.. is a call at positions + t0, which is what token
    t0 + i attends (rows <= pos + t0 + i), so no rounding point moves; it
    reads its tokens' and head group's q and writes their context in
    place. q [B, Hq, D] or [B, T, Hq, D]; returns (ctx of q's shape, f32;
    the number of launches). A list given as ``scratch`` receives each
    launch's scratch (read it with ``scratch_scores``)."""
    from mxq_tpu_torch import _build
    b, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
    t = q.shape[1] if q.dim() == 4 else 1
    l, _, hkv, s, _ = k_codes.shape
    qb = q.to(torch.bfloat16).contiguous()
    _check_k4(what, qb, k_codes, k_scale, v_codes, v_scale, cur, positions)
    if not 0 <= layer_idx < l:
        raise IndexError(f"layer {layer_idx} of {l}")
    kcur, kscur, vcur, vscur = cur if cur is not None else (None,) * 4
    vec = code_load_bytes(what, d, [k_codes[layer_idx], v_codes[layer_idx]]
                          + ([kcur, vcur] if cur is not None else []))
    g = hq // hkv
    plan = launch_plan(g, t)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib, fn = kernel_entry(d, paged=False)
    launch = getattr(_build.load(lib), fn)
    out = torch.empty(qb.shape, dtype=torch.float32, device=q.device)
    for t0, nt, g0, ng, first in plan:
        pc = positions if t0 == 0 else positions + t0
        ws, tickets = _split_scratch(b, hkv, ng * nt, -(-s // CHUNK), d,
                                     q.device)
        err = launch(
            qb.data_ptr(), k_codes[layer_idx].data_ptr(),
            k_scale[layer_idx].data_ptr(), v_codes[layer_idx].data_ptr(),
            v_scale[layer_idx].data_ptr(), ptr(kcur), ptr(kscur), ptr(vcur),
            ptr(vscur), pc.data_ptr(), b, hkv, ng, nt, g, g0, t, t0, s, d,
            int(cur is not None), int(write and first), vec,
            1.0 / math.sqrt(d), ws.data_ptr(), tickets.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, what)
        if scratch is not None:
            scratch.append(ws)
    return out, len(plan)


def _stacked_plain(q, k_codes, k_scale, v_codes, v_scale, layer_idx,
                   positions, cur=None):
    if q.dim() == 4:          # T query tokens, token t at positions + t
        return torch.stack([_stacked_plain(
            q[:, i], k_codes, k_scale, v_codes, v_scale, layer_idx,
            positions + i, cur) for i in range(q.shape[1])], dim=1)
    b, hq, d = q.shape
    hkv = k_codes.shape[2]
    qb = q.to(torch.bfloat16).reshape(b, hkv, hq // hkv, d)
    ctx = _attend_plain(qb, k_codes[layer_idx], k_scale[layer_idx],
                        v_codes[layer_idx], v_scale[layer_idx], positions,
                        cur)
    return ctx.reshape(b, hq, d)


def int8_decode_attention_stacked_plain(q, k_codes, k_scale, v_codes,
                                        v_scale, layer_idx: int, positions):
    """Plain version of K4a/K4c: with q [B, T, Hq, D], exactly the T
    single-query calls at positions + t, stacked."""
    return _stacked_plain(q, k_codes, k_scale, v_codes, v_scale, layer_idx,
                          positions)


def int8_decode_attention_stacked(q, k_codes, k_scale, v_codes, v_scale,
                                  layer_idx: int, positions):
    """K4a/K4c: decode attention over layer ``layer_idx`` of the stacked
    cache, rows s <= positions[b], no current token, nothing written.

    q [B, Hq, D], or [B, T, Hq, D]: T query tokens of each sequence in one
    launch, token t over rows s <= positions[b] + t (the speculative
    verify); k/v_codes [L, B, Hkv, S, D] int8; k/v_scale [L, B, Hkv, S]
    bf16; positions [B] int32. Returns f32 of q's shape."""
    if q.device.type == "cpu":
        return int8_decode_attention_stacked_plain(
            q, k_codes, k_scale, v_codes, v_scale, layer_idx, positions)
    out, n = _dense_launch("K4a", q, k_codes, k_scale, v_codes, v_scale,
                           layer_idx, positions)
    count_launch(int8_decode_attention_stacked, n)
    return out


def int8_decode_attention(q, k_codes, k_scale, v_codes, v_scale, positions):
    """K4a over one layer (k/v_codes [B, Hkv, S, D], k/v_scale
    [B, Hkv, S]; q [B, Hq, D] or [B, T, Hq, D]): the K4c launch with the
    layer as a stack of one."""
    return int8_decode_attention_stacked(
        q, k_codes[None], k_scale[None], v_codes[None], v_scale[None], 0,
        positions)


def int8_decode_attention_cur_folded_plain(q, k_codes, k_scale, v_codes,
                                           v_scale, kcur, kscur, vcur, vscur,
                                           layer_idx: int, positions):
    """Plain version of K4b/K4d."""
    return _stacked_plain(q, k_codes, k_scale, v_codes, v_scale, layer_idx,
                          positions, (kcur, kscur, vcur, vscur))


def int8_decode_attention_cur_folded(q, k_codes, k_scale, v_codes, v_scale,
                                     kcur, kscur, vcur, vscur,
                                     layer_idx: int, positions):
    """K4b/K4d: attention over layer ``layer_idx`` of the stacked cache,
    rows s < positions[b], plus the current token (kcur/vcur
    [B, Hkv, 1, D] int8, kscur/vscur [B, Hkv, 1] bf16) out of cache;
    nothing written. Returns [B, Hq, D] f32."""
    if q.device.type == "cpu":
        return int8_decode_attention_cur_folded_plain(
            q, k_codes, k_scale, v_codes, v_scale, kcur, kscur, vcur, vscur,
            layer_idx, positions)
    out, n = _dense_launch("K4b", q, k_codes, k_scale, v_codes, v_scale,
                           layer_idx, positions, (kcur, kscur, vcur, vscur))
    count_launch(int8_decode_attention_cur_folded, n)
    return out


def int8_decode_attention_cur(q, k_codes, k_scale, v_codes, v_scale, kcur,
                              kscur, vcur, vscur, positions):
    """K4b over one layer (k/v_codes [B, Hkv, S, D]): the K4d launch with
    the layer as a stack of one."""
    return int8_decode_attention_cur_folded(
        q, k_codes[None], k_scale[None], v_codes[None], v_scale[None], kcur,
        kscur, vcur, vscur, 0, positions)


def int8_decode_attention_fused_write_plain(q, k_codes, k_scale, v_codes,
                                            v_scale, kcur, kscur, vcur,
                                            vscur, layer_idx: int, positions):
    """Plain version of K4 on any device (same contract, in-place write)."""
    b = q.shape[0]
    ctx = _stacked_plain(q, k_codes, k_scale, v_codes, v_scale, layer_idx,
                         positions, (kcur, kscur, vcur, vscur))
    rows = torch.arange(b, device=q.device)
    k_codes[layer_idx, rows, :, positions.long()] = kcur[:, :, 0]
    v_codes[layer_idx, rows, :, positions.long()] = vcur[:, :, 0]
    return ctx, k_codes, v_codes


def int8_decode_attention_fused_write(q, k_codes, k_scale, v_codes, v_scale,
                                      kcur, kscur, vcur, vscur,
                                      layer_idx: int, positions):
    """K4: decode attention over layer ``layer_idx`` of the stacked cache,
    writing the current token's code rows in place.

    q [B, Hq, D]; k/v_codes [L, B, Hkv, S, D] int8; k/v_scale
    [L, B, Hkv, S] bf16; kcur/vcur [B, Hkv, 1, D] int8; kscur/vscur
    [B, Hkv, 1] bf16; positions [B] int32. Returns (ctx [B, Hq, D] f32,
    k_codes, v_codes) — the code stacks are the SAME tensors, updated in
    place at row positions[b] of layer layer_idx. Scale rows are not
    written."""
    if q.device.type == "cpu":
        return int8_decode_attention_fused_write_plain(
            q, k_codes, k_scale, v_codes, v_scale, kcur, kscur, vcur, vscur,
            layer_idx, positions)
    out, n = _dense_launch("K4", q, k_codes, k_scale, v_codes, v_scale,
                           layer_idx, positions, (kcur, kscur, vcur, vscur),
                           write=True)
    count_launch(int8_decode_attention_fused_write, n)
    return out, k_codes, v_codes


int8_decode_attention_fused_write.launches = 0
int8_decode_attention_stacked.launches = 0
int8_decode_attention_cur_folded.launches = 0


# ---------------------------------------------------------------------------
# Paged int8 decode attention (port of attn_int8.py:540-1049)
# ---------------------------------------------------------------------------
#
# The folded pool of serving/paged.py: code pages [KVH, LP, PAGE, D] int8,
# scales [KVH, LP, 1, PAGE] bf16 (one per (head, token)), page tables
# [B, pages_per_seq] int32 of PHYSICAL page ids. Each (batch, kv head) folds
# the pages of its table in order into a flash-style running (max m, denom
# l, acc), rows masked to ``row < bound[b]``; pages wholly past the bound
# change nothing (alpha = 1, pexp = 0) and are never read.

PAGE_INT8 = 128


def _paged_attend_plain(q, k_pages, k_scales, v_pages, v_scales, bound,
                        tables, cur=None):
    """The TPU kernels' per-page online fold (attn_int8.py:575-600, and the
    current-token fold :701-717 when ``cur`` = (kcur [B, KVH, D] int8,
    kscur [B, KVH] bf16, vcur, vscur) is given). q [B, Hq, D]; bound [B]:
    rows < bound[b] are attended. Returns ctx [B, Hq, D] f32."""
    b, hq, d = q.shape
    hkv, _, ps, _ = k_pages.shape
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.to(torch.bfloat16).float().reshape(b, hkv, g, d)
    m = torch.full((b, hkv, g, 1), NEG, device=q.device)
    l = torch.zeros((b, hkv, g, 1), device=q.device)
    acc = torch.zeros((b, hkv, g, d), device=q.device)
    rows = torch.arange(ps, device=q.device)
    pps = tables.shape[1]
    # pages past every sequence's bound fold in as the identity: skip them
    npages = min(pps, -(-int(bound.max()) // ps)) if b else 0
    for j in range(npages):
        pid = tables[:, j].long()
        valid = ((j * ps + rows)[None, :] < bound[:, None])[:, None, None, :]
        kc = k_pages[:, pid].float()                      # [KVH, B, ps, D]
        ks = k_scales[:, pid, 0].float().transpose(0, 1)  # [B, KVH, ps]
        vs = v_scales[:, pid, 0].float().transpose(0, 1)
        st = torch.einsum("bhgd,hbsd->bhgs", qf, kc) \
            * (ks * scale)[:, :, None, :]
        st = torch.where(valid, st, NEG)
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        # gate on the mask, not the logit: with m_new still NEG a masked
        # row's exp(st - m_new) would be 1
        pexp = torch.where(valid, torch.exp(st - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + pexp.sum(dim=-1, keepdim=True)
        pv = torch.where(valid, pexp * vs[:, :, None, :], 0.0)
        pv = pv.to(torch.bfloat16).float()
        acc = acc * alpha + torch.einsum("bhgs,hbsd->bhgd", pv,
                                         v_pages[:, pid].float())
        m = m_new
    if cur is not None:
        kcur, kscur, vcur, vscur = cur
        stc = torch.einsum("bhgd,bhd->bhg", qf, kcur.float())[..., None]
        stc = stc * (kscur.float() * scale)[:, :, None, None]
        m_fin = torch.maximum(m, stc)
        alpha2 = torch.exp(m - m_fin)
        pc = torch.exp(stc - m_fin)
        l = l * alpha2 + pc
        pcb = (pc * vscur.float()[:, :, None, None]).to(torch.bfloat16)
        acc = acc * alpha2 + pcb.float() * vcur.float()[:, :, None, :]
    return (acc / l.clamp_min(1e-30)).reshape(b, hq, d)


def _paged_write_plain(k_pages, k_scales, v_pages, v_scales, kcur, kscur,
                       vcur, vscur, positions, tables):
    """K11's write: the current code row and scale lane of every (b, head)
    at (tables[b, pos // PAGE], pos % PAGE); nothing where pos // PAGE is
    past the table (the TPU kernel's write step never comes then)."""
    ps, pps = k_pages.shape[2], tables.shape[1]
    pos = positions.long()
    ok = pos // ps < pps
    pid = tables[ok, pos[ok] // ps].long()
    off = pos[ok] % ps
    k_pages[:, pid, off] = kcur[ok].transpose(0, 1)
    v_pages[:, pid, off] = vcur[ok].transpose(0, 1)
    k_scales[:, pid, 0, off] = kscur[ok].T.to(k_scales.dtype)
    v_scales[:, pid, 0, off] = vscur[ok].T.to(v_scales.dtype)


def int8_paged_decode_attention_plain(q, k_pages, k_scales, v_pages,
                                      v_scales, lengths, page_tables):
    """Plain version of K9."""
    return _paged_attend_plain(q, k_pages, k_scales, v_pages, v_scales,
                               lengths, page_tables)


def int8_paged_decode_attention_cur_plain(q, k_pages, k_scales, v_pages,
                                          v_scales, kcur, kscur, vcur, vscur,
                                          positions, page_tables):
    """Plain version of K10."""
    return _paged_attend_plain(q, k_pages, k_scales, v_pages, v_scales,
                               positions, page_tables,
                               (kcur, kscur, vcur, vscur))


def int8_paged_decode_attend_update_plain(q, k_pages, k_scales, v_pages,
                                          v_scales, kcur, kscur, vcur, vscur,
                                          positions, page_tables):
    """Plain version of K11 (same contract, in-place write)."""
    ctx = _paged_attend_plain(q, k_pages, k_scales, v_pages, v_scales,
                              positions, page_tables,
                              (kcur, kscur, vcur, vscur))
    _paged_write_plain(k_pages, k_scales, v_pages, v_scales, kcur, kscur,
                       vcur, vscur, positions, page_tables)
    return ctx, k_pages, k_scales, v_pages, v_scales


def _check_paged(what, q, k_pages, k_scales, v_pages, v_scales, bound,
                 tables, cur):
    b, hq, d = q.shape
    hkv, lp, ps, _ = k_pages.shape
    g = hq // hkv
    want = [("q", q, torch.bfloat16, (b, hq, d)),
            ("k_pages", k_pages, torch.int8, (hkv, lp, ps, d)),
            ("v_pages", v_pages, torch.int8, (hkv, lp, ps, d)),
            ("k_scales", k_scales, torch.bfloat16, (hkv, lp, 1, ps)),
            ("v_scales", v_scales, torch.bfloat16, (hkv, lp, 1, ps)),
            ("bound", bound, torch.int32, (b,)),
            ("page_tables", tables, torch.int32, (b, tables.shape[1]))]
    if cur is not None:
        want += [("kcur", cur[0], torch.int8, (b, hkv, d)),
                 ("kscur", cur[1], torch.bfloat16, (b, hkv)),
                 ("vcur", cur[2], torch.int8, (b, hkv, d)),
                 ("vscur", cur[3], torch.bfloat16, (b, hkv))]
    dev = q.device
    for name, t, dt, shape in want:
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{what} {name}: {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, contiguous={t.is_contiguous()}; "
                             f"want {dt} {shape} contiguous on {dev}")
    if hq % hkv or g < 1 or d < 1 or ps != PAGE_INT8:
        raise ValueError(f"{what} takes D >= 1, Hq a multiple of Hkv and "
                         f"pages of {PAGE_INT8} rows, got D={d}, Hq={hq}, "
                         f"Hkv={hkv}, page={ps}")
    return code_load_bytes(what, d, [k_pages, v_pages]
                           + ([cur[0], cur[2]] if cur is not None else []))


def _paged_launch(what, q, k_pages, k_scales, v_pages, v_scales, bound,
                  tables, cur=None, write=False):
    """Check the arguments and launch the K9/K10/K11 kernel (``cur`` and
    ``write`` are its compile-time flags) once per launch of
    :func:`launch_plan` (one token; past QMAX query heads per kv head one
    launch per head group, in place). Returns (ctx [B, Hq, D] f32, the
    number of launches)."""
    from mxq_tpu_torch import _build
    qb = q.to(torch.bfloat16).contiguous()
    vec = _check_paged(what, qb, k_pages, k_scales, v_pages, v_scales, bound,
                       tables, cur)
    b, hq, d = q.shape
    hkv, lp = k_pages.shape[:2]
    g = hq // hkv
    plan = launch_plan(g, 1)
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    kcur, kscur, vcur, vscur = cur if cur is not None else (None,) * 4
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib, fn = kernel_entry(d, paged=True)
    launch = getattr(_build.load(lib), fn)
    for _, _, g0, ng, first in plan:
        ws, tickets = _split_scratch(b, hkv, ng, tables.shape[1], d,
                                     q.device)
        err = launch(
            qb.data_ptr(), k_pages.data_ptr(), k_scales.data_ptr(),
            v_pages.data_ptr(), v_scales.data_ptr(), ptr(kcur), ptr(kscur),
            ptr(vcur), ptr(vscur), bound.data_ptr(), tables.data_ptr(), b,
            hkv, ng, g, g0, d, lp, tables.shape[1], int(cur is not None),
            int(write and first), vec, 1.0 / math.sqrt(d), ws.data_ptr(),
            tickets.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, what)
    return out, len(plan)


def int8_paged_decode_attention(q, k_pages, k_scales, v_pages, v_scales,
                                lengths, page_tables):
    """K9: decode attention over one layer's pages of the int8 pool.

    q [B, Hq, D]; k/v_pages [KVH, LP, 128, D] int8; k/v_scales
    [KVH, LP, 1, 128] bf16; lengths [B] int32 (rows < lengths[b] are
    attended, the current row already written); page_tables [B, PPS] int32
    physical page ids. Returns [B, Hq, D] f32."""
    if q.device.type == "cpu":
        return int8_paged_decode_attention_plain(
            q, k_pages, k_scales, v_pages, v_scales, lengths, page_tables)
    out, n = _paged_launch("K9", q, k_pages, k_scales, v_pages, v_scales,
                           lengths, page_tables)
    count_launch(int8_paged_decode_attention, n)
    return out


def int8_paged_decode_attention_cur(q, k_pages, k_scales, v_pages, v_scales,
                                    kcur, kscur, vcur, vscur, positions,
                                    page_tables):
    """K10: K9 over rows < positions[b], plus the current token out of the
    pool (kcur/vcur [B, KVH, D] int8, kscur/vscur [B, KVH] bf16) folded in
    after the last page. Returns [B, Hq, D] f32."""
    if q.device.type == "cpu":
        return int8_paged_decode_attention_cur_plain(
            q, k_pages, k_scales, v_pages, v_scales, kcur, kscur, vcur, vscur,
            positions, page_tables)
    out, n = _paged_launch("K10", q, k_pages, k_scales, v_pages, v_scales,
                           positions, page_tables, (kcur, kscur, vcur, vscur))
    count_launch(int8_paged_decode_attention_cur, n)
    return out


def int8_paged_decode_attend_update(q, k_pages, k_scales, v_pages, v_scales,
                                    kcur, kscur, vcur, vscur, positions,
                                    page_tables):
    """K11: K10, and the current token's code row and scale lane written
    into the pool IN PLACE at (page_tables[b, pos // 128], pos % 128) for
    every kv head (nothing where pos // 128 is past the table). Returns
    (ctx [B, Hq, D] f32, k_pages, k_scales, v_pages, v_scales): the pool
    tensors are the ones given, where JAX returns new buffers. The write
    page must belong to sequence b alone (refcount 1): rows >= pos are
    never read, so no other block of the launch reads the written row."""
    if q.device.type == "cpu":
        return int8_paged_decode_attend_update_plain(
            q, k_pages, k_scales, v_pages, v_scales, kcur, kscur, vcur, vscur,
            positions, page_tables)
    out, n = _paged_launch("K11", q, k_pages, k_scales, v_pages, v_scales,
                           positions, page_tables, (kcur, kscur, vcur, vscur),
                           write=True)
    count_launch(int8_paged_decode_attend_update, n)
    return out, k_pages, k_scales, v_pages, v_scales


int8_paged_decode_attention.launches = 0
int8_paged_decode_attention_cur.launches = 0
int8_paged_decode_attend_update.launches = 0
# K4a and K4c are one launch (one counter), as are K4b and K4d
KERNELS = {"K4": int8_decode_attention_fused_write,
           "K4a": int8_decode_attention_stacked,
           "K4b": int8_decode_attention_cur_folded,
           "K4c": int8_decode_attention_stacked,
           "K4d": int8_decode_attention_cur_folded,
           "K9": int8_paged_decode_attention,
           "K10": int8_paged_decode_attention_cur,
           "K11": int8_paged_decode_attend_update}


def int8_decode_attention_reference(q, k_codes, k_scale, v_codes, v_scale,
                                    positions) -> torch.Tensor:
    """Dequantize-then-attend oracle over one layer ([B, Hkv, S, D] codes),
    mask keys > positions[b] (the current token already in the cache)."""
    b, hq, d = q.shape
    hkv = k_codes.shape[1]
    k = k_codes.float() * k_scale.float()[..., None]
    v = v_codes.float() * v_scale.float()[..., None]
    if hkv != hq:
        k = torch.repeat_interleave(k, hq // hkv, dim=1)
        v = torch.repeat_interleave(v, hq // hkv, dim=1)
    st = div_const(torch.einsum("bhd,bhsd->bhs", q.float(), k), math.sqrt(d))
    s = k.shape[2]
    mask = torch.arange(s, device=q.device)[None, None, :] \
        <= positions[:, None, None]
    st = torch.where(mask, st, torch.full_like(st, NEG))
    return torch.einsum("bhs,bhsd->bhd", torch.softmax(st, dim=-1), v)


def decode_attend_update(cache: dict, q1, kc, ksc, vc, vsc, layer_idx: int,
                         positions):
    """T=1 int8-KV decode attention through K4 — the one dispatch point
    shared by ``models.llama.attention`` and the engine's decode forward.

    cache: the stacked quant cache dict (codes [L,B,H,S,D], scales
    [L,B,H,S]); q1 [B, Hq, D]; kc/vc [B, H, 1, D] and ksc/vsc [B, H, 1]:
    the current token's quantized K/V. Returns (ctx [B, Hq, D] f32, cache,
    pend): the code rows are written into ``cache`` in place, and pend =
    (ksc, vsc) are the scale rows the caller commits after the layer loop.
    """
    ctx, _, _ = int8_decode_attention_fused_write(
        q1, cache["k_codes"], cache["k_scale"], cache["v_codes"],
        cache["v_scale"], kc, ksc, vc, vsc, layer_idx, positions)
    return ctx, cache, (ksc, vsc)
