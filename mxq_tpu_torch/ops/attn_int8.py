"""One-token decode attention straight off the int8 KV cache: the plain
PyTorch version, the wrapper of kernel K4 (``csrc/attn_int8.cu``) and the
dispatch point the model and engine share.

Port of ``mxq_tpu/ops/attn_int8.py`` (``_attend`` :50-94,
``int8_decode_attention_fused_write`` :449, the dequantize-then-attend
oracle :515, ``decode_attend_update`` :1149). The fused write is the only
path: the TPU's "folded" and "deferred" write strategies were layout
workarounds. Per (batch, kv head), with the current token out of cache:

    st  = (q . K_codes^T) * k_scale / sqrt(D)     cache rows s < pos
    p   = softmax over [st, st_cur]
    ctx = (bf16(p * v_scale) . V_codes + bf16(p_cur * v_scale_cur) * v_cur)

The current token's code rows are written into the cache IN PLACE at row
``positions[b]`` of layer ``layer_idx``; its scale rows are returned for
the caller to commit after the layer loop. Requires S > max(positions).
"""

from __future__ import annotations

import math

import torch

NEG = torch.finfo(torch.float32).min


def _attend_plain(q, kc, ks, vc, vs, positions, kcur, kscur, vcur, vscur):
    """The ``_attend`` math on one layer. q [B, Hkv, G, D] (bf16 values),
    kc/vc [B, Hkv, S, D] int8, ks/vs [B, Hkv, S] bf16, kcur/vcur
    [B, Hkv, 1, D] int8, kscur/vscur [B, Hkv, 1] bf16 -> [B, Hkv, G, D] f32."""
    d = q.shape[-1]
    s = kc.shape[2]
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    st = torch.einsum("bhgd,bhsd->bhgs", qf, kc.float())
    st = st * (ks.float() * scale)[:, :, None, :]
    kpos = torch.arange(s, device=q.device)
    st = torch.where(kpos[None, None, None, :] < positions[:, None, None, None],
                     st, torch.full_like(st, NEG))
    stc = torch.einsum("bhgd,bhsd->bhgs", qf, kcur.float())   # [B,H,G,1]
    stc = stc * (kscur.float() * scale)[:, :, None, :]
    m = torch.maximum(st.amax(dim=-1, keepdim=True), stc)
    p = torch.exp(st - m)
    denom = p.sum(dim=-1, keepdim=True)
    pv = (p * vs.float()[:, :, None, :]).to(torch.bfloat16).float()
    ctx = torch.einsum("bhgs,bhsd->bhgd", pv, vc.float())
    pc = torch.exp(stc - m)
    denom = denom + pc
    pcb = (pc * vscur.float()[:, :, None, :]).to(torch.bfloat16).float()
    ctx = ctx + pcb * vcur.float()
    return ctx / denom


def _check_k4(q, k_codes, k_scale, v_codes, v_scale, kcur, kscur, vcur,
              vscur, positions):
    l, b, hkv, s, d = k_codes.shape
    g = q.shape[1] // hkv
    want = [
        ("q", q, torch.bfloat16, (b, hkv * g, d)),
        ("k_codes", k_codes, torch.int8, (l, b, hkv, s, d)),
        ("v_codes", v_codes, torch.int8, (l, b, hkv, s, d)),
        ("k_scale", k_scale, torch.bfloat16, (l, b, hkv, s)),
        ("v_scale", v_scale, torch.bfloat16, (l, b, hkv, s)),
        ("kcur", kcur, torch.int8, (b, hkv, 1, d)),
        ("vcur", vcur, torch.int8, (b, hkv, 1, d)),
        ("kscur", kscur, torch.bfloat16, (b, hkv, 1)),
        ("vscur", vscur, torch.bfloat16, (b, hkv, 1)),
        ("positions", positions, torch.int32, (b,)),
    ]
    dev = q.device
    for name, t, dt, shape in want:
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"K4 {name}: {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, contiguous={t.is_contiguous()}; "
                             f"want {dt} {shape} contiguous on {dev}")
    if q.shape[1] % hkv or not 1 <= g <= 8 or d not in (64, 128):
        raise ValueError(f"K4 takes D in (64, 128) and 1..8 query heads per "
                         f"kv head, got D={d}, Hq={q.shape[1]}, Hkv={hkv}")
    if 4 * (g * d + g * s + 8 * g * d) > 227 * 1024:
        raise ValueError(f"K4 scores for G={g}, S={s} exceed shared memory")


def int8_decode_attention_fused_write_plain(q, k_codes, k_scale, v_codes,
                                            v_scale, kcur, kscur, vcur,
                                            vscur, layer_idx: int, positions):
    """Plain version of K4 on any device (same contract, in-place write)."""
    b, hq, d = q.shape
    hkv = k_codes.shape[2]
    qb = q.to(torch.bfloat16).reshape(b, hkv, hq // hkv, d)
    ctx = _attend_plain(qb, k_codes[layer_idx], k_scale[layer_idx],
                        v_codes[layer_idx], v_scale[layer_idx], positions,
                        kcur, kscur, vcur, vscur)
    rows = torch.arange(b, device=q.device)
    k_codes[layer_idx, rows, :, positions.long()] = kcur[:, :, 0]
    v_codes[layer_idx, rows, :, positions.long()] = vcur[:, :, 0]
    return ctx.reshape(b, hq, d), k_codes, v_codes


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
    from mxq_tpu_torch import _build
    b, hq, d = q.shape
    l, _, hkv, s, _ = k_codes.shape
    g = hq // hkv
    qb = q.to(torch.bfloat16).contiguous()
    _check_k4(qb, k_codes, k_scale, v_codes, v_scale, kcur, kscur, vcur,
              vscur, positions)
    if not 0 <= layer_idx < l:
        raise IndexError(f"layer {layer_idx} of {l}")
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    err = _build.load("attn_int8").attn_int8_k4(
        qb.data_ptr(), k_codes[layer_idx].data_ptr(),
        k_scale[layer_idx].data_ptr(), v_codes[layer_idx].data_ptr(),
        v_scale[layer_idx].data_ptr(), kcur.data_ptr(), kscur.data_ptr(),
        vcur.data_ptr(), vscur.data_ptr(), positions.data_ptr(), b, hkv, g,
        s, d, 1.0 / math.sqrt(d), out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "attn_int8_k4")
    int8_decode_attention_fused_write.launches += 1
    return out, k_codes, v_codes


int8_decode_attention_fused_write.launches = 0
KERNELS = {"K4": int8_decode_attention_fused_write}


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
    st = torch.einsum("bhd,bhsd->bhs", q.float(), k) / math.sqrt(d)
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
