"""Llama with packed-MXQ linears and an int8 KV cache, in PyTorch (port of
``mxq_tpu/models/llama.py``).

Parameters are a plain dict as in the JAX version: linear weights are
stored ``[in, out]`` (forward is ``x @ w``), every per-layer tensor is
stacked on a leading ``[L]`` axis, and ``quantize_params_packed`` turns the
projections into stacked :class:`PackedMXQLinear`. Layers run in a Python
loop (the JAX version scans); caches are updated in place.

Packed linears dispatch in :func:`quant_linear`: 512 tokens or more go to
the prefill path (kernel K3 + two GEMMs, or with ``prefill_act_bits=8``
K5 + two int8 GEMMs), fewer to the GEMV of ``ops.mxq_matmul``'s layout
(K1 at B >= 2, K2 at B == 1, K6 for ``MXQ_GEMV_LAYOUT=quad|bfexp``).
Dense linears take the reference's fake-quant forward when ``w_bits``
< 32, activations when 2 < ``a_bits`` < 32, and k/v when ``kv_bits`` < 32
(``scheme``); ``forward(train=True)`` takes the straight-through
estimators of QAT and ``remat=True`` recomputes each decoder layer in the
backward (``torch.utils.checkpoint``, the counterpart of
``jax.checkpoint``). The parameters train as leaf tensors: each layer is a
view into the stacks, so its gradients land there. A packed
uniform-4b lm_head goes through K7. Decode with the stacked int8 cache goes
through K4 (``ops.attn_int8.decode_attend_update``), and a speculative
verify of T tokens per slot through K4a once per token. Cache-less or
position-0 prefill
attention of 128+ tokens on the card uses
``torch.nn.functional.scaled_dot_product_attention``, the counterpart of the
library flash attention the JAX version calls; on the CPU it takes the
einsum path, as JAX does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from mxq_tpu_torch import resolve_device, scheme
from mxq_tpu_torch.config import MXQConfig
from mxq_tpu_torch.packfmt import PackedMXQLinear, quantize_pack, stack_packed
from mxq_tpu_torch.ops import attn_int8, mxq_matmul, uniform4
from mxq_tpu_torch.serving import kvcache

NOT_PORTED = "not ported yet, see ROADMAP.md"


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    w_bits: int = 32
    a_bits: int = 32
    kv_bits: int = 32
    a_symmetric: bool = True
    scheme: MXQConfig = dataclasses.field(default_factory=MXQConfig)
    # "auto": SDPA on the card for cache-less / position-0 prefill of 128+
    # tokens, einsum elsewhere; "xla": always einsum; "flash": always SDPA
    attn_impl: str = "auto"
    # 8 routes packed linears of 512+ tokens through int8 GEMMs (kernel K5)
    prefill_act_bits: int = 32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """A test-size config (everything divisible by the MXQ block of 64)."""
        d = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=4, max_position_embeddings=256)
        d.update(kw)
        return cls(**d)

    @classmethod
    def llama2_7b(cls, **kw) -> "LlamaConfig":
        return cls(**kw)

    @classmethod
    def llama2_13b(cls, **kw) -> "LlamaConfig":
        d = dict(hidden_size=5120, intermediate_size=13824,
                 num_hidden_layers=40, num_attention_heads=40,
                 num_key_value_heads=40)
        d.update(kw)
        return cls(**d)

    @classmethod
    def llama2_70b(cls, **kw) -> "LlamaConfig":
        d = dict(hidden_size=8192, intermediate_size=28672,
                 num_hidden_layers=80, num_attention_heads=64,
                 num_key_value_heads=8, max_position_embeddings=4096)
        d.update(kw)
        return cls(**d)


LAYER_LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj",
                 "gate_proj", "up_proj", "down_proj")


def _linear_shapes(cfg: LlamaConfig) -> dict[str, tuple[int, int]]:
    h, i = cfg.hidden_size, cfg.intermediate_size
    kv = cfg.num_key_value_heads * cfg.head_dim
    return dict(q_proj=(h, h), k_proj=(h, kv), v_proj=(h, kv), o_proj=(h, h),
                gate_proj=(h, i), up_proj=(h, i), down_proj=(i, h))


def init_params(cfg: LlamaConfig, seed: int = 0, dtype=torch.float32,
                device: str | torch.device = "cuda") -> dict:
    """Random-init parameters from one ``torch.Generator`` seeded with
    ``seed`` (the draws differ from the JAX version's). Linear weights are
    [in, out]; each layer is drawn separately, in f32, so peak memory stays
    one layer above the result."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    l = cfg.num_hidden_layers

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    layers = {}
    for name, (fan_in, fan_out) in _linear_shapes(cfg).items():
        stack = torch.empty((l, fan_in, fan_out), dtype=dtype, device=dev)
        for i in range(l):
            stack[i] = normal((fan_in, fan_out), 1.0 / math.sqrt(fan_in))
        layers[name] = stack
    layers["input_layernorm"] = torch.ones((l, cfg.hidden_size), dtype=dtype,
                                           device=dev)
    layers["post_attention_layernorm"] = torch.ones(
        (l, cfg.hidden_size), dtype=dtype, device=dev)
    params = {"embed_tokens": normal((cfg.vocab_size, cfg.hidden_size), 0.02),
              "layers": layers,
              "norm": torch.ones((cfg.hidden_size,), dtype=dtype, device=dev)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal((cfg.hidden_size, cfg.vocab_size), 0.02)
    return params


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """LlamaRMSNorm: variance in f32."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def rope_tables(cfg: LlamaConfig, positions: torch.Tensor):
    """cos/sin tables [..., T, D] for positions [..., T]."""
    d = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** scheme.div_const(
        torch.arange(0, d, 2, dtype=torch.float32, device=positions.device),
        d))
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q, k, cos, sin):
    """q, k [B, T, H, D]; cos/sin [B, T, D]."""
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    q2 = q * cos + _rotate_half(q) * sin
    k2 = k * cos + _rotate_half(k) * sin
    return q2.to(q.dtype), k2.to(k.dtype)


def quant_linear(x: torch.Tensor, w, cfg: LlamaConfig,
                 train: bool = False) -> torch.Tensor:
    """``x @ w`` for a dense [in, out] weight or one layer of a packed
    linear (the serving path), with the reference's fake-quant
    (mxq_tpu/models/llama.py:190-226): activations symmetric in groups of
    128 (or asymmetric in groups of 8, ``a_symmetric=False``) when
    2 < a_bits < 32, with the clipped straight-through backward; dense
    weights MXQ (2 <= w_bits < 32) or binary (w_bits == 1). ``train``
    gives the weights their straight-through backward: clipped at
    ``cfg.scheme.ste_clip`` for MXQ, unclipped for binary. A packed weight
    under ``train`` never takes the int8-activation prefill."""
    if 2 < cfg.a_bits < 32:
        if cfg.a_symmetric:
            x = scheme.sym_fake_quant_ste(x, cfg.a_bits, groupsize=128)
        else:
            x = scheme.asym_fake_quant_ste(x, cfg.a_bits, groupsize=8)
    if isinstance(w, PackedMXQLinear):
        tokens = math.prod(x.shape[:-1])
        if tokens >= 512:
            pf = (mxq_matmul.mxq_matmul_prefill_a8
                  if cfg.prefill_act_bits == 8 and not train
                  else mxq_matmul.mxq_matmul_prefill)
            return pf(x, w, None, cfg.scheme)
        return mxq_matmul.mxq_matmul(x, w, cfg.scheme)
    if 2 <= cfg.w_bits < 32:
        fq = scheme.mxq_fake_quant_ste if train else scheme.mxq_fake_quant_qat
        w = fq(w.T, cfg.scheme).T
    elif cfg.w_bits == 1:
        wq = scheme.binary_fake_quant(w.T).T
        w = (wq - w).detach() + w if train else wq
    return x @ w


_PACKED_GROUPS = {"qkv_proj": ("q_proj", "k_proj", "v_proj"),
                  "o_proj": ("o_proj",),
                  "gate_up_proj": ("gate_proj", "up_proj"),
                  "down_proj": ("down_proj",)}


def quantize_params_packed(params: dict, cfg: LlamaConfig,
                           device: str | torch.device = "cuda") -> dict:
    """Pack the seven projections of every layer into four stacked
    :class:`PackedMXQLinear` on ``device``, one layer at a time (each
    layer's dense weights are moved there, packed and dropped): q/k/v and
    gate/up are concatenated along the output dim (numerically identical
    to packing them apart). Embeddings, norms and the head stay dense."""
    dev = resolve_device(device)
    layers = params["layers"]
    out_layers = {k: v.to(dev) for k, v in layers.items()
                  if k not in LAYER_LINEARS}
    for name, parts in _PACKED_GROUPS.items():
        packs = []
        for i in range(cfg.num_hidden_layers):
            w = torch.cat([layers[p][i].to(dev) for p in parts], dim=-1)
            packs.append(quantize_pack(w.T, cfg.scheme))
            del w
        out_layers[name] = stack_packed(packs)
        del packs
    out = {k: v.to(dev) for k, v in params.items() if k != "layers"}
    out["layers"] = out_layers
    return out


def _cache_len(caches: dict) -> int:
    return (caches["k_codes"].shape[3] if "k_codes" in caches
            else caches["k"].shape[2])


def _sdpa(q, k, v, d):
    """Causal attention through PyTorch's fused SDPA: q, k, v [B, T, H, D]."""
    ctx = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, scale=1.0 / math.sqrt(d))
    return ctx.transpose(1, 2)


def _qkv(x, layer, cfg: LlamaConfig, train: bool = False):
    """The q, k, v projections of x [B, T, hidden]: [B, T, H, D] each; k
    and v fake-quantized symmetric in groups of 128 when kv_bits < 32
    (mxq_tpu/models/llama.py:278-280), with or without a cache."""
    b, t, _ = x.shape
    nh, nkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    if "qkv_proj" in layer:
        qkv = quant_linear(x, layer["qkv_proj"], cfg, train)
        q = qkv[..., : nh * d]
        k = qkv[..., nh * d: (nh + nkv) * d]
        v = qkv[..., (nh + nkv) * d:]
    else:
        q = quant_linear(x, layer["q_proj"], cfg, train)
        k = quant_linear(x, layer["k_proj"], cfg, train)
        v = quant_linear(x, layer["v_proj"], cfg, train)
    if cfg.kv_bits < 32:
        k = scheme.sym_fake_quant_ste(k, cfg.kv_bits, groupsize=128)
        v = scheme.sym_fake_quant_ste(v, cfg.kv_bits, groupsize=128)
    return q.reshape(b, t, nh, d), k.reshape(b, t, nkv, d), \
        v.reshape(b, t, nkv, d)


def masked_attention(q, k, v, mask):
    """Softmax attention of q [B, T, Hq, D] over k, v [B, S, Hkv, D] (GQA:
    k/v heads repeated) with an additive mask broadcast to [B, Hq, T, S]:
    f32 scores, probabilities in v's type. Returns [B, T, Hq, D]."""
    nh, nkv, d = q.shape[2], k.shape[2], q.shape[3]
    if nkv != nh:
        k = torch.repeat_interleave(k, nh // nkv, dim=2)
        v = torch.repeat_interleave(v, nh // nkv, dim=2)
    qf = q.transpose(1, 2).float()
    kf = k.transpose(1, 2).float()
    vf = v.transpose(1, 2)
    scores = scheme.div_const(torch.einsum("bhtd,bhsd->bhts", qf, kf),
                              math.sqrt(d))
    probs = torch.softmax(scores + mask, dim=-1).to(vf.dtype)
    return torch.einsum("bhts,bhsd->bhtd", probs, vf).transpose(1, 2)


def attention(x, layer, cfg: LlamaConfig, cos, sin, mask, cache=None,
              cache_pos: Optional[int] = None, layer_idx: Optional[int] = None,
              train: bool = False):
    """LlamaAttention, GQA-ready (a T=1 decode step over a cache goes
    through :func:`decode_slots` instead). ``cache`` is the stacked
    cache dict (int8: codes [L,B,H,S,D] + scales [L,B,H,S]; bf16: k/v
    [L,B,S,H,D]) written in place at rows ``cache_pos..`` of layer
    ``layer_idx``."""
    b, t, _ = x.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim
    q, k, v = _qkv(x, layer, cfg, train)
    q, k = apply_rope(q, k, cos, sin)

    on_card = x.device.type == "cuda"
    prefill_flash = (cache is not None and t >= 128 and cache_pos == 0
                     and (cfg.attn_impl == "flash"
                          or (cfg.attn_impl == "auto" and on_card)))
    if cache is not None:
        idx = layer_idx
        if "k_codes" in cache:
            layer_cache = {n: cache[n][idx] for n in
                           ("k_codes", "k_scale", "v_codes", "v_scale")}
            kvcache.cache_update_layer(layer_cache, k, v, cache_pos)
            if prefill_flash:
                # attend the int8-roundtripped fresh keys: the values decode
                # reads back from the cache
                kc, ksc = kvcache.quantize_kv_headmajor(k)
                vc, vsc = kvcache.quantize_kv_headmajor(v)
                k = (kc.float() * ksc.float()[..., None]).transpose(1, 2) \
                    .to(x.dtype)
                v = (vc.float() * vsc.float()[..., None]).transpose(1, 2) \
                    .to(x.dtype)
            else:
                k, v = kvcache.cache_read_layer(layer_cache, dtype=x.dtype)
        else:
            s = cache["k"].shape[2]
            if not 0 <= cache_pos <= s - t:
                raise ValueError(f"rows {cache_pos}..{cache_pos + t} do not "
                                 f"fit a cache of {s}")
            cache["k"][idx, :, cache_pos:cache_pos + t] = k
            cache["v"][idx, :, cache_pos:cache_pos + t] = v
            if not prefill_flash:
                k = cache["k"][idx].to(x.dtype)
                v = cache["v"][idx].to(x.dtype)

    use_flash = (cfg.attn_impl == "flash"
                 or (cfg.attn_impl == "auto" and on_card and t >= 128
                     and (cache is None or prefill_flash)))
    if use_flash:
        nkv = k.shape[2]
        if nkv != nh:
            k = torch.repeat_interleave(k, nh // nkv, dim=2)
            v = torch.repeat_interleave(v, nh // nkv, dim=2)
        ctx = _sdpa(q, k, v, d)
    else:
        ctx = masked_attention(q, k, v, mask)
    ctx = ctx.reshape(b, t, nh * d).to(x.dtype)
    return quant_linear(ctx, layer["o_proj"], cfg, train)


def mlp(x, layer, cfg: LlamaConfig, train: bool = False):
    """SiLU(gate) * up -> down."""
    if "gate_up_proj" in layer:
        gu = quant_linear(x, layer["gate_up_proj"], cfg, train)
        g, u = gu.chunk(2, dim=-1)
    else:
        g = quant_linear(x, layer["gate_proj"], cfg, train)
        u = quant_linear(x, layer["up_proj"], cfg, train)
    return quant_linear(F.silu(g) * u, layer["down_proj"], cfg, train)


def decoder_layer(x, layer, cfg: LlamaConfig, cos, sin, mask, cache=None,
                  cache_pos=None, layer_idx=None, train: bool = False):
    h = rms_norm(x, layer["input_layernorm"], cfg.rms_norm_eps)
    x = x + attention(h, layer, cfg, cos, sin, mask, cache, cache_pos,
                      layer_idx, train)
    h = rms_norm(x, layer["post_attention_layernorm"], cfg.rms_norm_eps)
    return x + mlp(h, layer, cfg, train)


def decode_step(params, tokens, cfg: LlamaConfig, positions, attend):
    """T decode tokens for every slot: tokens [B, T], token t of slot b at
    position positions[b] + t. The one decoder layer loop of the port's
    decode (norm, q/k/v, RoPE, the attention step, o_proj, MLP); the
    caller's cache lives in ``attend``: ``attend(layer_idx, q, k, v)`` gets
    q [B, T, Hq, D] and k, v [B, T, Hkv, D] after RoPE, stores k, v where
    its cache keeps them and returns ctx [B, T, Hq, D] (or [B, Hq, D] for
    T = 1). Returns logits [B, T, V] f32."""
    b, t = tokens.shape
    x = params["embed_tokens"][tokens]
    posmat = positions[:, None] + torch.arange(t, device=positions.device)
    cos, sin = rope_tables(cfg, posmat.float())
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    width = cfg.num_attention_heads * cfg.head_dim
    for idx in range(cfg.num_hidden_layers):
        layer = layer_view(params, idx)
        h = rms_norm(x, layer["input_layernorm"], cfg.rms_norm_eps)
        q, k, v = _qkv(h, layer, cfg)
        q, k = apply_rope(q, k, cos, sin)
        ctx = attend(idx, q, k, v).reshape(b, t, width).to(x.dtype)
        x = x + quant_linear(ctx, layer["o_proj"], cfg)
        h = rms_norm(x, layer["post_attention_layernorm"], cfg.rms_norm_eps)
        x = x + mlp(h, layer, cfg)
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    return lm_head(params, x).float()


def decode_slots(params, tokens, cfg: LlamaConfig, caches: dict, positions):
    """:func:`decode_step` over a stacked slot cache, token t of slot b
    written and attended at row positions[b] + t (tokens [B, T]; T > 1 is
    the speculative verify). Each query attends the rows up to its own.

    * int8 cache, T = 1: K4 (``attn_int8.decode_attend_update``) writes the
      code rows per layer; the scale rows of all layers are committed after
      the layer loop.
    * int8 cache, T > 1: each layer scatters the code and scale rows of all
      T tokens first, then attends every query with one K4a call (one
      launch while G * T <= 64), query t over the rows up to positions + t:
      the function of ``mxq_tpu``'s
      ``_forward_multipos``, which makes one call per query.
    * bf16 cache: the rows are scattered and attended with
      :func:`masked_attention` under the mask ``row <= positions[b] + t``.

    Updates ``caches`` in place; returns logits [B, T, V] f32."""
    b, t = tokens.shape
    rows = torch.arange(b, device=tokens.device)[:, None]
    posmat = positions.long()[:, None] + torch.arange(t, device=tokens.device)
    if "k_codes" not in caches:
        kpos = torch.arange(_cache_len(caches), device=tokens.device)
        mask = torch.where(kpos[None, None, :] <= posmat[:, :, None], 0.0,
                           torch.finfo(torch.float32).min)[:, None]

        def attend(idx, q, k, v):
            caches["k"][idx][rows, posmat] = k.to(caches["k"].dtype)
            caches["v"][idx][rows, posmat] = v.to(caches["v"].dtype)
            return masked_attention(q, caches["k"][idx], caches["v"][idx],
                                    mask)

        return decode_step(params, tokens, cfg, positions, attend)
    if t > 1:
        def attend(idx, q, k, v):
            kc, ksc = kvcache.quantize_kv_headmajor(k)    # [B,H,T,D], [B,H,T]
            vc, vsc = kvcache.quantize_kv_headmajor(v)
            for name, val in (("k_codes", kc), ("k_scale", ksc),
                              ("v_codes", vc), ("v_scale", vsc)):
                caches[name][idx][rows, :, posmat] = val.transpose(1, 2)
            return attn_int8.int8_decode_attention_stacked(
                q, caches["k_codes"], caches["k_scale"], caches["v_codes"],
                caches["v_scale"], idx, positions)

        return decode_step(params, tokens, cfg, positions, attend)
    pend = []

    def attend(idx, q, k, v):
        kc, ksc = kvcache.quantize_kv_headmajor(k)        # [B,H,1,D], [B,H,1]
        vc, vsc = kvcache.quantize_kv_headmajor(v)
        ctx, _, p = attn_int8.decode_attend_update(
            caches, q[:, 0], kc, ksc, vc, vsc, idx, positions)
        pend.append(p)
        return ctx

    logits = decode_step(params, tokens, cfg, positions, attend)
    # scale rows of every layer at each slot's own row: [B, L, H]
    pos = positions.long()
    caches["k_scale"][:, rows[:, 0], :, pos] = \
        torch.stack([p[0][..., 0] for p in pend]).transpose(0, 1)
    caches["v_scale"][:, rows[:, 0], :, pos] = \
        torch.stack([p[1][..., 0] for p in pend]).transpose(0, 1)
    return logits


def causal_mask(t: int, s: Optional[int] = None, offset: int = 0,
                device: str | torch.device = "cpu") -> torch.Tensor:
    """[1, 1, T, S] additive causal mask; ``offset`` is query 0's position."""
    s = s if s is not None else t
    qi = torch.arange(t, device=device)[:, None] + offset
    ki = torch.arange(s, device=device)[None, :]
    m = torch.where(ki <= qi, 0.0, torch.finfo(torch.float32).min)
    return m[None, None].float()


def layer_view(params: dict, idx: int) -> dict:
    """Layer ``idx`` of the stacked parameters, as views."""
    return {k: (v.layer(idx) if isinstance(v, PackedMXQLinear) else v[idx])
            for k, v in params["layers"].items()}


def lm_head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The vocabulary projection: tied embeddings, a dense [hidden, vocab]
    head, or a packed uniform-4b head (``uniform4.u4_matmul``, K7)."""
    head = params.get("lm_head")
    if head is None:
        return x @ params["embed_tokens"].T
    if isinstance(head, uniform4.PackedU4Linear):
        return uniform4.u4_matmul(x, head)
    return x @ head


def check_params_device(params: dict, dev: torch.device) -> None:
    have = params["embed_tokens"].device
    if have.type != dev.type:
        raise ValueError(f"parameters live on {have}, not on {dev}")


def forward(params, input_ids, cfg: LlamaConfig, *, positions=None,
            caches=None, cache_pos=None, mask=None,
            device: str | torch.device = "cuda", train: bool = False,
            remat: bool = False):
    """Full model forward -> (logits [B, T, V] f32, caches). ``caches`` (a
    stacked cache dict or None) is updated in place and returned. One
    token with a cache and neither ``positions`` nor ``mask`` is a decode
    step of every slot at row ``cache_pos`` (:func:`decode_slots`).
    ``train`` takes the straight-through estimators (:func:`quant_linear`);
    ``remat`` keeps only each decoder layer's input for the backward and
    recomputes the rest there."""
    dev = resolve_device(device)
    check_params_device(params, dev)
    input_ids = torch.as_tensor(input_ids, device=dev)
    b, t = input_ids.shape
    if t == 1 and caches is not None and positions is None and mask is None:
        pos = torch.full((b,), cache_pos, dtype=torch.int32, device=dev)
        return decode_slots(params, input_ids, cfg, caches, pos), caches
    x = params["embed_tokens"][input_ids]
    if positions is None:
        start = 0 if cache_pos is None else cache_pos
        positions = torch.arange(t, device=dev)[None, :] + start
        positions = positions.expand(b, t)
    cos, sin = rope_tables(cfg, positions)
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    if mask is None:
        if caches is not None:
            kpos = torch.arange(_cache_len(caches), device=dev)
            valid = kpos[None, None, :] <= positions[:, :, None]
            mask = torch.where(valid, 0.0,
                               torch.finfo(torch.float32).min)[:, None]
        else:
            mask = causal_mask(t, device=dev)

    def layer_fn(x, idx):
        return decoder_layer(x, layer_view(params, idx), cfg, cos, sin, mask,
                             caches, cache_pos, idx, train)

    for idx in range(cfg.num_hidden_layers):
        if remat:
            x = torch.utils.checkpoint.checkpoint(layer_fn, x, idx,
                                                  use_reentrant=False)
        else:
            x = layer_fn(x, idx)
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    return lm_head(params, x).float(), caches


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device: str | torch.device = "cuda"):
    """Stacked bf16 cache: k/v [L, B, S, H, D]."""
    dev = resolve_device(device)
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100) -> torch.Tensor:
    """The shifted CE loss (mxq_tpu/models/llama.py:567): token t's logits
    predict label t + 1; labels equal to ``ignore_index`` are left out."""
    logits = logits[:, :-1]
    labels = labels[:, 1:]
    valid = labels != ignore_index
    labels = torch.where(valid, labels, 0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return (nll * valid).sum() / valid.sum().clamp_min(1)


def sequence_classification_forward(params, input_ids, cfg: LlamaConfig,
                                    num_labels: int, pad_token_id: int = 0,
                                    device: str | torch.device = "cuda"
                                    ) -> torch.Tensor:
    """LlamaForSequenceClassification (mxq_tpu/models/llama.py:578): the
    score head ``params["score"]`` [hidden, num_labels] on the hidden state
    of each row's last non-pad token. Returns [B, num_labels]."""
    dev = resolve_device(device)
    check_params_device(params, dev)
    input_ids = torch.as_tensor(input_ids, device=dev)
    b, t = input_ids.shape
    x = params["embed_tokens"][input_ids]
    positions = torch.arange(t, device=dev)[None].expand(b, t)
    cos, sin = rope_tables(cfg, positions)
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    mask = causal_mask(t, device=dev)
    for idx in range(cfg.num_hidden_layers):
        x = decoder_layer(x, layer_view(params, idx), cfg, cos, sin, mask)
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    logits = x @ params["score"]                       # [B, T, num_labels]
    last = ((input_ids != pad_token_id).sum(-1) - 1).clamp_min(0)
    return logits[torch.arange(b, device=dev), last]
