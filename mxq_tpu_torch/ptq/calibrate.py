"""Layer-sequential post-training quantization (port of
``mxq_tpu/ptq/calibrate.py``; the reference's ``nas_quant``,
mxq_quant/lib/prune.py:326-425, with ``MXQGPT``, lib/mxqgpt.py).

Per decoder layer: compute the inputs of its seven linears from the layer
input, zero each weight's dead input columns (those whose inputs are all
zero: the reference's ``diag(H) == 0``, here a column sum of squares),
quantize the weight, and run the quantized layer to produce the next
layer's input. ``PTQConfig.chunk`` splits the calibration samples: the
column statistics accumulate over the chunks before the weights are
quantized, then the quantized layer runs chunk by chunk.

The results fill output stacks allocated once, layer by layer, so the peak
holds the input params, the outputs and one layer's activations. Sharded
calibration (``mesh``) waits for the port of ``parallel/``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from mxq_tpu_torch import packfmt, resolve_device, scheme
from mxq_tpu_torch.config import MXQConfig
from mxq_tpu_torch.models import llama

MODES = ("reference", "packed")


@dataclasses.dataclass(frozen=True)
class PTQConfig:
    # "reference": fp zeros, parity with mxqgpt; "packed": integer zeros and
    # the packed artifact
    mode: str = "reference"
    nsamples: int = 128       # prune.py:329
    seqlen: int = 2048        # model.seqlen, main.py:26
    # calibration samples per pass; None = all at once
    chunk: Optional[int] = None


def _quant_weight(w_io: torch.Tensor, col_sq: torch.Tensor, cfg: MXQConfig,
                  mode: str):
    """Quant-dequant one [in, out] weight after zeroing its dead input
    columns (mxqgpt.py:401-403). Returns ``(dequantized weight in w_io's
    dtype, PackedMXQLinear or None)``: in packed mode both come from the
    same quantization, since requantizing the dequantized weight would not
    give the same codes."""
    w_io = torch.where((col_sq == 0)[:, None], 0.0, w_io)
    if mode == "reference":
        return scheme.mxq_fake_quant_ptq(w_io.T, cfg).T.to(w_io.dtype), None
    packed = packfmt.quantize_pack(w_io.T, cfg)
    return packfmt.unpack_dequant(packed, cfg).to(w_io.dtype), packed


def _layer_linear_inputs(x, layer, cfg: llama.LlamaConfig, cos, sin, mask):
    """The inputs of the seven linears of one decoder layer for the layer
    input ``x`` [B, T, hidden] (what the reference's forward hooks capture,
    prune.py:389-404): attention scores and softmax in f32."""
    h1 = llama.rms_norm(x, layer["input_layernorm"], cfg.rms_norm_eps)
    b, t, _ = x.shape
    nh, nkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    q = (h1 @ layer["q_proj"]).reshape(b, t, nh, d)
    k = (h1 @ layer["k_proj"]).reshape(b, t, nkv, d)
    v = (h1 @ layer["v_proj"]).reshape(b, t, nkv, d)
    q, k = llama.apply_rope(q, k, cos, sin)
    if nkv != nh:
        k = torch.repeat_interleave(k, nh // nkv, dim=2)
        v = torch.repeat_interleave(v, nh // nkv, dim=2)
    scores = scheme.div_const(torch.einsum(
        "bhtd,bhsd->bhts", q.transpose(1, 2).float(),
        k.transpose(1, 2).float()), math.sqrt(d))
    probs = torch.softmax(scores + mask, dim=-1)
    del scores
    ctx = torch.einsum("bhts,bhsd->bhtd", probs, v.transpose(1, 2).float())
    del probs
    ctx = ctx.transpose(1, 2).reshape(b, t, nh * d).to(x.dtype)
    x2 = x + ctx @ layer["o_proj"]
    h2 = llama.rms_norm(x2, layer["post_attention_layernorm"],
                        cfg.rms_norm_eps)
    act = F.silu(h2 @ layer["gate_proj"]) * (h2 @ layer["up_proj"])
    return {"q_proj": h1, "k_proj": h1, "v_proj": h1, "o_proj": ctx,
            "gate_proj": h2, "up_proj": h2, "down_proj": act}


def _col_sq(acts: torch.Tensor) -> torch.Tensor:
    """Per-input-column sum of squares in f32 (diag of the reference's H up
    to its 2/n factor, mxqgpt.py:369-383)."""
    flat = acts.reshape(-1, acts.shape[-1]).float()
    return (flat * flat).sum(dim=0)


def layer_col_sq(x, layer, cfg, cos, sin, mask, chunk: int) -> dict:
    """Each linear's column sum of squares over the samples of ``x``,
    accumulated ``chunk`` samples at a time."""
    total = None
    for c0 in range(0, x.shape[0], chunk):
        inputs = _layer_linear_inputs(x[c0:c0 + chunk], layer, cfg,
                                      cos[c0:c0 + chunk],
                                      sin[c0:c0 + chunk], mask)
        cs = {name: _col_sq(inputs[name]) for name in llama.LAYER_LINEARS}
        del inputs
        total = cs if total is None else {k: total[k] + cs[k] for k in cs}
    return total


def layer_forward(x, layer, cfg, cos, sin, mask, chunk: int):
    """The dense decoder layer on ``x``, ``chunk`` samples at a time."""
    fp_cfg = dataclasses.replace(cfg, w_bits=32, a_bits=32, kv_bits=32)
    return torch.cat([llama.decoder_layer(x[c0:c0 + chunk], layer, fp_cfg,
                                          cos[c0:c0 + chunk],
                                          sin[c0:c0 + chunk], mask)
                      for c0 in range(0, x.shape[0], chunk)])


def calibration_inputs(params, cfg: llama.LlamaConfig, input_ids,
                       dev: torch.device):
    """The first layer's input for ``input_ids`` [S, T], with the RoPE
    tables in its dtype and the causal mask: ``(x, cos, sin, mask)``."""
    ids = torch.as_tensor(input_ids, device=dev).long()
    s, t = ids.shape
    x = params["embed_tokens"][ids]
    cos, sin = llama.rope_tables(
        cfg, torch.arange(t, device=dev)[None].expand(s, t))
    return x, cos.to(x.dtype), sin.to(x.dtype), llama.causal_mask(
        t, device=dev)


def _empty_stack(p: packfmt.PackedMXQLinear,
                 layers: int) -> packfmt.PackedMXQLinear:
    return packfmt.PackedMXQLinear(
        *(torch.empty((layers,) + getattr(p, f).shape,
                      dtype=getattr(p, f).dtype, device=p.device)
          for f in packfmt.FIELDS),
        in_features=p.in_features, out_features=p.out_features)


@torch.no_grad()
def ptq_quantize(params: dict, cfg: llama.LlamaConfig, input_ids,
                 ptq: PTQConfig = PTQConfig(),
                 progress: Optional[Callable[[int], None]] = None,
                 device: str | torch.device = "cuda"):
    """Layer-sequential PTQ of ``params`` (on ``device``) against the
    calibration batch ``input_ids`` [nsamples, seqlen].

    Returns ``(qparams, packed_params)``: ``params`` with quant-dequantized
    projections in their dtype, and in packed mode the same params with
    every projection a stacked :class:`PackedMXQLinear` (unfused, one per
    linear) whose dequantized weight is ``qparams``' before the cast; None
    in reference mode. Both share the embeddings, norms and head with
    ``params``. ``progress(i)`` is called after layer ``i``."""
    if ptq.mode not in MODES:
        raise ValueError(f"PTQ mode must be one of {MODES}, not {ptq.mode!r}")
    dev = resolve_device(device)
    llama.check_params_device(params, dev)
    x, cos, sin, mask = calibration_inputs(params, cfg, input_ids, dev)
    s = x.shape[0]
    chunk = min(ptq.chunk or s, s)

    stacked = params["layers"]
    out_layers = {k: (torch.empty_like(v) if k in llama.LAYER_LINEARS
                      else v) for k, v in stacked.items()}
    packed_layers = {}
    for i in range(cfg.num_hidden_layers):
        layer = {k: v[i] for k, v in stacked.items()}
        colsq = layer_col_sq(x, layer, cfg, cos, sin, mask, chunk)
        for name in llama.LAYER_LINEARS:
            wdq, packed = _quant_weight(layer[name], colsq[name], cfg.scheme,
                                        ptq.mode)
            out_layers[name][i] = wdq
            layer[name] = out_layers[name][i]
            if packed is not None:
                if name not in packed_layers:
                    packed_layers[name] = _empty_stack(
                        packed, cfg.num_hidden_layers)
                for f in packfmt.FIELDS:
                    getattr(packed_layers[name], f)[i] = getattr(packed, f)
            del wdq, packed
        x = layer_forward(x, layer, cfg, cos, sin, mask, chunk)
        if progress is not None:
            progress(i)

    qparams = dict(params)
    qparams["layers"] = out_layers
    if ptq.mode == "reference":
        return qparams, None
    packed_params = dict(params)
    packed_params["layers"] = {**out_layers, **packed_layers}
    return qparams, packed_params
