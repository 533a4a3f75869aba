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
holds the input params, the outputs and one layer's activations.

Sharded (``mesh``, every rank under torchrun): a rank holds its rows of
the calibration batch and, between layers, only its (fsdp, tp) shard of
each weight, input (``sharding.shard_params``'s DTensors) and output alike.
Each layer is gathered whole, quantized whole on every rank and re-run on
the rank's rows, as GSPMD replicates an op it cannot split; the column
statistics of every rank's chunks are gathered and added in the order of
the rows. So the result equals, bit for bit, the unsharded run whose
``chunk`` is the sharded run's chunk.
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
from mxq_tpu_torch.parallel import multihost, sharding

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


def layer_col_sq(x, layer, cfg, cos, sin, mask, chunk: int,
                 mesh=None) -> dict:
    """Each linear's column sum of squares over the samples of ``x``,
    accumulated ``chunk`` samples at a time. On ``mesh`` ``x`` is this
    rank's rows: every rank's chunk sums are gathered and added in the
    order of the rows (one rank per slice of the batch), not in an order
    a reduction picks."""
    parts = []
    for c0 in range(0, x.shape[0], chunk):
        inputs = _layer_linear_inputs(x[c0:c0 + chunk], layer, cfg,
                                      cos[c0:c0 + chunk],
                                      sin[c0:c0 + chunk], mask)
        parts.append(torch.cat([_col_sq(inputs[name])
                                for name in llama.LAYER_LINEARS]))
        del inputs
    if mesh is not None:
        mine = torch.stack(parts)
        every = [torch.empty_like(mine)
                 for _ in range(multihost.world_size())]
        torch.distributed.all_gather(every, mine)
        parts = [c for r in multihost.data_ranks(mesh) for c in every[r]]
    total = parts[0]
    for cs in parts[1:]:
        total = total + cs
    widths = [layer[name].shape[0] for name in llama.LAYER_LINEARS]
    return dict(zip(llama.LAYER_LINEARS, total.split(widths)))


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
                 device: str | torch.device = "cuda", mesh=None):
    """Layer-sequential PTQ of ``params`` (on ``device``) against the
    calibration batch ``input_ids`` [nsamples, seqlen].

    Returns ``(qparams, packed_params)``: ``params`` with quant-dequantized
    projections in their dtype, and in packed mode the same params with
    every projection a stacked :class:`PackedMXQLinear` (unfused, one per
    linear) whose dequantized weight is ``qparams``' before the cast; None
    in reference mode. Both share the embeddings, norms and head with
    ``params``. ``progress(i)`` is called after layer ``i``.

    ``mesh`` (``sharding.make_mesh`` or ``multihost.make_hybrid_mesh``;
    every rank calls with the same arguments): each rank calibrates on its
    rows of ``input_ids`` (``nsamples`` splits over the data axes, and
    ``ptq.chunk``, by default a rank's rows, must divide them), ``params``
    may be whole or ``sharding.shard_params``' DTensors, and the returned
    projections are DTensors sharded by ``sharding.param_specs`` (dense
    and packed); ``sharding.gather_params`` makes them whole."""
    if ptq.mode not in MODES:
        raise ValueError(f"PTQ mode must be one of {MODES}, not {ptq.mode!r}")
    dev = resolve_device(device)
    llama.check_params_device(params, dev)
    ids = input_ids
    if mesh is not None:
        ids = ids[multihost.host_local_slice(len(ids), mesh)]
    x, cos, sin, mask = calibration_inputs(
        {"embed_tokens": sharding.whole(params["embed_tokens"])}, cfg, ids,
        dev)
    s = x.shape[0]
    chunk = min(ptq.chunk or s, s)
    if mesh is not None and s % chunk:
        raise ValueError(f"chunk {chunk} does not divide the {s} rows of a "
                         "data rank")

    def mine(t, spec):
        return t if mesh is None else sharding.local_of(t, spec[1:], mesh)

    def wrap(local, spec, shape):
        return local if mesh is None else sharding.from_local(
            local, spec, mesh, shape)

    nl = cfg.num_hidden_layers
    stacked = params["layers"]
    dense_spec = {k: sharding.spec_for(["layers", k], 3)
                  for k in llama.LAYER_LINEARS}
    packed_spec = {k: sharding.spec_for(["layers", k], 3, packed=True)
                   for k in llama.LAYER_LINEARS}
    out_layers = dict(stacked)
    packed_layers, shapes = {}, {}
    for i in range(nl):
        layer = {k: sharding.whole(v[i]) for k, v in stacked.items()}
        colsq = layer_col_sq(x, layer, cfg, cos, sin, mask, chunk, mesh)
        for name in llama.LAYER_LINEARS:
            wdq, packed = _quant_weight(layer[name], colsq[name], cfg.scheme,
                                        ptq.mode)
            local = mine(wdq, dense_spec[name])
            if i == 0:
                out_layers[name] = local.new_empty((nl,) + local.shape)
                shapes[name] = (nl,) + tuple(wdq.shape)
            out_layers[name][i] = local
            layer[name] = wdq
            if packed is not None:
                fields = {f: mine(getattr(packed, f), packed_spec[name])
                          for f in packfmt.FIELDS}
                if i == 0:
                    packed_layers[name] = _empty_stack(
                        dataclasses.replace(packed, **fields), nl)
                    shapes[name, "packed"] = {
                        f: (nl,) + tuple(getattr(packed, f).shape)
                        for f in packfmt.FIELDS}
                for f, t in fields.items():
                    getattr(packed_layers[name], f)[i] = t
            del wdq, packed
        x = layer_forward(x, layer, cfg, cos, sin, mask, chunk)
        if progress is not None:
            progress(i)

    for name in llama.LAYER_LINEARS:
        out_layers[name] = wrap(out_layers[name], dense_spec[name],
                                shapes[name])
        if name in packed_layers:
            p = packed_layers[name]
            packed_layers[name] = dataclasses.replace(p, **{
                f: wrap(getattr(p, f), packed_spec[name],
                        shapes[name, "packed"][f])
                for f in packfmt.FIELDS})
    qparams = dict(params)
    qparams["layers"] = out_layers
    if ptq.mode == "reference":
        return qparams, None
    packed_params = dict(params)
    packed_params["layers"] = {**out_layers, **packed_layers}
    return qparams, packed_params
