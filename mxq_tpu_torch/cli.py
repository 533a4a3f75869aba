"""Command line of the PyTorch port (port of ``mxq_tpu/cli.py``): ``serve``
runs the slot engine and, with ``--paged``, the paged engine;
``eval-ppl`` the stride-seqlen perplexity.

    python -m mxq_tpu_torch.cli serve --preset llama2_7b --packed --kv_bits 8
    python -m mxq_tpu_torch.cli serve --preset llama2_7b --packed --kv_bits 8 \
        --paged
    python -m mxq_tpu_torch.cli serve --preset llama2_7b --packed --kv_bits 8 \
        --spec_decode                 # prompt-lookup speculative decoding
    python -m mxq_tpu_torch.cli serve --preset llama2_7b --packed --kv_bits 8 \
        --prefill_a8 --lm_head_bits 4 --prompt_len 600
    python -m mxq_tpu_torch.cli eval-ppl --preset llama2_7b \
        --dtype bfloat16 --w_bits 2 --max_eval_windows 2

Weights are random, drawn from ``--seed`` on the device (no checkpoint
loading yet); ``--w_bits`` (and for eval-ppl ``--a_bits``, ``--kv_bits``)
select the reference's fake-quant forward of the dense model. ``serve``
prints one JSON line: requests, tokens, tokens/s and the engine's stats;
``eval-ppl`` prints ``{"dataset": ..., "ppl": ...}``. The GEMV layout of
packed linears is read from ``MXQ_GEMV_LAYOUT`` / ``MXQ_GEMV_LAYOUT_B1``
(``ops/mxq_matmul.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from mxq_tpu_torch import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _model(args, dev, **bits):
    """The preset's config with the fake-quant ``bits`` and ``--layers``,
    and random weights from ``--seed`` on ``dev``."""
    from mxq_tpu_torch.models import llama

    cfg = getattr(llama.LlamaConfig, args.preset)(**bits)
    if args.layers:
        # shallow drive of a full-width preset
        cfg = dataclasses.replace(cfg, num_hidden_layers=args.layers)
    return cfg, llama.init_params(cfg, args.seed, _DTYPES[args.dtype], dev)


def _tokenizer(args):
    if args.tokenizer:
        from transformers import AutoTokenizer
        return AutoTokenizer.from_pretrained(args.tokenizer)
    return None


def cmd_eval_ppl(args) -> dict:
    from mxq_tpu_torch.eval import ppl
    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.ptq import data

    if args.model:
        raise NotImplementedError(f"--model (HF checkpoints) "
                                  f"{llama.NOT_PORTED}")
    dev = resolve_device(args.device)
    cfg, params = _model(args, dev, w_bits=args.w_bits, a_bits=args.a_bits,
                         kv_bits=args.kv_bits)
    tokens = data.get_eval_tokens(tokenizer=_tokenizer(args),
                                  vocab_size=cfg.vocab_size,
                                  dataset=args.dataset, seqlen=args.seqlen)
    out = {"dataset": args.dataset,
           "ppl": ppl.eval_ppl(params, cfg, tokens, seqlen=args.seqlen,
                               max_windows=args.max_eval_windows,
                               device=dev)}
    print(json.dumps(out), flush=True)
    return out


def cmd_serve(args) -> dict:
    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.serving import engine as eng
    from mxq_tpu_torch.serving import paged, spec

    if args.paged and args.spec_decode:
        raise SystemExit("--spec_decode applies to the slot engine "
                         "(drop --paged)")
    if args.kv_bits not in (8, 32):
        raise SystemExit(f"--kv_bits must be 8 (int8 cache or page pool) or "
                         f"32 (bf16), not {args.kv_bits}")
    if args.paged:
        if args.prefill_a8:
            print("note: --prefill_a8 applies to the slot engine only",
                  flush=True)
        if args.lm_head_bits != 16:
            print("note: --lm_head_bits applies to the slot engine only",
                  flush=True)
    dev = resolve_device(args.device)
    cfg, params = _model(args, dev, w_bits=args.w_bits)
    if args.packed:
        params = llama.quantize_params_packed(params, cfg, device=dev)
    sampling = dict(greedy=args.temperature == 0.0,
                    temperature=args.temperature or 1.0, top_k=args.top_k,
                    top_p=args.top_p, seed=args.seed)
    if args.paged:
        # bf16 pages of 64 rows, int8 pages of 128 (the paged kernels'
        # page); +1: page 0 is the reserved null page
        ps = 128 if args.kv_bits == 8 else 64
        pages = args.slots * (-(-args.max_len // ps)) + 1
        e = paged.PagedEngine(params, cfg, num_slots=args.slots,
                              total_pages=pages, page_size=ps,
                              max_len=args.max_len, kv_bits=args.kv_bits,
                              device=dev, **sampling)
    else:
        e = eng.Engine(params, cfg, eng.EngineConfig(
            num_slots=args.slots, max_len=args.max_len,
            kv_quant=args.kv_bits < 32, prefill_a8=args.prefill_a8,
            lm_head_bits=args.lm_head_bits, **sampling), device=dev)
    rng = np.random.RandomState(0)
    for _ in range(args.requests):
        e.submit(rng.randint(0, cfg.vocab_size,
                             size=args.prompt_len).astype(np.int32),
                 max_new_tokens=args.max_new_tokens)
    t0 = time.time()
    if args.spec_decode:
        run = spec.run_spec if args.spec_sync else spec.run_spec_pipelined
        done = run(e, draft_len=args.draft_len)
    else:
        done = e.run()
    dt = time.time() - t0
    total = sum(len(r.generated) for r in done)
    out = {"requests": len(done), "tokens": total,
           "tokens_per_sec": total / dt,
           "stats": {k: round(v, 4) if isinstance(v, float) else v
                     for k, v in e.stats().items()}}
    print(json.dumps(out), flush=True)
    return out


def _add_model_args(p):
    p.add_argument("--preset", default="tiny",
                   choices=["tiny", "llama2_7b", "llama2_13b", "llama2_70b"])
    p.add_argument("--layers", type=int, default=None,
                   help="override the preset's depth")
    p.add_argument("--dtype", default="float32", choices=sorted(_DTYPES))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain path")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mxq_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("serve")
    _add_model_args(p)
    p.add_argument("--w_bits", type=int, default=32)
    p.add_argument("--kv_bits", type=int, default=8)
    p.add_argument("--packed", action="store_true")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max_len", type=int, default=512)
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--prompt_len", type=int, default=8)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy; >0 samples with top_k/top_p")
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--paged", action="store_true",
                   help="the paged engine (int8 pool at --kv_bits 8)")
    p.add_argument("--prefill_a8", action="store_true",
                   help="int8 activations in prefills of 512+ tokens (K5)")
    # packed uniform-4b lm_head (EngineConfig.lm_head_bits; 16 = off)
    p.add_argument("--lm_head_bits", type=int, default=16)
    p.add_argument("--spec_decode", action="store_true",
                   help="prompt-lookup speculative decoding (greedy; "
                        "pipelined device-side drafting by default)")
    p.add_argument("--spec_sync", action="store_true",
                   help="use the synchronous one-verify-per-round-trip "
                        "loop instead of the pipelined path")
    p.add_argument("--draft_len", type=int, default=4)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("eval-ppl")
    _add_model_args(p)
    p.add_argument("--model", default=None,
                   help="HF checkpoint dir (not ported yet: raises)")
    p.add_argument("--tokenizer", default=None,
                   help="HF tokenizer for the dataset (else the synthetic "
                        "corpus)")
    p.add_argument("--dataset", default="wikitext2",
                   choices=["wikitext2", "c4", "ptb"])
    p.add_argument("--w_bits", type=int, default=32)
    p.add_argument("--a_bits", type=int, default=32)
    p.add_argument("--kv_bits", type=int, default=32)
    p.add_argument("--seqlen", type=int, default=2048)
    p.add_argument("--max_eval_windows", type=int, default=None)
    p.set_defaults(fn=cmd_eval_ppl)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
