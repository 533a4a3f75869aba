"""Command line of the PyTorch port (port of ``mxq_tpu/cli.py``): ``ptq``
quantizes a model layer by layer against calibration data, ``prune``
prunes it, ``train`` fine-tunes it with quantization-aware training and
knowledge distillation, ``generate-data`` makes training data with the
model itself, ``eval-ppl`` measures the stride-seqlen perplexity, and
``serve`` runs the slot engine or, with ``--paged``, the paged engine.

    python -m mxq_tpu_torch.cli ptq --preset llama2_7b --dtype bfloat16 \
        --mode packed --nsamples 16 --chunk 4 --save_model out/7b_mxq
    python -m mxq_tpu_torch.cli ptq --model /path/to/hf_llama --mode packed
    python -m mxq_tpu_torch.cli prune --preset llama2_7b --layers 2 \
        --prune_method sparsegpt --sparsity 0.5 --nsamples 8
    python -m mxq_tpu_torch.cli prune --preset llama2_7b \
        --prune_method wanda --sparsity_type 2:4
    python -m mxq_tpu_torch.cli train --preset llama2_7b --layers 4 \
        --w_bits 2 --use_kd --batch_size 2 --block_size 2048 --max_steps 8
    python -m mxq_tpu_torch.cli generate-data --preset llama2_7b \
        --num_seeds 8 --length 128 --merge
    python -m mxq_tpu_torch.cli eval-ppl --preset llama2_7b \
        --dtype bfloat16 --w_bits 2 --max_eval_windows 2
    python -m mxq_tpu_torch.cli serve --preset llama2_7b --packed --kv_bits 8
    python -m mxq_tpu_torch.cli serve --preset llama2_7b --packed --kv_bits 8 \
        --paged
    python -m mxq_tpu_torch.cli serve --preset llama2_7b --packed --kv_bits 8 \
        --spec_decode                 # prompt-lookup speculative decoding
    python -m mxq_tpu_torch.cli serve --preset llama2_7b --packed --kv_bits 8 \
        --prefill_a8 --lm_head_bits 4 --prompt_len 600

Weights come from ``--model`` (a local HF Llama directory, read by
``models.hf_loader``) or are random, drawn from ``--seed`` on the device
for ``--preset`` (``--layers`` cuts its depth). Everything runs on
``--device`` (the card unless ``cpu`` is named). ``ptq`` prints the lines
of ``mxq_tpu``'s: ``calibrating ...``, ``  layer i done``, ``<dataset> ppl
(quantized): x``, and with ``--save_model`` writes the packed (``--mode
packed``) or quant-dequantized params with ``utils.checkpoint``; ``prune``
prints ``actual sparsity x`` and ``<dataset> ppl (pruned): x``.
``train`` (``qat/loop.py``) trains on ``--train_data`` (a JSONL of texts,
tokenized with ``--tokenizer``) or on the synthetic corpus, holds out the
first chunks for validation, resumes from the newest checkpoint in
``--output_dir``, logs every ``--log_steps`` steps and prints ``trained to
step N, eval_ppl=x``; ``generate-data`` writes ``gen.chunk.NN.jsonl``
(``qat/data.py``) and with ``--merge`` joins the shards.
``--w_bits`` (and for eval-ppl ``--a_bits``, ``--kv_bits``) select the
reference's fake-quant forward of the dense model. ``serve`` prints one
JSON line: requests, tokens, tokens/s and the engine's stats;
``eval-ppl`` prints ``{"dataset": ..., "ppl": ...}``. The GEMV layout of
packed linears is read from ``MXQ_GEMV_LAYOUT`` / ``MXQ_GEMV_LAYOUT_B1``
(``ops/mxq_matmul.py``). Calibration and training sharded over devices
(``ptq --shard``; ``mxq_tpu``'s ``train`` shards over every device it
finds) are not ported yet: ``train`` runs on one device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from mxq_tpu_torch import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _model(args, dev, **bits):
    """The model's config with the fake-quant ``bits`` and its weights on
    ``dev``: the HF checkpoint of ``--model``, or the preset's config
    (``--layers`` deep) with random weights from ``--seed``."""
    from mxq_tpu_torch.models import hf_loader, llama

    dtype = _DTYPES[args.dtype]
    if args.model:
        cfg, params = hf_loader.load_params(args.model, dtype=dtype,
                                            device=dev)
        return dataclasses.replace(cfg, **bits), params
    cfg = getattr(llama.LlamaConfig, args.preset)(**bits)
    if args.layers:
        # shallow drive of a full-width preset
        cfg = dataclasses.replace(cfg, num_hidden_layers=args.layers)
    return cfg, llama.init_params(cfg, args.seed, dtype, dev)


def _tokenizer(args):
    if args.tokenizer:
        from transformers import AutoTokenizer
        return AutoTokenizer.from_pretrained(args.tokenizer)
    return None


def _synchronized_clock(dev):
    """A clock that first waits for ``dev``'s queued work."""
    def now():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.monotonic()
    return now


def _calibration_ids(args, cfg, tok):
    from mxq_tpu_torch.ptq import data
    return data.get_calibration_batch(
        args.nsamples, args.seqlen, tokenizer=tok,
        vocab_size=cfg.vocab_size, seed=args.seed, dataset=args.dataset)


def _eval(args, params, cfg, tok, dev) -> float:
    from mxq_tpu_torch.eval import ppl
    from mxq_tpu_torch.ptq import data
    tokens = data.get_eval_tokens(tokenizer=tok, vocab_size=cfg.vocab_size,
                                  dataset=args.dataset, seqlen=args.seqlen)
    return ppl.eval_ppl(params, cfg, tokens, seqlen=args.seqlen,
                        max_windows=args.max_eval_windows, device=dev)


def cmd_ptq(args) -> dict:
    """Layer-sequential PTQ of the model, its perplexity, and with
    ``--save_model`` its checkpoint. Returns the dataset, the perplexity
    and each layer's calibration seconds."""
    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.ptq import calibrate
    from mxq_tpu_torch.utils import checkpoint

    if args.shard:
        raise NotImplementedError(f"--shard (sharded calibration) "
                                  f"{llama.NOT_PORTED}")
    dev = resolve_device(args.device)
    cfg, params = _model(args, dev)
    tok = _tokenizer(args)
    ids = _calibration_ids(args, cfg, tok)
    print(f"calibrating {cfg.num_hidden_layers} layers on "
          f"{args.nsamples}x{args.seqlen} {args.dataset} tokens "
          f"(mode={args.mode})", flush=True)
    clock = _synchronized_clock(dev)
    marks = [clock()]

    def progress(i):
        marks.append(clock())
        print(f"  layer {i} done", flush=True)

    qparams, packed = calibrate.ptq_quantize(
        params, cfg, ids,
        calibrate.PTQConfig(mode=args.mode, chunk=args.chunk),
        progress=progress, device=dev)
    p = _eval(args, qparams, cfg, tok, dev)
    print(f"{args.dataset} ppl (quantized): {p:.4f}", flush=True)
    if args.save_model:
        checkpoint.save_params(args.save_model,
                               qparams if packed is None else packed, cfg)
        print(f"saved to {args.save_model}", flush=True)
    return {"dataset": args.dataset, "ppl": p,
            "layer_seconds": [b - a for a, b in zip(marks, marks[1:])]}


def cmd_prune(args) -> dict:
    """Prune the model layer by layer (``--prune_method``, ``--sparsity``
    or n:m ``--sparsity_type``), then its perplexity, and with
    ``--save_model`` its checkpoint. Returns the dataset, the actual
    sparsity, the perplexity and the pruning's seconds."""
    from mxq_tpu_torch.ptq import prune
    from mxq_tpu_torch.utils import checkpoint

    dev = resolve_device(args.device)
    cfg, params = _model(args, dev)
    tok = _tokenizer(args)
    n = m = 0
    if args.sparsity_type and ":" in args.sparsity_type:
        n, m = (int(v) for v in args.sparsity_type.split(":"))
    ids = _calibration_ids(args, cfg, tok)
    clock = _synchronized_clock(dev)
    t0 = clock()
    pruned = prune.prune_model(params, cfg, ids, method=args.prune_method,
                               sparsity=args.sparsity, n=n, m=m, device=dev)
    seconds = clock() - t0
    sparsity = prune.check_sparsity(pruned)
    print(f"actual sparsity {sparsity:.4f}", flush=True)
    p = _eval(args, pruned, cfg, tok, dev)
    print(f"{args.dataset} ppl (pruned): {p:.4f}", flush=True)
    if args.save_model:
        checkpoint.save_params(args.save_model, pruned, cfg)
        print(f"saved to {args.save_model}", flush=True)
    return {"dataset": args.dataset, "sparsity": sparsity, "ppl": p,
            "prune_seconds": seconds}


def cmd_eval_ppl(args) -> dict:
    dev = resolve_device(args.device)
    cfg, params = _model(args, dev, w_bits=args.w_bits, a_bits=args.a_bits,
                         kv_bits=args.kv_bits)
    out = {"dataset": args.dataset,
           "ppl": _eval(args, params, cfg, _tokenizer(args), dev)}
    print(json.dumps(out), flush=True)
    return out


def cmd_train(args) -> dict:
    """QAT of the model (``--w_bits``, ``--a_bits``, ``--kv_bits``), with
    ``--use_kd`` against the same weights at full precision. Returns the
    loop's ``last_step``, ``losses`` and ``eval_ppl``."""
    from mxq_tpu_torch.ptq import data as ptq_data
    from mxq_tpu_torch.qat import data as qdata
    from mxq_tpu_torch.qat import loop, train

    dev = resolve_device(args.device)
    cfg, params = _model(args, dev, w_bits=args.w_bits, a_bits=args.a_bits,
                         kv_bits=args.kv_bits)
    teacher = _model(args, dev)[1] if args.use_kd else None
    if args.train_data and os.path.exists(args.train_data):
        tok = _tokenizer(args)
        streams = [np.asarray(tok(t)["input_ids"])
                   for t in qdata.read_jsonl_texts(args.train_data)]
    else:
        streams = [ptq_data.synthetic_corpus(cfg.vocab_size,
                                             args.block_size * 64)]
    data = qdata.chunked_dataset(streams, args.block_size)
    # the first chunks validate (eval ppl = exp of the mean loss), unless
    # the corpus is too small to spare them
    val_batches = []
    if len(data) >= 3 * args.batch_size:
        n_val = min(4 * args.batch_size, len(data) // 3)
        data, val = qdata.train_valid_split(list(data), n_val)
        data, val = np.stack(data), np.stack(val)
        val_batches = [
            {"input_ids": torch.from_numpy(
                val[i:i + args.batch_size].astype(np.int64)).to(dev)}
            for i in range(0, len(val) - args.batch_size + 1,
                           args.batch_size)][:4]
    it = qdata.batches(data, args.batch_size, epochs=args.epochs, device=dev)
    tc = train.TrainConfig(learning_rate=args.lr, use_kd=args.use_kd,
                           kd_loss_scale=args.kd_loss_scale,
                           total_steps=args.max_steps or len(data))
    lc = loop.LoopConfig(output_dir=args.output_dir,
                         save_steps=args.save_steps,
                         log_steps=args.log_steps, max_steps=args.max_steps)
    res = loop.run_training(params, teacher, cfg, tc, lc, it,
                            val_batches=val_batches, device=dev)
    print(f"trained to step {res['last_step']}"
          + (f", eval_ppl={res['eval_ppl']:.4f}" if "eval_ppl" in res
             else ""), flush=True)
    return {k: res[k] for k in ("last_step", "losses", "eval_ppl")
            if k in res}


def cmd_generate_data(args) -> dict:
    """``--num_seeds`` sequences of ``--length`` tokens from the model,
    seed tokens and sampling seeded by ``--chunk_id``, written as
    ``<out_dir>/gen.chunk.NN.jsonl``. Returns the path and the tokens."""
    from mxq_tpu_torch.qat import data as qdata

    dev = resolve_device(args.device)
    cfg, params = _model(args, dev)
    rng = np.random.RandomState(args.chunk_id)
    seeds = rng.randint(0, cfg.vocab_size,
                        size=args.num_seeds).astype(np.int32)
    out = qdata.synthesize_corpus(params, cfg, seeds, length=args.length,
                                  seed=args.chunk_id, device=dev)
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, f"gen.chunk.{args.chunk_id:02d}.jsonl")
    qdata.write_jsonl_chunk(path, out)
    print(f"wrote {path}", flush=True)
    if args.merge:
        n = qdata.merge_chunks(args.out_dir,
                               os.path.join(args.out_dir, "all_gen.jsonl"))
        print(f"merged {n} sequences", flush=True)
    return {"path": path, "tokens": out}


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
    p.add_argument("--model", default=None,
                   help="local HF Llama checkpoint directory (else "
                        "--preset with random weights)")
    p.add_argument("--preset", default="tiny",
                   choices=["tiny", "llama2_7b", "llama2_13b", "llama2_70b"])
    p.add_argument("--tokenizer", default=None,
                   help="HF tokenizer for the dataset (else the synthetic "
                        "corpus)")
    p.add_argument("--layers", type=int, default=None,
                   help="override the preset's depth")
    p.add_argument("--dtype", default="float32", choices=sorted(_DTYPES))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain path")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mxq_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("ptq")
    _add_model_args(p)
    p.add_argument("--dataset", default="wikitext2",
                   choices=["wikitext2", "c4", "ptb"])
    p.add_argument("--nsamples", type=int, default=128)
    p.add_argument("--seqlen", type=int, default=2048)
    p.add_argument("--mode", default="reference",
                   choices=["reference", "packed"])
    p.add_argument("--chunk", type=int, default=None,
                   help="calibration samples per pass (bounds activation "
                        "memory; default: all at once)")
    p.add_argument("--shard", default=None, metavar="[DCN,]DP,FSDP,TP",
                   help="sharded calibration (not ported yet: raises)")
    p.add_argument("--save_model", default=None)
    p.add_argument("--max_eval_windows", type=int, default=None)
    p.set_defaults(fn=cmd_ptq)

    p = sub.add_parser("prune")
    _add_model_args(p)
    p.add_argument("--dataset", default="wikitext2",
                   choices=["wikitext2", "c4", "ptb"])
    p.add_argument("--prune_method", default="wanda",
                   choices=["wanda", "magnitude", "sparsegpt"])
    p.add_argument("--sparsity", type=float, default=0.5)
    p.add_argument("--sparsity_type", default=None,
                   help="structured n:m, e.g. 2:4")
    p.add_argument("--nsamples", type=int, default=16)
    p.add_argument("--seqlen", type=int, default=2048)
    p.add_argument("--save_model", default=None)
    p.add_argument("--max_eval_windows", type=int, default=None)
    p.set_defaults(fn=cmd_prune)

    p = sub.add_parser("train")
    _add_model_args(p)
    p.add_argument("--w_bits", type=int, default=2)
    p.add_argument("--a_bits", type=int, default=32)
    p.add_argument("--kv_bits", type=int, default=32)
    p.add_argument("--use_kd", action="store_true", default=False)
    p.add_argument("--kd_loss_scale", type=float, default=1.0)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--block_size", type=int, default=2048)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--save_steps", type=int, default=1000)
    p.add_argument("--log_steps", type=int, default=10)
    p.add_argument("--train_data", default=None)
    p.add_argument("--output_dir", default="out/qat")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("generate-data")
    _add_model_args(p)
    p.add_argument("--chunk_id", type=int, default=0)
    p.add_argument("--num_seeds", type=int, default=16)
    p.add_argument("--length", type=int, default=128)
    p.add_argument("--out_dir", default="out/gen_data")
    p.add_argument("--merge", action="store_true")
    p.set_defaults(fn=cmd_generate_data)

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
