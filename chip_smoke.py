#!/usr/bin/env python3
"""Drive the PyTorch port (mxq_tpu_torch) on one NVIDIA H100 and check it.

    python3 chip_smoke.py                  # every phase, as the checks run it
    python3 chip_smoke.py --phases build,kernels

Phases, each printing one JSON line:
  build    compile csrc/*.cu with nvcc (one process per source, in parallel)
  kernels  hold K1-K6, K4a-K4d (K4a also with a verify's 5 query tokens
           in one launch, and with llama2_70b's G = 8 at 9 tokens: two
           launches of at most 64 query rows), K7, K8 and K9-K11 against
           their plain PyTorch versions at llama2_7b's shapes and time
           kernel, plain version, bound and library call; K1 at 8, 40
           and 128 rows, K6 at 8, 1, 40 and 128; K7 at 1, 8, 40,
           128 and 2048 rows, K8 at 8 and 128; and trace K4's gap to its
           plain version to pass A's scores (``K4-gap``)
  serve    thirteen runs of llama2_7b at full depth, each with the launch
           counts set to 0 before it and read after it:
           `mxq_tpu_torch.cli serve --preset llama2_7b --packed --kv_bits 8`
           in-process (must launch K1, K4), then the same command in a
           child process with MXQ_GEMV_LAYOUT=quad and =bfexp (K6 and no
           K1; quad's tokens equal the first run's for 7 of 8 requests),
           the Engine at 8 slots with
           prompts in every prefill bucket (K1, K3, K4), a one-slot Engine
           (K2, K4), the same with MXQ_GEMV_LAYOUT_B1=bfexp (K6-bfexp at
           one row, no K2; its greedy tokens' agreement with the K2 run
           reported); the same cli serve with --paged (K1, K11), a one-slot
           PagedEngine (K2, K11), and a PagedEngine whose 8 requests share
           a 512-token prefix (prefix-cache hits, a repeated request's
           tokens equal to its first run's); cli serve --spec_decode (K1,
           K4a); the Engine at float32 on repetitive prompts with
           speculative decoding always on (K1, K4a) and plain (K1, K4),
           every spec token plain decode's greedy choice but where that
           leads it by less than the verify round's limit against decode
           (teacher-forced along the spec tokens); cli serve --prefill_a8
           --lm_head_bits 4 with 600-token prompts (K1, K4, K5, K7); then
           where a decode step's time goes, slot (8 slots and one) and
           paged, and where a speculative verify round's does, and the
           device time of one 2048-token prefill as cli_a8_u4 runs it,
           with its top device ops and idle share
  eval     perplexity of llama2_7b at full depth: `cli eval-ppl --w_bits 2`
           (the fake-quant forward), the packed model at seqlen 128 once
           per GEMV layout (slab K1, quad and bfexp K6) and at seqlen 2048
           (K3)
  ptq      the PTQ pipeline at llama2_7b's widths: `cli ptq --mode
           packed` at full depth (16 x 2048 calibration tokens in chunks
           of 4, the checkpoint saved), the artifact bit-equal to the
           dequantized weights, the packer on the card bit-equal to the
           CPU's, the checkpoint reloaded bit for bit, the reloaded model's
           perplexity at 2048-token windows (K3), an 8-slot Engine run (K1,
           K4) and a 100-token prefill (K1) against the dense quantized
           model; `cli prune` with SparseGPT at 50% on 2 layers and Wanda
           2:4 at full depth; `cli ptq --model` on a one-layer llama2_7b
           HF checkpoint written by the port's safetensors writer
  train    QAT at llama2_7b's widths: the fake-quants on the card bit-equal
           to the CPU's; `cli train --layers 4 --w_bits 2 --use_kd` (KD
           from the full-precision weights, 2 x 2048 tokens a step, 8
           steps, checkpoints every 4): each step's loss and gradient
           norm, the median seconds per step after the first, the peak
           device memory; the same command to 12 steps resumes from step
           8; CE training of 2 layers on one repeated 256-token batch at
           lr 1e-3 cuts the loss below 0.9 x its first in 15 steps; one KD
           step at 1 layer and 128 tokens on the card against the CPU;
           `cli generate-data --layers 4`: every greedy-prefix token the
           argmax of a no-cache recompute; where a train step's device
           time goes. No repo kernel runs on this path (training holds
           dense weights)
  tasks    task evaluation (eval/harness.py) of llama2_7b at full depth:
           the packed model scores a synthetic multiple-choice task of
           random-token documents (no task data or tokenizer is in the
           repository) through MXQLM(batch_size=8), in batches of 256
           rows a linear (K1), 512 and 1024 (K3): acc, acc_norm, the ms
           per batch and idle share of each length, tokens scored per
           second; the same scores with the plain versions on the card
           (within 1e-2 nats a continuation token, picks equal where the
           top two choices lie further apart); a short request alone (K1)
           and beside a long one (K3); generate_batch (the Engine: K1, or
           K2 at one live slot) teacher-forced against greedy_generate's
           argmax; `cli eval-tasks --tasks list` (291 names) and `cli
           eval-tasks --w_bits 2` on the dense model (no repo kernel).
           Alone: `python3 chip_smoke.py --phases build,tasks`
  e2e      at 2 layers of 7B width, one B=8 decode step and one 512-token
           prefill with the kernels, held against the same forward with
           the plain versions on the card and against the CPU; one B=8
           paged decode step (K11) against the same step with the plain
           versions and against the slot engine's step from the same
           int8 state; the int8-activation prefill (K5), a decode step
           with the uniform-4b head (K7), a T=5 verify step (K4a)
           against five decode steps, and a decode step and a 128-row
           forward in each K6 layout
Then the kernel summary line, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}. Exits non-zero without a CUDA
device, without the package beside it, or when any check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (data sheet)
BF16_FLOP_PER_S = 989e12      # H100 SXM dense bf16 tensor cores (data sheet)
BOUND_BASIS = "max(bytes / 3.35 TB/s HBM, operations / 989 TFLOP/s bf16)"
INT8_OP_PER_S = 1979e12       # H100 SXM dense int8 tensor cores (data sheet)
A8_BOUND_BASIS = ("max(bytes / 3.35 TB/s HBM, 2*T*K*O operations / 1979 "
                  "TOP/s int8); bytes: x (f32) and the packed weight read, "
                  "y (f32) written")
SEED = 0
# the README's main-path command
CLI_SERVE = ["serve", "--preset", "llama2_7b", "--packed", "--kv_bits", "8",
             "--slots", "8", "--max_len", "2048", "--requests", "8",
             "--prompt_len", "100", "--max_new_tokens", "32",
             "--seed", str(SEED)]
PHASES = ("build", "kernels", "serve", "eval", "ptq", "train", "tasks",
          "e2e")

# the ptq phase's cli ptq run (its --save_model is added at run time)
PTQ_ARGV = ["ptq", "--preset", "llama2_7b", "--dtype", "bfloat16", "--mode",
            "packed", "--nsamples", "16", "--seqlen", "2048", "--chunk", "4",
            "--max_eval_windows", "2", "--seed", str(SEED)]
# the ptq phase's gates on the reloaded packed model: its perplexity (K3)
# against the dense quant-dequantized params' (relative), and a 100-token
# prefill's logits (K1) against theirs (over max|logit|), phase_e2e's
# limit for a bf16 prefill computed by other GEMMs
PTQ_PPL_GATE = 1e-2
PTQ_PREFILL_GATE = 3e-2
# the verify round's logits against decode's, over max|logit|
# (phase_e2e's limit)
SPEC_GATE = 1e-2

# the train phase's cli train run: llama2_7b's widths at 4 layers (its
# f32 weights, gradients and AdamW moments at full depth, 108 GB, outgrow
# one card); --output_dir is added at run time, and the resumed run takes
# --max_steps 12
TRAIN_ARGV = ["train", "--preset", "llama2_7b", "--layers", "4", "--w_bits",
              "2", "--use_kd", "--batch_size", "2", "--block_size", "2048",
              "--save_steps", "4", "--log_steps", "1", "--seed", str(SEED)]
# one KD step on the card against the same step on the CPU: the loss and
# the gradient norm (relative), the gradients over each leaf's max|g|, the
# updated params over max|p| (train_step_card_vs_cpu)
TRAIN_CPU_GATES = {"loss": 1e-4, "grad_norm": 1e-3, "grads": 1e-4,
                   "params": 1e-5}

# the tasks phase's synthetic task: per class (lo, hi], TASK_DOCS documents
# of TASK_CHOICES choices whose bos-prefixed requests are lo+1 to hi tokens:
# batches of 8 rows padded to 32, 64 and 128 tokens, 256 rows a linear
# (K1), 512 and 1024 (K3)
TASK_CLASSES = ((16, 32), (32, 64), (64, 128))
TASK_DOCS = 8
TASK_CHOICES = 4
# a score against the same score with the plain versions, or batched
# against alone: nats per continuation token, or FLOOR_FACTOR x the most
# a reordered f32 sum in the plain GEMV moves a score (reordered_gemv)
TASK_GATE = 1e-2
FLOOR_FACTOR = 2.0
# a generate_batch token against greedy's argmax, over max|logit| (the
# spec gate's form)
GEN_GATE = 1e-2
# the task registry (harness.TASKS + tasks_ext.TASKS_EXT): 291 names with
# sacrebleu installed (it lists wmt20's 22 pairs), 269 without
REGISTRY_TASKS_AT_LEAST = 269

# llama2_7b packed linears of one layer: name -> (out, in)
SHAPES_7B = {"qkv": (3 * 4096, 4096), "o": (4096, 4096),
             "gate_up": (2 * 11008, 4096), "down": (4096, 11008)}

KERNEL_INFO = {
    "K1": ("cuda", "mxq_tpu_torch/csrc/mxq_gemv_tc.cu",
           "mxq_tpu/ops/mxq_matmul.py:66"),
    "K2": ("cuda", "mxq_tpu_torch/csrc/mxq_gemv.cu",
           "mxq_tpu/ops/mxq_matmul.py:360"),
    "K3": ("cuda", "mxq_tpu_torch/csrc/mxq_dequant.cu",
           "mxq_tpu/ops/mxq_matmul.py:713"),
    "K4": ("cuda", "mxq_tpu_torch/csrc/attn_int8.cu",
           "mxq_tpu/ops/attn_int8.py:318"),
    "K4a": ("cuda", "mxq_tpu_torch/csrc/attn_int8.cu",
            "mxq_tpu/ops/attn_int8.py:97"),
    "K4b": ("cuda", "mxq_tpu_torch/csrc/attn_int8.cu",
            "mxq_tpu/ops/attn_int8.py:154"),
    "K4c": ("cuda", "mxq_tpu_torch/csrc/attn_int8.cu",
            "mxq_tpu/ops/attn_int8.py:232"),
    "K4d": ("cuda", "mxq_tpu_torch/csrc/attn_int8.cu",
            "mxq_tpu/ops/attn_int8.py:1101"),
    # K4a with the T query tokens of a speculative verify in one launch
    # (mxq_tpu calls _kernel once per query)
    "K4a-verify": ("cuda", "mxq_tpu_torch/csrc/attn_int8.cu",
                   "mxq_tpu/ops/attn_int8.py:97"),
    # K4a at llama2_70b's G = 8 with a verify of 9 tokens: 72 query rows
    # per kv head, two launches
    "K4a-verify-g8": ("cuda", "mxq_tpu_torch/csrc/attn_int8.cu",
                      "mxq_tpu/ops/attn_int8.py:97"),
    "K5": ("cuda", "mxq_tpu_torch/csrc/mxq_dequant.cu",
           "mxq_tpu/ops/mxq_matmul.py:856"),
    # K6's summary rows are at B=8: the tensor-core template. At one row
    # quad runs K2's kernel and bfexp its own (bfexp_row_kernel), both in
    # mxq_gemv.cu: K6-bfexp-1 is bfexp's B=1 row. K6-bfexp's wrapper
    # counts both kernels; the serve phase gives each row its own launches
    "K6-quad": ("cuda", "mxq_tpu_torch/csrc/mxq_gemv_tc.cu",
                "mxq_tpu/ops/mxq_matmul.py:169"),
    "K6-bfexp": ("cuda", "mxq_tpu_torch/csrc/mxq_gemv_tc.cu",
                 "mxq_tpu/ops/mxq_matmul.py:252"),
    "K6-bfexp-1": ("cuda", "mxq_tpu_torch/csrc/mxq_gemv.cu",
                   "mxq_tpu/ops/mxq_matmul.py:252"),
    "K7": ("cuda", "mxq_tpu_torch/csrc/uniform_gemv.cu",
           "mxq_tpu/ops/uniform4.py:117"),
    "K8": ("cuda", "mxq_tpu_torch/csrc/uniform_gemv.cu",
           "mxq_tpu/ops/uniform4.py:292"),
    "K9": ("cuda", "mxq_tpu_torch/csrc/paged_attn_int8.cu",
           "mxq_tpu/ops/attn_int8.py:559"),
    "K10": ("cuda", "mxq_tpu_torch/csrc/paged_attn_int8.cu",
            "mxq_tpu/ops/attn_int8.py:658"),
    "K11": ("cuda", "mxq_tpu_torch/csrc/paged_attn_int8.cu",
            "mxq_tpu/ops/attn_int8.py:773"),
}


# K1's kernels by name (csrc/mxq_gemv_tc.cu: x's slot-order pass, the two
# mainloops, the split sum); in the profiled decode steps no other wrapper
# launches a kernel of these names
K1_KERNEL_NAMES = ("permute_x_kernel", "gemv_small_kernel",
                   "gemv_large_kernel", "reduce_splits_kernel")
# K2's (csrc/mxq_gemv.cu: the one-row kernel and its split sum); in the
# profiled one-slot step no other wrapper launches a kernel of these names
K2_KERNEL_NAMES = ("gemv_row_kernel", "gemv_row_sum_kernel")
# K5's (csrc/mxq_dequant.cu: the bound, then the codes)
K5_KERNEL_NAMES = ("k5_scale_kernel", "k5_codes_kernel")
# the A8 prefill's device time by kind, first match by name; the rest is
# "other": PyTorch's elementwise ops, copies and reductions
PREFILL_GROUPS = (("K5", K5_KERNEL_NAMES),
                  ("K7", ("uniform_small_kernel", "uniform_large_kernel")),
                  ("attention (library)", ("flash", "fmha", "attention")),
                  ("GEMM (library)", ("gemm", "cutlass", "xmma")))

# a loglikelihood batch's device time by kind (the tasks phase), first
# match by name
TASK_GROUPS = (("K1", K1_KERNEL_NAMES), ("K3", ("mxq_dequant_kernel",)),
               ("attention (library)", ("flash", "fmha", "attention")),
               ("GEMM (library)", ("gemm", "cutlass", "xmma", "nvjet")))

# summary rows counted by another kernel's wrapper
COUNTER = {"K4a-verify": "K4a", "K4a-verify-g8": "K4a"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median of CUDA-event timings of device work. Before every timed call
    the L2 cache (50 MB) is flushed, as the decode path finds weights cold:
    256 MB are written, then read, so that the write-back of the written
    lines falls before the first event and L2 holds no dirty line. Then
    the card spins for about a millisecond so that the host has queued the
    whole call before the first event: the events then bracket device
    time, not the wrapper's Python overhead."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 * 2**20, dtype=torch.uint8,
                                 device="cuda")

    def __call__(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        ts = []
        for _ in range(iters):
            self.flush.zero_()
            self.flush.view(torch.float32).sum()
            torch.cuda._sleep(2_000_000)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            ts.append(e0.elapsed_time(e1))
        return statistics.median(ts)


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def packed_bytes(p) -> int:
    return sum(t.numel() * t.element_size()
               for t in (p.w2, p.w4, p.meta2, p.qscale, p.qmin, p.smeta4))


def summarise(rows, shape: str) -> dict:
    """One kernel's line of the summary: its rows' times added up (one
    layer's linears), the worst error."""
    lib = [r["library_ms"] for r in rows]
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=sum(r["kernel_ms"] for r in rows),
                plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=sum(r["bound_ms"] for r in rows),
                bound_by=("bytes" if all(r["bound_by"] == "bytes"
                                         for r in rows) else "operations"),
                library_ms=None if None in lib else sum(lib), shape=shape)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build():
    from mxq_tpu_torch import _build
    t0 = time.monotonic()
    took = _build.build(verbose=True, force=True)
    emit({"phase": "build", "seconds": round(time.monotonic() - t0, 2),
          "per_source_s": {k: round(v, 2) for k, v in took.items()},
          "card": smi()})


def phase_kernels(torch, timer):
    from mxq_tpu_torch import packfmt
    from mxq_tpu_torch.ops import attn_int8 as a8
    from mxq_tpu_torch.ops import mxq_matmul as mm

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    failures, rows, packs, summary = [], [], {}, {}
    for name, (o, k) in SHAPES_7B.items():
        w = torch.randn((o, k), generator=gen, device="cuda") / math.sqrt(k)
        packs[name] = packfmt.quantize_pack(w)
        del w

    # K1 at B=8 (decode), 40 (a verify round) and 128 (a prefill bucket,
    # an eval window): tensor cores; K2 (B=1): f32 FMA on CUDA cores.
    # Gate 1e-4 of max|y|.
    for key, batches in (("K2", (1,)), ("K1", (8, 40, 128))):
        for b in batches:
            for name, p in packs.items():
                x = torch.randn((b, p.in_features), generator=gen,
                                device="cuda").to(torch.bfloat16)
                fn = mm.gemv_single if key == "K2" else mm.gemv_batched
                y = fn(x, p)
                ref = mm.gemv_plain(x, p)
                torch.cuda.synchronize()
                err = rel_err(y, ref)
                wbf = packfmt.unpack_dequant(p).to(torch.bfloat16)
                nbytes = (packed_bytes(p) + x.numel() * 2
                          + b * p.out_features * 4)
                bms, by = bound_ms(nbytes, 2.0 * b * p.in_features
                                   * p.out_features)
                row = {"kernel": key, "linear": name, "B": b,
                       "rel_err": err,
                       "max_abs_err": float((y - ref).abs().max()),
                       "kernel_ms": timer(lambda: fn(x, p)),
                       "plain_ms": timer(lambda: mm.gemv_plain(x, p),
                                         iters=3),
                       "bound_ms": bms, "bound_by": by,
                       "library_ms": timer(lambda: x @ wbf)}
                del wbf
                rows.append(row)
                emit({"phase": "kernels", "bound_basis": BOUND_BASIS, **row})
                if not err <= 1e-4:
                    failures.append(f"{key} {name} B={b}: rel {err:.3g}")
        b0 = batches[0]
        summary[key] = summarise(
            [r for r in rows if r["kernel"] == key and r["B"] == b0],
            f"one llama2_7b layer (qkv, o, gate_up, down), B={b0}")

    # K3: bit-equal to its plain version (compiled with --fmad=false)
    for name, p in packs.items():
        wd2, wd4 = mm.dequant_planes(p)
        r2, r4 = mm.dequant_planes_plain(p)
        torch.cuda.synchronize()
        same = torch.equal(wd2.view(torch.int16), r2.view(torch.int16)) \
            and torch.equal(wd4.view(torch.int16), r4.view(torch.int16))
        err = max(float((wd2.float() - r2.float()).abs().max()),
                  float((wd4.float() - r4.float()).abs().max()))
        nbytes = packed_bytes(p) + (wd2.numel() + wd4.numel()) * 2
        bms, by = bound_ms(nbytes, 0.0)
        row = {"kernel": "K3", "linear": name, "bit_equal": same,
               "max_abs_err": err,
               "kernel_ms": timer(lambda: mm.dequant_planes(p)),
               "plain_ms": timer(lambda: mm.dequant_planes_plain(p), iters=3),
               "bound_ms": bms, "bound_by": by, "library_ms": None}
        rows.append(row)
        emit({"phase": "kernels", "bound_basis": BOUND_BASIS, **row})
        if not same:
            failures.append(f"K3 {name}: not bit-equal (max abs {err:.3g})")
    summary["K3"] = summarise([r for r in rows if r["kernel"] == "K3"],
                              "one llama2_7b layer (qkv, o, gate_up, down)")
    failures += a8_kernels(torch, timer, gen, packs, rows, summary)
    failures += layout_kernels(torch, timer, gen, packs, rows, summary)
    del packs

    # K4: B=8, Hq=Hkv=32, D=128, S=2048, positions incl. 0 and 2046
    L, B, H, S, D = 2, 8, 32, 2048, 128
    idx = 1
    kc = torch.randint(-127, 128, (L, B, H, S, D), generator=gen,
                       device="cuda", dtype=torch.int8)
    vc = torch.randint(-127, 128, (L, B, H, S, D), generator=gen,
                       device="cuda", dtype=torch.int8)
    ks = (torch.rand((L, B, H, S), generator=gen, device="cuda") * 0.02
          + 0.001).to(torch.bfloat16)
    vs = (torch.rand((L, B, H, S), generator=gen, device="cuda") * 0.02
          + 0.001).to(torch.bfloat16)
    q = torch.randn((B, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    kcur = torch.randint(-127, 128, (B, H, 1, D), generator=gen,
                         device="cuda", dtype=torch.int8)
    vcur = torch.randint(-127, 128, (B, H, 1, D), generator=gen,
                         device="cuda", dtype=torch.int8)
    kscur = torch.full((B, H, 1), 0.015, dtype=torch.bfloat16, device="cuda")
    vscur = torch.full((B, H, 1), 0.012, dtype=torch.bfloat16, device="cuda")
    positions = torch.tensor([0, 1, 17, 300, 1024, 1500, 2000, 2046],
                             dtype=torch.int32, device="cuda")
    kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    ctx, _, _ = a8.int8_decode_attention_fused_write(
        q, kc1, ks, vc1, vs, kcur, kscur, vcur, vscur, idx, positions)
    ref, _, _ = a8.int8_decode_attention_fused_write_plain(
        q, kc2, ks, vc2, vs, kcur, kscur, vcur, vscur, idx, positions)
    torch.cuda.synchronize()
    err = rel_err(ctx, ref)
    k4_gap(torch, q, kc, ks, vc, vs, (kcur, kscur, vcur, vscur), idx,
           positions, ref)
    written_ok = torch.equal(kc1, kc2) and torch.equal(vc1, vc2)
    rws = torch.arange(B, device="cuda")
    kc[idx, rws, :, positions.long()] = kcur[:, :, 0]
    vc[idx, rws, :, positions.long()] = vcur[:, :, 0]
    rest_ok = torch.equal(kc1, kc) and torch.equal(vc1, vc)
    # SDPA over the dequantized bf16 K/V, masked to rows <= pos
    kd = (kc[idx].float() * ks[idx].float()[..., None]).to(torch.bfloat16)
    vd = (vc[idx].float() * vs[idx].float()[..., None]).to(torch.bfloat16)
    amask = (torch.arange(S, device="cuda")[None, None, None, :]
             <= positions[:, None, None, None])
    qs = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    hist = int(positions.sum())           # cache rows this call reads
    nbytes = (2 * hist * H * D + 2 * hist * H * 2 + B * H * D * 2
              + 2 * B * H * (D + 2) + B * 4 + B * H * D * 4 + 2 * B * H * D)
    bms, by = bound_ms(nbytes, 4.0 * hist * H * D)
    row = {"kernel": "K4", "B": B, "H": H, "S": S, "D": D,
           "rel_err": err, "max_abs_err": float((ctx - ref).abs().max()),
           "written_rows_equal": written_ok, "rest_unchanged": rest_ok,
           "kernel_ms": timer(lambda: a8.int8_decode_attention_fused_write(
               q, kc1, ks, vc1, vs, kcur, kscur, vcur, vscur, idx,
               positions)),
           "plain_ms": timer(
               lambda: a8.int8_decode_attention_fused_write_plain(
                   q, kc2, ks, vc2, vs, kcur, kscur, vcur, vscur, idx,
                   positions), iters=3),
           "bound_ms": bms, "bound_by": by,
           "library_ms": timer(lambda: sdpa(qs, kd, vd, attn_mask=amask))}
    rows.append(row)
    emit({"phase": "kernels", "bound_basis": BOUND_BASIS, **row})
    if not (err <= 1e-3 and written_ok and rest_ok):
        failures.append(f"K4: rel {err:.3g} written={written_ok} "
                        f"rest={rest_ok}")
    summary["K4"] = summarise(
        [row], "B=8 Hq=Hkv=32 D=128 S=2048, mixed positions")
    del kc1, vc1, kc2, vc2, kd, vd
    failures += attention_flag_kernels(
        torch, timer, rows, summary, q, kc, ks, vc, vs,
        (kcur, kscur, vcur, vscur), idx, positions)
    del kc, vc
    failures += paged_kernels(torch, timer, gen, rows, summary)
    failures += uniform_kernels(torch, timer, gen, rows, summary)
    return summary, failures


def attention_flag_kernels(torch, timer, rows, summary, q, kc, ks, vc, vs,
                           cur, idx, positions):
    """K4a/K4c (rows <= pos, no current token) and K4b/K4d (rows < pos plus
    the current token, no write) at K4's shapes and positions: the K4a
    call on a layer view, the K4c call on the stack (one launch, one
    counter), likewise K4b and K4d. Plus the verify-shaped K4a call
    (``K4a-verify``): 5 query tokens per slot in one launch, token t over
    rows <= pos + t (pos capped at S - 5), against its plain version and
    against five single-query launches. Gate ctx rel <= 1e-3; the cache
    must be left byte for byte."""
    from mxq_tpu_torch.ops import attn_int8 as a8
    B, H, S, D = q.shape[0], q.shape[1], kc.shape[3], q.shape[2]
    kscur, vscur = cur[1], cur[3]
    kc0, vc0 = kc.clone(), vc.clone()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs = q[:, :, None, :]
    rws = torch.arange(B, device="cuda")
    pos = positions.long()
    # the library yardstick: SDPA over the dequantized bf16 layer, masked
    # to rows <= pos; for K4b/K4d row pos holds the current token (codes
    # and scales), which attending rows < pos plus that token is
    ks_c, vs_c = ks[idx].clone(), vs[idx].clone()
    kc_c, vc_c = kc[idx].clone(), vc[idx].clone()
    kc_c[rws, :, pos] = cur[0][:, :, 0]
    vc_c[rws, :, pos] = cur[2][:, :, 0]
    ks_c[rws, :, pos] = kscur[:, :, 0]
    vs_c[rws, :, pos] = vscur[:, :, 0]

    def dequant(c, sc):
        return (c.float() * sc.float()[..., None]).to(torch.bfloat16)

    lib_a = (dequant(kc[idx], ks[idx]), dequant(vc[idx], vs[idx]))
    lib_b = (dequant(kc_c, ks_c), dequant(vc_c, vs_c))
    del kc_c, vc_c, ks_c, vs_c
    amask = (torch.arange(S, device="cuda")[None, None, None, :]
             <= positions[:, None, None, None])
    stacked = (kc, ks, vc, vs)
    view = (kc[idx], ks[idx], vc[idx], vs[idx])
    calls = {
        "K4a": (lambda: a8.int8_decode_attention(q, *view, positions),
                lambda: a8.int8_decode_attention_stacked_plain(
                    q, *stacked, idx, positions), lib_a, False),
        "K4c": (lambda: a8.int8_decode_attention_stacked(
                    q, *stacked, idx, positions),
                lambda: a8.int8_decode_attention_stacked_plain(
                    q, *stacked, idx, positions), lib_a, False),
        "K4b": (lambda: a8.int8_decode_attention_cur(
                    q, *view, *cur, positions),
                lambda: a8.int8_decode_attention_cur_folded_plain(
                    q, *stacked, *cur, idx, positions), lib_b, True),
        "K4d": (lambda: a8.int8_decode_attention_cur_folded(
                    q, *stacked, *cur, idx, positions),
                lambda: a8.int8_decode_attention_cur_folded_plain(
                    q, *stacked, *cur, idx, positions), lib_b, True)}
    failures = []
    for key, (fn, plain, (kd, vd), has_cur) in calls.items():
        out, ref = fn(), plain()
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        # rows each (b, h) reads: < pos with the current token, <= pos
        # without it
        nrows = int((positions if has_cur else positions + 1)
                    .clamp(max=S).sum())
        nbytes = (nrows * H * (2 * D + 2 * 2) + B * H * D * 2 + B * 4
                  + B * H * D * 4 + (2 * B * H * (D + 2) if has_cur else 0))
        bms, by = bound_ms(nbytes, 4.0 * (nrows + (B if has_cur else 0))
                           * H * D)
        row = {"kernel": key, "B": B, "H": H, "S": S, "D": D,
               "rel_err": err, "max_abs_err": float((out - ref).abs().max()),
               "kernel_ms": timer(fn), "plain_ms": timer(plain, iters=3),
               "bound_ms": bms, "bound_by": by,
               "library_ms": timer(lambda: sdpa(qs, kd, vd,
                                                attn_mask=amask))}
        untouched = torch.equal(kc, kc0) and torch.equal(vc, vc0)
        row["cache_untouched"] = untouched
        rows.append(row)
        emit({"phase": "kernels", "bound_basis": BOUND_BASIS, **row})
        if not (err <= 1e-3 and untouched):
            failures.append(f"{key}: rel {err:.3g} cache untouched "
                            f"{untouched}")
        summary[key] = summarise(
            [row], "B=8 Hq=Hkv=32 D=128 S=2048, mixed positions, "
            + ("rows < pos + current token" if has_cur else "rows <= pos"))
    failures += verify_kernel(torch, timer, rows, summary, stacked, idx,
                              positions, lib_a, kc0, vc0)
    failures += verify_g8_kernel(torch, timer, rows, summary)
    return failures


def verify_kernel(torch, timer, rows, summary, stacked, idx, positions,
                  lib, kc0, vc0, t=5):
    """K4a with a speculative verify's ``t`` query tokens per slot in one
    launch (q [B, t, Hq, D], token i over rows <= pos + i), against its
    plain version (t single-query plain calls) and against t single-query
    launches; SDPA over the dequantized layer with the same per-token
    masks as the library yardstick."""
    from mxq_tpu_torch.ops import attn_int8 as a8
    kc, ks, vc, vs = stacked
    B, H, S, D = kc.shape[1], kc.shape[2], kc.shape[3], kc.shape[4]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    qv = torch.randn((B, t, H, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    vpos = positions.clamp(max=S - t)
    fn = lambda: a8.int8_decode_attention_stacked(  # noqa: E731
        qv, *stacked, idx, vpos)
    before = a8.int8_decode_attention_stacked.launches
    out = fn()
    one_launch = a8.int8_decode_attention_stacked.launches == before + 1
    ref = a8.int8_decode_attention_stacked_plain(qv, *stacked, idx, vpos)
    singles = lambda: [a8.int8_decode_attention_stacked(  # noqa: E731
        qv[:, i].contiguous(), *stacked, idx, vpos + i) for i in range(t)]
    single = torch.stack(singles(), dim=1)
    torch.cuda.synchronize()
    err = rel_err(out, ref)
    err_single = rel_err(out, single)
    # rows read once: <= pos + t - 1; token i's scores over pos + i + 1
    nrows = int((vpos + t).sum())
    nscored = sum(int((vpos + i + 1).sum()) for i in range(t))
    nbytes = (nrows * H * (2 * D + 2 * 2) + B * t * H * D * (2 + 4)
              + B * 4)
    bms, by = bound_ms(nbytes, 4.0 * nscored * H * D)
    amask = (torch.arange(S, device="cuda")[None, None, None, :]
             <= (vpos[:, None] + torch.arange(t, device="cuda"))[
                 :, None, :, None])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs = qv.transpose(1, 2)
    kd, vd = lib
    untouched = torch.equal(kc, kc0) and torch.equal(vc, vc0)
    row = {"kernel": "K4a-verify", "B": B, "T": t, "H": H, "S": S, "D": D,
           "rel_err": err, "rel_err_vs_single_query_launches": err_single,
           "max_abs_err": float((out - ref).abs().max()),
           "one_launch": one_launch, "cache_untouched": untouched,
           "kernel_ms": timer(fn),
           "single_query_launches_ms": timer(singles),
           "plain_ms": timer(lambda: a8.int8_decode_attention_stacked_plain(
               qv, *stacked, idx, vpos), iters=3),
           "bound_ms": bms, "bound_by": by,
           "library_ms": timer(lambda: sdpa(qs, kd, vd, attn_mask=amask))}
    rows.append(row)
    emit({"phase": "kernels", "bound_basis": BOUND_BASIS, **row})
    summary["K4a-verify"] = summarise(
        [row], f"B=8 T={t} Hq=Hkv=32 D=128 S=2048, mixed positions, token "
        "t over rows <= pos + t, one launch")
    if not (err <= 1e-3 and err_single <= 1e-3 and one_launch
            and untouched):
        return [f"K4a-verify: rel {err:.3g}, vs single launches "
                f"{err_single:.3g}, one launch {one_launch}, cache "
                f"untouched {untouched}"]
    return []


def verify_g8_kernel(torch, timer, rows, summary, t=9):
    """K4a at llama2_70b's GQA (Hq=64, Hkv=8: G=8) with a verify of
    ``t`` = 9 tokens per slot: 72 query rows per kv head, more than one
    launch takes (64), so the wrapper makes one launch per 8 tokens.
    Against its plain version (gate 1e-5, the K4 family's), the launch
    count, the cache left byte for byte; SDPA over the dequantized layer
    as the library yardstick."""
    from mxq_tpu_torch.ops import attn_int8 as a8
    B, Hq, Hkv, S, D = 8, 64, 8, 2048, 128
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    cat = dict(generator=gen, device="cuda")
    kc = torch.randint(-127, 128, (1, B, Hkv, S, D), dtype=torch.int8, **cat)
    vc = torch.randint(-127, 128, (1, B, Hkv, S, D), dtype=torch.int8, **cat)
    ks = (torch.rand((1, B, Hkv, S), **cat) * 0.02 + 0.001).to(torch.bfloat16)
    vs = (torch.rand((1, B, Hkv, S), **cat) * 0.02 + 0.001).to(torch.bfloat16)
    q = torch.randn((B, t, Hq, D), **cat).to(torch.bfloat16)
    pos = torch.tensor([0, 1, 17, 300, 1024, 1500, 2000, 2046],
                       dtype=torch.int32, device="cuda").clamp(max=S - t)
    kc0, vc0 = kc.clone(), vc.clone()
    fn = lambda: a8.int8_decode_attention_stacked(  # noqa: E731
        q, kc, ks, vc, vs, 0, pos)
    before = a8.int8_decode_attention_stacked.launches
    out = fn()
    launched = a8.int8_decode_attention_stacked.launches - before
    ref = a8.int8_decode_attention_stacked_plain(q, kc, ks, vc, vs, 0, pos)
    torch.cuda.synchronize()
    err = rel_err(out, ref)
    untouched = torch.equal(kc, kc0) and torch.equal(vc, vc0)
    want = len(a8.token_chunks(Hq // Hkv, t))
    # the function reads each (b, kv head)'s rows <= pos + t - 1 once
    # (the launches' re-reads are the kernel's cost, not the bound's);
    # token i's scores over pos + i + 1
    nrows = int((pos + t).sum())
    nscored = sum(int((pos + i + 1).sum()) for i in range(t)) * Hq // Hkv
    nbytes = (nrows * Hkv * (2 * D + 2 * 2) + B * t * Hq * D * (2 + 4)
              + B * 4)
    bms, by = bound_ms(nbytes, 4.0 * nscored * Hkv * D)
    kd = (kc[0].float() * ks[0].float()[..., None]).to(torch.bfloat16)
    vd = (vc[0].float() * vs[0].float()[..., None]).to(torch.bfloat16)
    kd, vd = (a.repeat_interleave(Hq // Hkv, dim=1) for a in (kd, vd))
    amask = (torch.arange(S, device="cuda")[None, None, None, :]
             <= (pos[:, None] + torch.arange(t, device="cuda"))[
                 :, None, :, None])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs = q.transpose(1, 2)
    row = {"kernel": "K4a-verify-g8", "B": B, "T": t, "Hq": Hq, "Hkv": Hkv,
           "S": S, "D": D, "rel_err": err,
           "max_abs_err": float((out - ref).abs().max()),
           "launches_per_call": launched, "cache_untouched": untouched,
           "kernel_ms": timer(fn),
           "plain_ms": timer(lambda: a8.int8_decode_attention_stacked_plain(
               q, kc, ks, vc, vs, 0, pos), iters=3),
           "bound_ms": bms, "bound_by": by,
           "library_ms": timer(lambda: sdpa(qs, kd, vd, attn_mask=amask))}
    rows.append(row)
    emit({"phase": "kernels", "bound_basis": BOUND_BASIS, **row})
    summary["K4a-verify-g8"] = summarise(
        [row], f"B=8 T={t} Hq=64 Hkv=8 D=128 S=2048, mixed positions, "
        f"{want} launches of at most 64 query rows per kv head")
    if not (err <= 1e-5 and launched == want == 2 and untouched):
        return [f"K4a-verify-g8: rel {err:.3g}, {launched} launches (want "
                f"{want}), cache untouched {untouched}"]
    return []


def k4_gap(torch, q, kc, ks, vc, vs, cur, idx, positions, ref):
    """Where K4's gap to its plain version comes from. Runs K4's kernel
    once more (outside the wrapper: not counted) and reads pass A's stored
    scores from its scratch. For the worst output element (b, head,
    d) it reports the history rows whose score differs from the plain
    version's (and by how many f32 ulps), which side's scores equal the
    correctly rounded one (the dot product in f64, rounded to f32, times
    the same f32 k_scale * scale), and the bf16(p * v_scale) values that
    the differing scores flip. Then it recomputes the plain version with
    the kernel's scores: if that equals the kernel's output (~1e-7) and
    not the plain one, the scores explain the whole gap."""
    from mxq_tpu_torch.ops import attn_int8 as a8
    kcur, kscur, vcur, vscur = cur
    B, H, D = q.shape
    S = kc.shape[3]
    scale = 1.0 / math.sqrt(D)
    kept = []
    out, _ = a8._dense_launch("K4 (gap diagnostic)", q, kc.clone(), ks,
                              vc.clone(), vs, idx, positions, cur,
                              write=True, scratch=kept)
    torch.cuda.synchronize()
    sc_k, stc_k = a8.scratch_scores(kept[0], B, H, 1, -(-S // a8.CHUNK))
    sc_k, stc_k = sc_k[:, :, 0, :S], stc_k[:, :, 0]
    # the plain version's scores, op for op (_attend_plain, G = 1)
    ksf = ks[idx].float() * scale
    qf = q.float()[:, :, None, :]
    st_p = (torch.einsum("bhgd,bhsd->bhgs", qf, kc[idx].float())
            * ksf[:, :, None, :])[:, :, 0]
    st_x = (torch.einsum("bhd,bhsd->bhs", q.double(), kc[idx].double())
            .float() * ksf)
    stc_p = (torch.einsum("bhgd,bhsd->bhgs", qf, kcur.float())
             * (kscur.float() * scale)[:, :, None, :])[:, :, 0, 0]
    valid = (torch.arange(S, device=q.device)[None, None, :]
             < positions[:, None, None]).expand(B, H, S)

    def finish(st, stc):
        """The plain version's tail (_attend_plain) from given scores."""
        st = torch.where(valid, st, torch.full_like(st, a8.NEG))
        m = torch.maximum(st.amax(-1), stc)
        e = torch.exp(st - m[..., None])
        pv = (e * vs[idx].float()).to(torch.bfloat16).float()
        ec = torch.exp(stc - m)
        ctx = torch.einsum("bhgs,bhsd->bhgd", pv[:, :, None],
                           vc[idx].float())[:, :, 0]
        ctx = ctx + ((ec * vscur[:, :, 0].float()).to(torch.bfloat16)
                     .float()[..., None] * vcur[:, :, 0].float())
        return ctx / (e.sum(-1) + ec)[..., None], pv

    swap, pv_k = finish(sc_k, stc_k)
    plain, pv_p = finish(st_p, stc_p)
    diff = (out - ref).abs()
    b, h, d = (int(i) for i in torch.unravel_index(diff.argmax(), diff.shape))
    n = int(positions[b])
    dk, dp = sc_k[b, h, :n], st_p[b, h, :n]
    differ = dk != dp
    ulp = (torch.nextafter(dp, torch.full_like(dp, math.inf)) - dp).abs()
    flips = (pv_k[b, h, :n] != pv_p[b, h, :n])
    row = {"kernel": "K4-gap", "worst_b_head_d": [b, h, d], "rows": n,
           "rel_err": rel_err(out, ref),
           "plain_recomputed_rel_vs_plain": rel_err(plain, ref),
           "score_rows_differing": int(differ.sum()),
           "score_max_ulps": float(((dk - dp).abs() / ulp).max())
           if n else 0.0,
           "kernel_scores_correctly_rounded": int(
               (dk == st_x[b, h, :n])[differ].sum()),
           "plain_scores_correctly_rounded": int(
               (dp == st_x[b, h, :n])[differ].sum()),
           "current_logit_differs": bool(stc_k[b, h] != stc_p[b, h]),
           "pv_flips_worst_head": int(flips.sum()),
           "pv_flips_all_heads": int((pv_k != pv_p)[valid].sum()),
           "score_rows_differing_all_heads": int(
               (sc_k != st_p)[valid].sum()),
           "rows_all_heads": int(valid.sum()),
           "plain_with_kernel_scores_rel_vs_kernel": rel_err(swap, out),
           "plain_with_kernel_scores_rel_vs_plain": rel_err(swap, ref)}
    emit({"phase": "kernels", **row})


def a8_kernels(torch, timer, gen, packs, rows, summary):
    """K5 at the four 7B linears: its bound sw and codes q against the plain
    version's (equal bit for bit: each operation rounded once, IEEE
    division), and mxq_matmul_prefill_a8 through K5 against the same
    through the plain version at 512 rows (<= 5e-3 * max|y|), timed at 512
    and 2048 rows beside the bf16-plane K3 path and the A8 linear's own
    bound (A8_BOUND_BASIS)."""
    from mxq_tpu_torch.ops import attn_int8 as a8
    from mxq_tpu_torch.ops import mxq_matmul as mm
    failures = []
    for name, p in packs.items():
        sw, q = mm.dequant_int8_planes(p)
        rsw, rq = mm.dequant_int8_planes_plain(p)
        torch.cuda.synchronize()
        same = torch.equal(sw, rsw) and torch.equal(q, rq)
        ndiff = int((q != rq).sum())
        maxd = max(float((sw - rsw).abs().max()),
                   float((q.int() - rq.int()).abs().max()))
        # the packed weight and its meta read once, sw and q written once
        nbytes = packed_bytes(p) + sw.numel() * 4 + q.numel()
        bms, by = bound_ms(nbytes, 0.0)
        del sw, q, rsw, rq
        row = {"kernel": "K5", "linear": name, "bit_equal": same,
               "codes_differing": ndiff, "max_abs_err": maxd,
               "kernel_ms": timer(lambda: mm.dequant_int8_planes(p)),
               "plain_ms": timer(lambda: mm.dequant_int8_planes_plain(p),
                                 iters=3),
               "bound_ms": bms, "bound_by": by, "library_ms": None,
               "a8_linear_bound_basis": A8_BOUND_BASIS}
        for t in (512, 2048):
            x = torch.randn((t, p.in_features), generator=gen, device="cuda")
            if t == 512:
                y = mm.mxq_matmul_prefill_a8(x, p)
                with plain_versions(mm, a8):
                    ref = mm.mxq_matmul_prefill_a8(x, p)
                torch.cuda.synchronize()
                row["a8_linear_512_rel_err"] = yerr = rel_err(y, ref)
                del y, ref
            lbytes = (x.numel() * 4 + packed_bytes(p)
                      + t * p.out_features * 4)
            lops = 2.0 * t * p.in_features * p.out_features
            row[f"a8_linear_{t}_bound_ms"] = max(
                lbytes / HBM_BYTES_PER_S, lops / INT8_OP_PER_S) * 1e3
            row[f"a8_linear_{t}_ms"] = timer(
                lambda: mm.mxq_matmul_prefill_a8(x, p))
            row[f"k3_linear_{t}_ms"] = timer(
                lambda: mm.mxq_matmul_prefill(x, p))
            del x
        rows.append(row)
        emit({"phase": "kernels", "bound_basis": BOUND_BASIS, **row})
        if not (same and yerr <= 5e-3):
            failures.append(f"K5 {name}: bit_equal {same} ({ndiff} codes "
                            f"differ, max {maxd:.3g}), a8 linear rel "
                            f"{yerr:.3g}")
    summary["K5"] = summarise([r for r in rows if r["kernel"] == "K5"],
                              "one llama2_7b layer (qkv, o, gate_up, down)")
    return failures


def layout_kernels(torch, timer, gen, packs, rows, summary):
    """K6, the quad and bfexp GEMV layouts, at the four 7B linears and
    B = 8, 1 (reached through MXQ_GEMV_LAYOUT_B1), 40 (a verify round)
    and 128 (an eval window). Gates, as rel = max|diff| / max|y|: quad
    <= 1e-4 against gemv_plain (K1's function) and equal to K1's, or at
    B=1 K2's, output bit for bit (``equal_to_k1``: the same operands and
    sums in the same order); bfexp <= 1e-4 against gemv_bfexp_plain
    (bit-equal weights, another f32 summation order), and that plain
    version within 0.05 of gemv_plain (mxq_tpu's own bfexp gate). Bound
    and library call as K1's."""
    from mxq_tpu_torch import packfmt
    from mxq_tpu_torch.ops import mxq_matmul as mm
    failures = []
    layouts = {"K6-quad": ("quad", mm.gemv_quad, mm.gemv_plain),
               "K6-bfexp": ("bfexp", mm.gemv_bfexp, mm.gemv_bfexp_plain)}
    for b in (8, 1, 40, 128):
        for name, p in packs.items():
            x = torch.randn((b, p.in_features), generator=gen,
                            device="cuda").to(torch.bfloat16)
            exact = mm.gemv_plain(x, p)
            wbf = packfmt.unpack_dequant(p).to(torch.bfloat16)
            nbytes = packed_bytes(p) + x.numel() * 2 + b * p.out_features * 4
            bms, by = bound_ms(nbytes, 2.0 * b * p.in_features
                               * p.out_features)
            lib = timer(lambda: x @ wbf)
            del wbf
            for key, (layout, fn, plain) in layouts.items():
                if b == 1:
                    # the one-row route, as a decode step at one slot takes it
                    os.environ["MXQ_GEMV_LAYOUT_B1"] = layout
                    n0 = fn.launches
                    y = mm.mxq_matmul(x.float(), p)
                    routed = fn.launches - n0 == 1
                    del os.environ["MXQ_GEMV_LAYOUT_B1"]
                else:
                    y, routed = fn(x, p), True
                ref = plain(x, p)
                torch.cuda.synchronize()
                err = rel_err(y, ref)
                row = {"kernel": key, "linear": name, "B": b,
                       "rel_err": err, "routed": routed,
                       "max_abs_err": float((y - ref).abs().max()),
                       "kernel_ms": timer(lambda: fn(x, p)),
                       "plain_ms": timer(lambda: plain(x, p), iters=3),
                       "bound_ms": bms, "bound_by": by, "library_ms": lib}
                ok = err <= 1e-4 and routed
                if layout == "quad":
                    k1 = mm.gemv_single if b == 1 else mm.gemv_batched
                    row["equal_to_k1"] = torch.equal(fn(x, p), k1(x, p))
                    ok = ok and row["equal_to_k1"]
                if layout == "bfexp":
                    row["plain_rel_vs_exact"] = rel_err(ref, exact)
                    ok = ok and row["plain_rel_vs_exact"] < 0.05
                rows.append(row)
                emit({"phase": "kernels", "bound_basis": BOUND_BASIS, **row})
                if not ok:
                    failures.append(f"{key} {name} B={b}: {row}")
    for key in layouts:
        summary[key] = summarise(
            [r for r in rows if r["kernel"] == key and r["B"] == 8],
            "one llama2_7b layer (qkv, o, gate_up, down), B=8")
    summary["K6-bfexp-1"] = summarise(
        [r for r in rows if r["kernel"] == "K6-bfexp" and r["B"] == 1],
        "one llama2_7b layer (qkv, o, gate_up, down), B=1")
    return failures


def uniform_kernels(torch, timer, gen, rows, summary):
    """K7 at the lm_head shape (4096 -> 32000, N padded to 32768), B = 1, 8,
    40 (a verify round: 8 slots x 5 tokens), 128 and a 2048-row prefill
    bucket; K8 at the four 7B linears packed uniform-2b, B = 8 and 128.
    Gate rel <= 1e-4 of max|y| against bf16(x) @ dequant. Library: x_bf16
    @ W_bf16 of the dequantized weight."""
    from mxq_tpu_torch.ops import uniform4 as u4
    failures = []

    def one(key, fn, p, b, name, iters=10):
        x = torch.randn((b, p.in_features), generator=gen,
                        device="cuda").to(torch.bfloat16)
        y = fn(x, p)
        ref = u4.uniform_matmul_plain(x, p)
        torch.cuda.synchronize()
        err = rel_err(y, ref)
        wbf = u4.unpack_dequant(p).to(torch.bfloat16)
        nbytes = sum(t.numel() * t.element_size() for t in (p.w, p.s, p.z)) \
            + x.numel() * 2 + b * p.out_features * 4
        bms, by = bound_ms(nbytes, 2.0 * b * p.in_features * p.out_features)
        row = {"kernel": key, "linear": name, "B": b, "rel_err": err,
               "max_abs_err": float((y - ref).abs().max()),
               "kernel_ms": timer(lambda: fn(x, p), iters=iters),
               "plain_ms": timer(lambda: u4.uniform_matmul_plain(x, p),
                                 iters=3),
               "bound_ms": bms, "bound_by": by,
               "library_ms": timer(lambda: x @ wbf, iters=iters)}
        del wbf
        rows.append(row)
        emit({"phase": "kernels", "bound_basis": BOUND_BASIS, **row})
        if not err <= 1e-4:
            failures.append(f"{key} {name} B={b}: rel {err:.3g}")

    w = torch.randn((32000, 4096), generator=gen, device="cuda") * 0.02
    head = u4.quantize_pack_u4(w)
    del w
    for b in (1, 8, 40, 128, 2048):
        one("K7", u4.u4_gemv, head, b, "lm_head", iters=10 if b < 2048 else 3)
    summary["K7"] = summarise(
        [r for r in rows if r["kernel"] == "K7" and r["B"] == 8],
        "llama2_7b lm_head 4096->32000, B=8")
    del head
    for name, (o, k) in SHAPES_7B.items():
        w = torch.randn((o, k), generator=gen, device="cuda") / math.sqrt(k)
        p = u4.quantize_pack_u2(w)
        del w
        for b in (8, 128):
            one("K8", u4.u2_gemv, p, b, name)
    summary["K8"] = summarise([r for r in rows if r["kernel"] == "K8"
                               and r["B"] == 8],
                              "one llama2_7b layer (qkv, o, gate_up, down) "
                              "packed uniform-2b, B=8")
    return failures


def paged_kernels(torch, timer, gen, rows, summary):
    """K9, K10, K11 at llama2_7b's shapes: B=8, Hq=Hkv=32, D=128, pages of
    128 rows, 16 pages per sequence (max_len 2048), shuffled tables with
    the null page 0 past each position's page, the null page's scales NaN
    (it must never be read)."""
    from mxq_tpu_torch.ops import attn_int8 as a8
    B, H, D, PS, PPS = 8, 32, 128, a8.PAGE_INT8, 16
    LP = 1 + B * PPS
    cat = dict(generator=gen, device="cuda")
    plist = [0, 1, 17, 127, 128, 300, 1024, 2046]
    pos = torch.tensor(plist, dtype=torch.int32, device="cuda")
    codes = lambda *s: torch.randint(-127, 128, s, dtype=torch.int8,  # noqa
                                     **cat)
    scales = lambda *s: (torch.rand(s, **cat) * 0.02  # noqa: E731
                         + 0.001).to(torch.bfloat16)
    kp, vp = codes(H, LP, PS, D), codes(H, LP, PS, D)
    ks, vs = scales(H, LP, 1, PS), scales(H, LP, 1, PS)
    ks[:, 0] = vs[:, 0] = float("nan")
    tables = (torch.randperm(LP - 1, **cat)[:B * PPS] + 1).reshape(
        B, PPS).to(torch.int32)
    for i, p in enumerate(plist):
        tables[i, p // PS + 1:] = 0
    q = torch.randn((B, H, D), **cat).to(torch.bfloat16)
    cur = [codes(B, H, D), scales(B, H), codes(B, H, D), scales(B, H)]
    pool = [kp, ks, vp, vs]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # the library yardstick: SDPA over each sequence's pages gathered and
    # dequantized to bf16, masked to the rows the kernel attends
    idx = tables.long()
    kd = (kp[:, idx].float() * ks[:, idx, 0].float()[..., None]).to(
        torch.bfloat16).permute(1, 0, 2, 3, 4).reshape(B, H, PPS * PS, D)
    vd = (vp[:, idx].float() * vs[:, idx, 0].float()[..., None]).to(
        torch.bfloat16).permute(1, 0, 2, 3, 4).reshape(B, H, PPS * PS, D)
    qs = q[:, :, None, :]
    failures = []
    for key, bound_t, fn, plain, extra in (
            ("K9", pos + 1, a8.int8_paged_decode_attention,
             a8.int8_paged_decode_attention_plain, []),
            ("K10", pos, a8.int8_paged_decode_attention_cur,
             a8.int8_paged_decode_attention_cur_plain, cur),
            ("K11", pos, a8.int8_paged_decode_attend_update,
             a8.int8_paged_decode_attend_update_plain, cur)):
        mine = [t.clone() for t in pool]
        theirs = [t.clone() for t in pool]
        out = fn(q, *mine, *extra, bound_t, tables)
        ref = plain(q, *theirs, *extra, bound_t, tables)
        if key == "K11":
            out, ref = out[0], ref[0]
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        finite = bool(torch.isfinite(out).all())
        same = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for a, b in zip(mine, theirs))
        changed = sum(int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
                      for a, b in zip(mine, pool))
        nrows = int(bound_t.sum())        # pool rows this call reads
        nbytes = (nrows * H * (2 * D + 2 * 2) + B * H * D * 2
                  + B * PPS * 4 + B * 4 + B * H * D * 4)
        if extra:
            nbytes += 2 * B * H * (D + 2)             # the current token
        if key == "K11":
            nbytes += 2 * B * H * (D + 2)             # its written rows
        bms, by = bound_ms(nbytes, 4.0 * (nrows + (1 if extra else 0) * B)
                           * H * D)
        amask = (torch.arange(PPS * PS, device="cuda")[None, None, None, :]
                 < (pos + 1)[:, None, None, None])
        row = {"kernel": key, "B": B, "H": H, "D": D, "pages_per_seq": PPS,
               "positions": plist, "rel_err": err,
               "max_abs_err": float((out - ref).abs().max()),
               "finite_with_nan_null_page": finite,
               "pools_equal_to_plain": same, "bytes_changed": changed,
               "kernel_ms": timer(lambda: fn(q, *mine, *extra, bound_t,
                                             tables)),
               "plain_ms": timer(lambda: plain(q, *theirs, *extra, bound_t,
                                               tables), iters=3),
               "bound_ms": bms, "bound_by": by,
               "library_ms": timer(lambda: sdpa(qs, kd, vd,
                                                attn_mask=amask))}
        rows.append(row)
        emit({"phase": "kernels", "bound_basis": BOUND_BASIS, **row})
        # K11 changes exactly its rows and lanes; K9/K10 change nothing
        max_changed = 2 * B * H * (D + 2) if key == "K11" else 0
        if not (err <= 1e-3 and finite and same
                and changed <= max_changed):
            failures.append(f"{key}: rel {err:.3g} finite={finite} "
                            f"pools_equal={same} changed={changed}")
        summary[key] = summarise(
            [row], "B=8 Hq=Hkv=32 D=128, 16 pages of 128 per sequence, "
            "mixed positions")
    return failures


def all_kernels() -> dict:
    """Every kernel wrapper of the port, by kernel ID."""
    from mxq_tpu_torch.ops import attn_int8 as a8
    from mxq_tpu_torch.ops import mxq_matmul as mm
    from mxq_tpu_torch.ops import uniform4 as u4
    return {**mm.KERNELS, **a8.KERNELS, **u4.KERNELS}


def count_launches(torch, kernels, drive) -> dict:
    """Run ``drive`` with every launch count set to 0 just before it and
    read just after: its result dict with ``seconds`` and ``launches``."""
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.monotonic()
    res = drive()
    torch.cuda.synchronize()
    res["seconds"] = time.monotonic() - t0
    res["launches"] = {k: fn.launches for k, fn in kernels.items()}
    return res


def serve_with_tokens(argv) -> dict:
    """``cli.main(argv)`` (slot engine), with its requests' tokens in uid
    order under ``generated``."""
    from mxq_tpu_torch import cli
    from mxq_tpu_torch.serving import engine as eng
    run, done = eng.Engine.run, []

    def recording(self):
        out = run(self)
        done.extend(out)
        return out

    eng.Engine.run = recording
    try:
        res = cli.main(argv)
    finally:
        eng.Engine.run = run
    res["generated"] = [list(map(int, r.generated))
                        for r in sorted(done, key=lambda r: r.uid)]
    return res


def layout_serve(layout: str) -> dict:
    """:data:`CLI_SERVE` with its launch counts and tokens, in a child
    process started with ``MXQ_GEMV_LAYOUT=layout``."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "chip_smoke.py"),
         "--serve-child"], cwd=here, capture_output=True, text=True,
        env=dict(os.environ, MXQ_GEMV_LAYOUT=layout), timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"cli serve with MXQ_GEMV_LAYOUT={layout} exited "
                           f"{proc.returncode}: {proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_serve(torch):
    from mxq_tpu_torch import cli
    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.serving import engine as eng
    from mxq_tpu_torch.serving import paged, spec
    import numpy as np

    kernels = all_kernels()
    runs, failures = {}, []

    def counted(name, need, drive):
        """Run ``drive`` with its launch counts; fail if a kernel in
        ``need`` never launched."""
        runs[name] = res = count_launches(torch, kernels, drive)
        failures.extend(f"{name}: {k} never launched" for k in need
                        if res["launches"][k] <= 0)

    # the README's main-path command, at the cli's default dtype (float32)
    counted("cli", ("K1", "K4"), lambda: serve_with_tokens(CLI_SERVE))
    if runs["cli"]["requests"] != 8 or runs["cli"]["tokens"] != 8 * 32:
        failures.append(f"cli serve finished {runs['cli']['requests']} "
                        f"requests, {runs['cli']['tokens']} tokens")
    # the same command with the K6 layouts, each in a fresh process
    # (ops.mxq_matmul reads MXQ_GEMV_LAYOUT when it is imported): K6 and
    # no K1; quad is K1's function, so its greedy tokens equal the slab
    # run's for >= 7 of 8 requests; bfexp's agreement is only reported
    slab_tokens = runs["cli"].pop("generated")
    torch.cuda.empty_cache()
    for layout in ("quad", "bfexp"):
        name = f"cli_{layout}"
        runs[name] = res = layout_serve(layout)
        got = res.pop("generated")
        res["requests_equal_to_slab"] = sum(
            a == b for a, b in zip(got, slab_tokens))
        ok = (res["launches"]["K6-" + layout] > 0
              and res["launches"]["K1"] == 0 and res["tokens"] == 8 * 32)
        if layout == "quad":
            ok = ok and res["requests_equal_to_slab"] >= 7
        if not ok:
            failures.append(f"{name}: {res}")

    cfg = llama.LlamaConfig.llama2_7b()
    params = llama.quantize_params_packed(
        llama.init_params(cfg, SEED, torch.bfloat16, "cuda"), cfg,
        device="cuda")
    rng = np.random.default_rng(SEED)

    def prompts_of(plens):
        return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                for n in plens]

    def engine_run(slots, prompts):
        e = eng.Engine(params, cfg, eng.EngineConfig(
            num_slots=slots, max_len=2048, seed=SEED), device="cuda")
        reqs = [e.submit(p, max_new_tokens=16) for p in prompts]
        t1 = time.monotonic()
        done = e.run()
        torch.cuda.synchronize()
        dt = time.monotonic() - t1
        toks = [len(r.generated) for r in reqs]
        if len(done) != len(reqs) or any(n != 16 for n in toks) or any(
                not 0 <= t < cfg.vocab_size for r in reqs
                for t in r.generated):
            failures.append(f"engine slots={slots}: tokens {toks}")
        return {"prompt_lens": [len(p) for p in prompts],
                "requests_finished": len(done), "tokens": sum(toks),
                "tokens_per_sec": sum(toks) / dt, "stats": e.stats(),
                "generated": [list(map(int, r.generated)) for r in reqs]}

    # prompts in the 128 (K1), 512 and 2048 (K3) prefill buckets; decode
    # at 8 slots (K1, K4) and at 1 slot (K2, K4), then the one slot again
    # with bfexp at one row: its decode steps launch K6-bfexp 128 times
    # each (32 layers x 4 linears) and K2 never; bfexp is a lossy
    # function, so its greedy tokens' agreement with K2's is only reported
    counted("engine_slots8", ("K1", "K3", "K4"), lambda: engine_run(
        8, prompts_of((100, 400, 1500, 100, 400, 1500))))
    runs["engine_slots8"].pop("generated")
    one = prompts_of((100,))
    counted("engine_slots1", ("K2", "K4"), lambda: engine_run(1, one))
    b1 = os.environ.get("MXQ_GEMV_LAYOUT_B1")
    os.environ["MXQ_GEMV_LAYOUT_B1"] = "bfexp"
    try:
        counted("engine_slots1_bfexp", ("K6-bfexp", "K4"),
                lambda: engine_run(1, one))
    finally:
        if b1 is None:
            del os.environ["MXQ_GEMV_LAYOUT_B1"]
        else:
            os.environ["MXQ_GEMV_LAYOUT_B1"] = b1
    res = runs["engine_slots1_bfexp"]
    got = res.pop("generated")[0]
    want = runs["engine_slots1"].pop("generated")[0]
    res["tokens_equal_to_k2_run"] = sum(a == b for a, b in zip(got, want))
    res["first_token_differing"] = next(
        (i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    n6, n2 = res["launches"]["K6-bfexp"], res["launches"]["K2"]
    if not (n6 > 0 and n6 % 128 == 0 and n2 == 0):
        failures.append(f"engine_slots1_bfexp: K6-bfexp {n6} launches (a "
                        f"multiple of 128 > 0 wanted), K2 {n2} (0 wanted)")

    # paged serving: the README's paged command, then the PagedEngine
    counted("cli_paged", ("K1", "K11"), lambda: cli.main(
        ["serve", "--preset", "llama2_7b", "--packed", "--kv_bits", "8",
         "--paged", "--slots", "8", "--max_len", "2048", "--requests", "8",
         "--prompt_len", "100", "--max_new_tokens", "32",
         "--seed", str(SEED)]))
    if runs["cli_paged"]["requests"] != 8 \
            or runs["cli_paged"]["tokens"] != 8 * 32:
        failures.append(f"cli serve --paged finished "
                        f"{runs['cli_paged']['requests']} requests, "
                        f"{runs['cli_paged']['tokens']} tokens")

    def paged_engine(slots):
        return paged.PagedEngine(params, cfg, num_slots=slots,
                                 total_pages=slots * 16 + 1, max_len=2048,
                                 kv_bits=8, seed=SEED, device="cuda")

    def paged_run(e, prompts, new=16):
        reqs = [e.submit(p, max_new_tokens=new) for p in prompts]
        t1 = time.monotonic()
        done = e.run()
        torch.cuda.synchronize()
        dt = time.monotonic() - t1
        toks = [len(r.generated) for r in reqs]
        if len(done) != len(reqs) or any(n != new for n in toks) or any(
                not 0 <= t < cfg.vocab_size for r in reqs
                for t in r.generated):
            failures.append(f"paged slots={e.num_slots}: tokens {toks}")
        return reqs, {"prompt_lens": [len(p) for p in prompts],
                      "requests_finished": len(done), "tokens": sum(toks),
                      "tokens_per_sec": sum(toks) / dt, "stats": e.stats()}

    counted("paged_slots1", ("K2", "K11"), lambda: paged_run(
        paged_engine(1), [rng.integers(0, cfg.vocab_size, 100)
                          .astype(np.int32)])[1])

    def prefix_run():
        """8 requests sharing a 512-token prefix with distinct 32-token
        tails, then request 0's prompt again on the same engine."""
        e = paged_engine(8)
        prefix = rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
        prompts = [np.concatenate([prefix, rng.integers(
            0, cfg.vocab_size, 32).astype(np.int32)]) for _ in range(8)]
        reqs, res = paged_run(e, prompts)
        hits = e.prefix_hits
        again, _ = paged_run(e, prompts[:1])
        res.update(prefix_pages_hit=hits,
                   pages_saved=hits,
                   prefill_tokens_skipped=hits * e.pool.page_size,
                   repeat_prefix_pages_hit=e.prefix_hits - hits,
                   repeat_tokens_equal=again[0].generated
                   == reqs[0].generated)
        if not hits > 0 or not res["repeat_tokens_equal"]:
            failures.append(f"paged prefix run: hits {hits}, repeat "
                            f"equal {res['repeat_tokens_equal']}")
        return res

    counted("paged_prefix", ("K1", "K11"), prefix_run)

    # the slot engine's three serve options at full depth: prompt-lookup
    # speculative decoding through cli serve (random prompts: the drafts
    # miss and the auto-disable falls back to plain chunks) ...
    spec_args = ["serve", "--preset", "llama2_7b", "--packed", "--kv_bits",
                 "8", "--slots", "8", "--max_len", "2048", "--requests", "8",
                 "--seed", str(SEED)]
    counted("cli_spec", ("K1", "K4a"), lambda: cli.main(
        spec_args + ["--spec_decode", "--prompt_len", "100",
                     "--max_new_tokens", "32"]))
    if runs["cli_spec"]["tokens"] != 8 * 32:
        failures.append(f"cli serve --spec_decode gave "
                        f"{runs['cli_spec']['tokens']} tokens")

    # ... the Engine at float32 on repetitive prompts, always speculating,
    # against plain decode on the same prompts and weights ...
    params32 = llama.quantize_params_packed(
        llama.init_params(cfg, SEED, torch.float32, "cuda"), cfg,
        device="cuda")
    pattern = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    rep_prompts = [np.roll(np.tile(pattern, 8), i) for i in range(8)]

    def repetitive_run(speculate):
        e = eng.Engine(params32, cfg, eng.EngineConfig(
            num_slots=8, max_len=2048, seed=SEED), device="cuda")
        reqs = [e.submit(p, max_new_tokens=32) for p in rep_prompts]
        t1 = time.monotonic()
        if speculate:
            spec.run_spec_pipelined(e, auto_disable=False)
        else:
            e.run()
        torch.cuda.synchronize()
        dt = time.monotonic() - t1
        toks = sum(len(r.generated) for r in reqs)
        return {"tokens": toks, "tokens_per_sec": toks / dt,
                "generated": [list(map(int, r.generated)) for r in reqs],
                "stats": e.stats()}

    counted("engine_spec_repetitive", ("K1", "K4a"),
            lambda: repetitive_run(True))
    counted("engine_plain_repetitive", ("K1", "K4"),
            lambda: repetitive_run(False))
    got = runs["engine_spec_repetitive"].pop("generated")
    want = runs["engine_plain_repetitive"].pop("generated")
    res = runs["engine_spec_repetitive"]
    res["requests_equal_to_plain"] = sum(a == b for a, b in zip(got, want))
    res.update(spec_against_decode(torch, params32, cfg, rep_prompts, got))
    if (res["tokens"] != 8 * 32 or res["off_greedy_steps"]
            or not res["verify_rel_vs_decode"] <= SPEC_GATE):
        failures.append(f"spec on repetitive prompts: {res}")
    del params32

    # ... and the int8-activation prefill with the packed uniform-4b head:
    # 600-token prompts go to the 2048 bucket (K5), the head runs at the
    # bucket's rows in prefill and at 8 rows in decode (K7)
    counted("cli_a8_u4", ("K1", "K4", "K5", "K7"), lambda: cli.main(
        spec_args + ["--prefill_a8", "--lm_head_bits", "4",
                     "--prompt_len", "600", "--max_new_tokens", "16"]))
    if runs["cli_a8_u4"]["tokens"] != 8 * 16:
        failures.append(f"cli serve --prefill_a8 --lm_head_bits 4 gave "
                        f"{runs['cli_a8_u4']['tokens']} tokens")
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in kernels}
    # K6-bfexp's wrapper launches bfexp_row_kernel at one row, which only
    # engine_slots1_bfexp runs, and the tensor-core template at B >= 2
    launches["K6-bfexp-1"] = n6
    launches["K6-bfexp"] -= n6
    # the two engines' decode steps and one speculative verify round,
    # wall-clocked in turns (the host's speed drifts between seconds),
    # then profiled
    slots = {"slot": 8, "slot1": 1, "paged": 8, "spec": 8}
    step_fns = {"slot": slot_step(torch, params, cfg),
                "slot1": slot_step(torch, params, cfg, b=1),
                "paged": paged_step(torch, params, cfg),
                "spec": verify_step(torch, params, cfg)}
    walls = {k: [] for k in step_fns}
    for _ in range(3):
        for k, fn in step_fns.items():
            walls[k].append(wall_ms(torch, fn))
    profile = {k: decode_step_profile(torch, fn, walls[k], b=slots[k])
               for k, fn in step_fns.items()}
    del step_fns
    prefill = prefill_profile(torch, params, cfg)
    del params
    emit({"phase": "serve", **runs, "launches_total": launches,
          "decode_step_profile": profile, "prefill_profile": prefill})
    return launches, failures


def spec_against_decode(torch, params, cfg, prompts, tokens) -> dict:
    """Speculative decoding's tokens against plain decode, teacher-forced
    along the spec run's own tokens (``tokens`` [B][n]) from the prompts'
    prefilled int8 cache: plain decode's logits D (T = 1: K1 at B rows,
    K4) and the verify path's V (rounds of T = 5: K1 at 5B rows, K4a) at
    every step after the first. Greedy decoding through two numerically
    different paths parts where the logits' top two lie closer than the
    paths' gap, so a spec token that is not D's argmax is an error only
    where D's lead over it exceeds SPEC_GATE of max|D|, the repo's limit
    for the verify round against decode (``phase_e2e``). Returns the
    steps, the tokens off D's argmax, those beyond the gate
    (``off_greedy_steps``), D's largest lead over a spec token, and
    max|V - D| / max|D| over the steps."""
    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.serving import kvcache
    b, n = len(tokens), len(tokens[0])
    seq = torch.as_tensor(tokens, device="cuda")
    ids = torch.stack([torch.as_tensor(p) for p in prompts]).to("cuda")
    t0 = ids.shape[1]

    def prefilled():
        cache = kvcache.init_quant_cache(
            cfg.num_hidden_layers, b, t0 + n, cfg.num_key_value_heads,
            cfg.head_dim, device="cuda")
        for r in range(b):       # one request at a time, as the Engine does
            one = {k: v[:, r:r + 1] for k, v in cache.items()}
            llama.forward(params, ids[r:r + 1], cfg, caches=one,
                          cache_pos=0, device="cuda")
            for k in cache:
                cache[k][:, r:r + 1] = one[k]
        return cache

    def at(j):
        return torch.full((b,), t0 + j - 1, dtype=torch.int32,
                          device="cuda")

    with torch.inference_mode():
        cache = prefilled()
        d = [llama.decode_slots(params, seq[:, j - 1:j], cfg, cache,
                                at(j))[:, 0] for j in range(1, n)]
        cache, v = prefilled(), []
        for j in range(1, n, 5):
            t = min(5, n - j)
            lg = llama.decode_slots(params, seq[:, j - 1:j - 1 + t], cfg,
                                    cache, at(j))
            v += [lg[:, i] for i in range(t)]
        d, v = torch.stack(d, 1), torch.stack(v, 1)       # [B, n-1, V]
        scale = d.abs().amax(-1)
        lead = (d.amax(-1) - d.gather(-1, seq[:, 1:, None])[..., 0]) / scale
        gap = float(((v - d).abs().amax(-1) / scale).max())
    return {"steps": b * (n - 1), "off_argmax_steps": int((lead > 0).sum()),
            "off_greedy_steps": int((lead > SPEC_GATE).sum()),
            "max_lead_over_spec_token": float(lead.max()),
            "verify_rel_vs_decode": gap}


def slot_step(torch, params, cfg, b=8, pos=1000):
    """One decode step of the slot engine (``llama.decode_slots``) for
    ``b`` slots at cache row ``pos + i``, int8 cache."""
    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.serving import kvcache

    cache = kvcache.init_quant_cache(cfg.num_hidden_layers, b, 2048,
                                     cfg.num_key_value_heads, cfg.head_dim,
                                     device="cuda")
    toks = torch.zeros((b, 1), dtype=torch.int32, device="cuda")
    start = torch.full((b,), pos, dtype=torch.int32, device="cuda")
    return lambda i: llama.decode_slots(params, toks, cfg, cache, start + i)


def verify_step(torch, params, cfg, b=8, pos=1000, t=5):
    """One speculative verify round of the slot engine
    (``llama.decode_slots`` with T=5 tokens per slot: K1 at 40 rows, K4a
    once per layer for all 5 tokens) for ``b`` slots at cache rows
    ``pos + t*i ..``, int8 cache."""
    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.serving import kvcache

    cache = kvcache.init_quant_cache(cfg.num_hidden_layers, b, 2048,
                                     cfg.num_key_value_heads, cfg.head_dim,
                                     device="cuda")
    toks = torch.zeros((b, t), dtype=torch.int32, device="cuda")
    start = torch.full((b,), pos, dtype=torch.int32, device="cuda")
    return lambda i: llama.decode_slots(params, toks, cfg, cache,
                                        start + t * i)


def paged_step(torch, params, cfg, b=8, pos=1000):
    """One decode step of the paged engine (``paged.paged_decode_step``,
    K11 per layer) for ``b`` slots at row ``pos + i``, int8 pool, each slot
    holding 16 pages of 128 rows."""
    from mxq_tpu_torch.serving import paged

    pool = paged.PagedPool.create(cfg, b, 1 + 16 * b, page_size=128,
                                  max_len=2048, kv_bits=8, device="cuda")
    tables = (1 + torch.arange(16 * b, dtype=torch.int32,
                               device="cuda")).reshape(b, 16)
    toks = torch.zeros((b, 1), dtype=torch.int32, device="cuda")
    start = torch.full((b,), pos, dtype=torch.int32, device="cuda")
    return lambda i: paged.paged_decode_step(
        params, pool.k_pages, pool.v_pages, toks, start + i, tables, cfg)


def prefill_profile(torch, params, cfg, t=2048, rounds=3) -> dict:
    """One prefill of a 2048-token bucket of llama2_7b at full depth as
    `cli_a8_u4` runs it (int8 activations, K5; the packed uniform-4b head
    at the bucket's 2048 rows, K7), without a cache: the CUDA-event span of
    one call (the device timeline, gaps where the host lags included),
    median of ``rounds`` after a warm-up, with the K7 launches of one call
    and K7's own span at those rows; then one profiled call: device time
    per kernel (torch.profiler), K5's two kernels summed, and the idle
    share = 1 - device busy / the median event span."""
    from torch.profiler import ProfilerActivity, profile

    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.ops import uniform4 as u4
    p = dict(params, lm_head=u4.quantize_pack_u4(params["lm_head"].T))
    cfg8 = dataclasses.replace(cfg, prefill_act_bits=8)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ids = torch.randint(0, cfg.vocab_size, (1, t), generator=gen,
                        device="cuda", dtype=torch.int32)
    fn = lambda: llama.forward(p, ids, cfg8, device="cuda")  # noqa: E731
    fn()
    n0 = u4.u4_gemv.launches
    ts = []
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    k7_calls = (u4.u4_gemv.launches - n0) // rounds
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per_kernel = device_ms_by_name(torch, prof, 1)
    busy = sum(per_kernel.values())
    span = statistics.median(ts)
    groups = {}
    for k, v in per_kernel.items():
        g = next((g for g, names in PREFILL_GROUPS
                  if any(n in k for n in names)), "other")
        groups[g] = groups.get(g, 0.0) + v
    x = torch.randn((t, cfg.hidden_size), generator=gen, device="cuda").to(
        torch.bfloat16)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    u4.u4_matmul(x, p["lm_head"])
    e1.record()
    e1.synchronize()
    return {"rows": t, "event_ms": span, "event_ms_rounds": ts,
            "K7_launches_per_call": k7_calls,
            "K7_ms_at_these_rows": e0.elapsed_time(e1),
            "device_busy_ms": busy, "idle_share": 1.0 - busy / span,
            "k5_ms": {k[:80]: v for k, v in per_kernel.items()
                      if any(n in k for n in K5_KERNEL_NAMES)},
            "device_kernels": len(per_kernel), "device_ms_by_group": groups,
            "top_device_ops_ms": top_ms(per_kernel, 16)}


def top_ms(per_kernel: dict, n: int) -> dict:
    """The ``n`` largest entries of ``per_kernel`` under short labels: the
    name without ``void`` and its namespaces, cut to 100 characters (where
    two kernels share a label their times are added)."""
    out = {}
    for k, v in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:n]:
        for junk in ("void ", "at::native::", "(anonymous namespace)::"):
            k = k.replace(junk, "")
        out[k[:100]] = out.get(k[:100], 0.0) + v
    return out


def device_ms_by_name(torch, prof, calls: int) -> dict:
    """Device ms per kernel name and per call from a torch.profiler run of
    ``calls`` calls. Spans of user annotations on the device's timeline
    (``Optimizer.step#AdamW.step``) cover kernels counted by name, so they
    are left out."""
    per_kernel = {}
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us / 1e3 / calls
    return per_kernel


def wall_ms(torch, step, steps=8) -> float:
    """Host-clock ms per call of ``step(i)`` over ``steps`` calls, after a
    warm-up round, ending in a synchronize."""
    def run():
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()

    run()
    t0 = time.monotonic()
    run()
    return (time.monotonic() - t0) * 1e3 / steps


def decode_step_profile(torch, step, walls, b=8, pos=1000, steps=4):
    """Where a decode step's time goes: ``step(i)`` is one full-model decode
    step for ``b`` slots at row ``pos + i``; ``walls`` its host-clock ms
    per step from :func:`wall_ms`, without the profiler. Device time per
    kernel from torch.profiler, K1's and K2's kernels summed by name;
    idle share = 1 - device busy / median wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
    per_kernel = device_ms_by_name(torch, prof, steps)
    busy = sum(per_kernel.values())
    wall = statistics.median(walls)
    k1, k2 = (sum(v for k, v in per_kernel.items()
                  if any(name in k for name in names))
              for names in (K1_KERNEL_NAMES, K2_KERNEL_NAMES))
    return {"slots": b, "position": pos, "wall_ms_per_step": wall,
            "wall_ms_per_step_rounds": walls,
            "device_busy_ms_per_step": busy,
            "idle_share": 1.0 - busy / wall if wall else None,
            "k1_ms_per_step": k1, "k1_share_of_busy": k1 / busy,
            "k2_ms_per_step": k2, "k2_share_of_busy": k2 / busy,
            "top_kernels_ms_per_step": top_ms(per_kernel, 8)}


def phase_eval(torch):
    """Perplexity of llama2_7b at full depth on ptq.data's synthetic eval
    stream, each run with its own launch counts:
    1. ``cli eval-ppl --preset llama2_7b --dtype bfloat16 --w_bits 2
       --seqlen 2048 --max_eval_windows 2``: the fake-quant forward of the
       dense model (no kernel of the repo);
    2. the packed model (bf16, random weights from the seed, packed on the
       card), ``eval_ppl`` at seqlen 128, batch 1, 8 windows, once per
       GEMV layout: 128 rows per linear stay under the 512-row prefill
       switch, so slab runs K1, quad and bfexp K6. Gates: quad within
       1e-3 of slab's perplexity (relative: the same function), bfexp
       within 5e-2 (bf16 weights);
    3. the same packed model at seqlen 2048, 2 windows (K3).
    Every perplexity must be finite and above 1. Returns (launches summed
    over the runs, failures)."""
    from mxq_tpu_torch import cli
    from mxq_tpu_torch.eval import ppl
    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.ops import mxq_matmul as mm
    from mxq_tpu_torch.ptq import data

    kernels = all_kernels()
    runs, failures = {}, []
    runs["cli_w2"] = count_launches(torch, kernels, lambda: cli.main(
        ["eval-ppl", "--preset", "llama2_7b", "--dtype", "bfloat16",
         "--w_bits", "2", "--seqlen", "2048", "--max_eval_windows", "2",
         "--seed", str(SEED)]))
    torch.cuda.empty_cache()
    cfg = llama.LlamaConfig.llama2_7b()
    params = llama.quantize_params_packed(
        llama.init_params(cfg, SEED, torch.bfloat16, "cuda"), cfg,
        device="cuda")

    def packed_ppl(seqlen, windows):
        tokens = data.get_eval_tokens(vocab_size=cfg.vocab_size,
                                      seqlen=seqlen)
        return {"seqlen": seqlen, "windows": windows,
                "ppl": ppl.eval_ppl(params, cfg, tokens, seqlen=seqlen,
                                    batch=1, max_windows=windows,
                                    device="cuda")}

    saved = mm.GEMV_LAYOUT
    try:
        for layout, key in (("slab", "K1"), ("quad", "K6-quad"),
                            ("bfexp", "K6-bfexp")):
            mm.GEMV_LAYOUT = layout
            runs[f"packed_{layout}"] = res = count_launches(
                torch, kernels, lambda: packed_ppl(128, 8))
            if res["launches"][key] <= 0:
                failures.append(f"eval packed_{layout}: {key} never "
                                "launched")
    finally:
        mm.GEMV_LAYOUT = saved
    runs["packed_seqlen2048"] = res = count_launches(
        torch, kernels, lambda: packed_ppl(2048, 2))
    if res["launches"]["K3"] <= 0:
        failures.append("eval packed_seqlen2048: K3 never launched")
    del params
    slab = runs["packed_slab"]["ppl"]
    for layout, gate in (("quad", 1e-3), ("bfexp", 5e-2)):
        r = runs[f"packed_{layout}"]
        r["rel_vs_slab"] = abs(r["ppl"] - slab) / slab
        if not r["rel_vs_slab"] <= gate:
            failures.append(f"eval {layout}: ppl {r['ppl']} against slab's "
                            f"{slab}, rel {r['rel_vs_slab']:.3g} > {gate}")
    failures += [f"eval {k}: ppl {r['ppl']}" for k, r in runs.items()
                 if not (math.isfinite(r["ppl"]) and r["ppl"] > 1)]
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in kernels}
    emit({"phase": "eval", **runs, "launches_total": launches})
    return launches, failures


def same_bits(torch, a, b) -> bool:
    """Equal type, shape and bytes (``b`` may live on another device)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    def raw(t):
        return t.to(a.device).contiguous().reshape(-1).view(torch.uint8)
    return torch.equal(raw(a), raw(b))


def tree_diff(torch, a, b, path: str = "") -> list:
    """The paths at which two parameter trees differ in structure, type,
    shape or bytes."""
    from mxq_tpu_torch.packfmt import FIELDS, PackedMXQLinear
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return [path or "/"]
        return [d for k in sorted(a) for d in tree_diff(
            torch, a[k], b[k], f"{path}.{k}" if path else k)]
    if isinstance(a, PackedMXQLinear):
        if not isinstance(b, PackedMXQLinear) or (
                (a.in_features, a.out_features)
                != (b.in_features, b.out_features)):
            return [path]
        return [f"{path}.{f}" for f in FIELDS
                if not same_bits(torch, getattr(a, f), getattr(b, f))]
    ok = isinstance(b, torch.Tensor) and same_bits(torch, a, b)
    return [] if ok else [path]


@contextlib.contextmanager
def captured_ptq(calibrate):
    """Record the params, config and results of every
    ``calibrate.ptq_quantize`` call made inside the block."""
    calls, real = [], calibrate.ptq_quantize

    def record(params, cfg, *args, **kw):
        qparams, packed = real(params, cfg, *args, **kw)
        calls.append(dict(params=params, cfg=cfg, qparams=qparams,
                          packed=packed))
        return qparams, packed

    calibrate.ptq_quantize = record
    try:
        yield calls
    finally:
        calibrate.ptq_quantize = real


def write_hf_checkpoint(torch, path: str, cfg) -> dict:
    """A random HF Llama checkpoint of ``cfg`` in bf16 (``config.json`` and
    one ``model.safetensors`` written by the port's writer): linears
    N(0, 1/fan_in), embeddings and head N(0, 0.02^2), norms 1 + N(0,
    0.1^2), drawn on the card from SEED. Returns the tensors by name."""
    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.utils import safetensors_io
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def normal(shape, std, mean=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std
                + mean).to(torch.bfloat16)

    h, v = cfg.hidden_size, cfg.vocab_size
    tensors = {"model.embed_tokens.weight": normal((v, h), 0.02)}
    for i in range(cfg.num_hidden_layers):
        pre = f"model.layers.{i}."
        for name, (fan_in, fan_out) in llama._linear_shapes(cfg).items():
            part = "mlp" if name in ("gate_proj", "up_proj",
                                     "down_proj") else "self_attn"
            tensors[f"{pre}{part}.{name}.weight"] = normal(
                (fan_out, fan_in), fan_in ** -0.5)
        for name in ("input_layernorm", "post_attention_layernorm"):
            tensors[f"{pre}{name}.weight"] = normal((h,), 0.1, 1.0)
    tensors["model.norm.weight"] = normal((h,), 0.1, 1.0)
    tensors["lm_head.weight"] = normal((v, h), 0.02)
    os.makedirs(path, exist_ok=True)
    safetensors_io.save_file(tensors, os.path.join(path,
                                                   "model.safetensors"))
    keys = ("vocab_size", "hidden_size", "intermediate_size",
            "num_hidden_layers", "num_attention_heads",
            "num_key_value_heads", "max_position_embeddings",
            "rms_norm_eps", "rope_theta", "tie_word_embeddings")
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({k: getattr(cfg, k) for k in keys}, f)
    return tensors


def loaded_as_written(torch, params, written: dict) -> list:
    """The HF tensor names whose loaded counterpart in ``params`` (linears
    transposed to [in, out] and stacked per layer) differs from what was
    written."""
    bad = []
    for name, t in written.items():
        parts = name.split(".")
        if name == "model.embed_tokens.weight":
            got = params["embed_tokens"]
        elif name == "model.norm.weight":
            got = params["norm"]
        elif name == "lm_head.weight":
            got = params["lm_head"].T
        elif parts[3] in ("self_attn", "mlp"):
            got = params["layers"][parts[4]][int(parts[2])].T
        else:
            got = params["layers"][parts[3]][int(parts[2])]
        if not same_bits(torch, got, t):
            bad.append(name)
    return bad


def phase_ptq(torch):
    """The PTQ pipeline at llama2_7b's widths, each step a hard check:
    1. ``cli ptq`` (PTQ_ARGV, ``--save_model`` into a temporary directory)
       at full depth: seconds per layer, peak device memory, the quantized
       perplexity on the synthetic stream;
    2. for every layer and linear, ``unpack_dequant`` of the packed
       artifact equals qparams' weight bit for bit (one pass makes both);
    3. ``quantize_pack`` of layer 0's gate_proj (4096 -> 11008) on the card
       equals the same call on a CPU copy, every field bit for bit;
    4. ``checkpoint.load_params`` of the saved directory equals the
       in-memory packed params, bit for bit, config included;
    5. the reloaded packed model: perplexity at 2048-token windows (K3)
       within PTQ_PPL_GATE of the dense qparams' (the cli's), an 8-slot
       Engine run of 8 100-token prompts and 16 new tokens with the int8
       cache (K1, K4), and a 100-token prefill (K1) within
       PTQ_PREFILL_GATE of ``forward(qparams)``;
    6. ``cli prune``: SparseGPT at 50% on 2 layers (actual sparsity within
       0.5 +- 0.01) and Wanda 2:4 at full depth (exactly 0.5);
    7. the HF loader: a one-layer llama2_7b-width bf16 checkpoint written
       with ``utils.safetensors_io``, then ``cli ptq --model`` on it: the
       loaded config has llama2_7b's widths and the loaded tensors equal
       those written.
    Returns (launches summed over the runs, failures)."""
    import numpy as np
    from mxq_tpu_torch import cli, packfmt
    from mxq_tpu_torch.eval import ppl
    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.ptq import calibrate, data
    from mxq_tpu_torch.serving import engine as eng
    from mxq_tpu_torch.utils import checkpoint

    kernels = all_kernels()
    runs, failures, counted = {}, [], []

    def count(name, drive, need=()):
        runs[name] = res = count_launches(torch, kernels, drive)
        counted.append(res.pop("launches"))
        failures.extend(f"ptq {name}: {k} never launched" for k in need
                        if counted[-1][k] <= 0)
        return res

    with tempfile.TemporaryDirectory(prefix="mxq_ptq_") as tmp:
        # 1. calibration, packing, perplexity and the checkpoint
        ckpt = os.path.join(tmp, "llama2_7b_mxq")
        torch.cuda.reset_peak_memory_stats()
        with captured_ptq(calibrate) as calls:
            res = count("cli_ptq", lambda: cli.main(
                PTQ_ARGV + ["--save_model", ckpt]))
        res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        secs = res["layer_seconds"]
        res.update(layers=len(secs), calibration_seconds=sum(secs),
                   seconds_per_layer=statistics.median(secs),
                   checkpoint_bytes=sum(
                       os.path.getsize(os.path.join(ckpt, f))
                       for f in os.listdir(ckpt)))
        call = calls.pop()
        cfg, params = call["cfg"], call["params"]
        qparams, packed = call["qparams"], call["packed"]
        del calls, call
        if cfg.num_hidden_layers != 32 or not math.isfinite(res["ppl"]):
            failures.append(f"ptq cli_ptq: {cfg.num_hidden_layers} layers, "
                            f"ppl {res['ppl']}")

        # 2. one pass: the artifact dequantizes to qparams' weights
        bad = [f"{n}[{i}]" for n in llama.LAYER_LINEARS
               for i in range(cfg.num_hidden_layers)
               if not same_bits(torch, packfmt.unpack_dequant(
                   packed["layers"][n].layer(i), cfg.scheme).to(
                       qparams["layers"][n].dtype),
                   qparams["layers"][n][i])]
        runs["one_pass_bit_equal"] = not bad
        if bad:
            failures.append(f"ptq: unpack_dequant differs from qparams at "
                            f"{len(bad)} layer linears, e.g. {bad[:4]}")

        # 3. the packer on the card against the packer on the CPU
        w = params["layers"]["gate_proj"][0].T
        card = packfmt.quantize_pack(w, cfg.scheme)
        host = packfmt.quantize_pack(w.cpu(), cfg.scheme)
        differ = {f: int((getattr(card, f).cpu() != getattr(host, f)).sum())
                  for f in packfmt.FIELDS
                  if not same_bits(torch, getattr(card, f),
                                   getattr(host, f))}
        runs["card_vs_cpu_pack"] = {
            "weight": "layers.0.gate_proj", "shape": list(w.shape),
            "elements_differing": differ,
            "artifact_equal": not tree_diff(
                torch, card, packed["layers"]["gate_proj"].layer(0))}
        if differ:
            failures.append(f"ptq: quantize_pack on the card differs from "
                            f"the CPU's: {differ}")
        del w, card, host, params

        # 4. the checkpoint reloads bit for bit
        t0 = time.monotonic()
        cfg2, params2 = checkpoint.load_params(ckpt, device="cuda")
        torch.cuda.synchronize()
        diff = tree_diff(torch, packed, params2)
        runs["reload"] = {"seconds": time.monotonic() - t0,
                          "paths_differing": diff,
                          "config_equal": cfg2 == cfg}
        if diff or cfg2 != cfg:
            failures.append(f"ptq: the reloaded checkpoint differs at "
                            f"{diff[:8]}, config equal {cfg2 == cfg}")
        del packed

    # 5. the reloaded model: perplexity (K3), serving (K1, K4), prefill (K1)
    tokens = data.get_eval_tokens(vocab_size=cfg.vocab_size,
                                  dataset="wikitext2", seqlen=2048)
    ev = count("packed_ppl", lambda: {"ppl": ppl.eval_ppl(
        params2, cfg2, tokens, seqlen=2048, max_windows=2, device="cuda")},
        need=("K3",))
    ev["rel_vs_qparams"] = abs(ev["ppl"] - res["ppl"]) / res["ppl"]
    if not ev["rel_vs_qparams"] <= PTQ_PPL_GATE:
        failures.append(f"ptq: packed ppl {ev['ppl']} against qparams' "
                        f"{res['ppl']}, rel {ev['rel_vs_qparams']:.3g} > "
                        f"{PTQ_PPL_GATE}")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, 100).astype(np.int32)
               for _ in range(8)]

    def engine_run():
        e = eng.Engine(params2, cfg2, eng.EngineConfig(
            num_slots=8, max_len=256, seed=SEED), device="cuda")
        reqs = [e.submit(p, max_new_tokens=16) for p in prompts]
        done = e.run()
        return {"requests_finished": len(done),
                "tokens": sum(len(r.generated) for r in reqs)}

    en = count("engine_slots8", engine_run, need=("K1", "K4"))
    if en["requests_finished"] != 8 or en["tokens"] != 8 * 16:
        failures.append(f"ptq engine_slots8: {en}")
    ids = torch.as_tensor(prompts[0][None], device="cuda")
    with torch.inference_mode():
        pre = count("prefill_100", lambda: {"logits": llama.forward(
            params2, ids, cfg2, device="cuda")[0]}, need=("K1",))
        ref = llama.forward(qparams, ids, cfg, device="cuda")[0]
    logits = pre.pop("logits")
    pre["rel_vs_qparams"] = rel_err(logits, ref)
    pre["argmax_agreement"] = float(
        (logits.argmax(-1) == ref.argmax(-1)).float().mean())
    if not pre["rel_vs_qparams"] <= PTQ_PREFILL_GATE:
        failures.append(f"ptq: 100-token prefill rel "
                        f"{pre['rel_vs_qparams']:.3g} > {PTQ_PREFILL_GATE}")
    del qparams, params2, ref, logits
    torch.cuda.empty_cache()

    # 6. pruning
    for name, argv, layers, ok in (
            ("prune_sparsegpt", ["--layers", "2", "--prune_method",
                                 "sparsegpt", "--sparsity", "0.5"], 2,
             lambda s: abs(s - 0.5) <= 0.01),
            ("prune_wanda_2_4", ["--prune_method", "wanda",
                                 "--sparsity_type", "2:4"], 32,
             lambda s: s == 0.5)):
        r = count(name, lambda: cli.main(
            ["prune", "--preset", "llama2_7b", "--dtype", "bfloat16",
             "--nsamples", "8", "--seqlen", "2048", "--max_eval_windows",
             "1", "--seed", str(SEED)] + argv))
        r["seconds_per_layer"] = r["prune_seconds"] / layers
        if not (ok(r["sparsity"]) and math.isfinite(r["ppl"])):
            failures.append(f"ptq {name}: sparsity {r['sparsity']}, "
                            f"ppl {r['ppl']}")
        torch.cuda.empty_cache()

    # 7. the HF loader on a checkpoint written here
    with tempfile.TemporaryDirectory(prefix="mxq_hf_") as hf:
        want = llama.LlamaConfig.llama2_7b(num_hidden_layers=1)
        written = write_hf_checkpoint(torch, hf, want)
        with captured_ptq(calibrate) as calls:
            h = count("hf_ptq", lambda: cli.main(
                ["ptq", "--model", hf, "--dtype", "bfloat16", "--mode",
                 "packed", "--nsamples", "4", "--seqlen", "512",
                 "--max_eval_windows", "1", "--seed", str(SEED)]))
        call = calls.pop()
        h["config_equal"] = call["cfg"] == want
        h["tensors_differing"] = loaded_as_written(torch, call["params"],
                                                   written)
        if not h["config_equal"] or h["tensors_differing"] or not (
                math.isfinite(h["ppl"])):
            failures.append(f"ptq hf_ptq: config {call['cfg']}, differing "
                            f"{h['tensors_differing']}, ppl {h['ppl']}")
        del call, calls, written
    torch.cuda.empty_cache()

    launches = {k: sum(c[k] for c in counted) for k in kernels}
    emit({"phase": "ptq", **runs, "launches_total": launches,
          "card": smi()})
    return launches, failures


class Tee:
    """A text stream that writes to ``sys.stdout`` and keeps a copy."""

    def __init__(self):
        self.parts, self.out = [], sys.stdout

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def cli_with_output(argv) -> tuple[dict, str]:
    """``cli.main(argv)``'s result and what it printed."""
    from mxq_tpu_torch import cli
    tee = Tee()
    with contextlib.redirect_stdout(tee):
        res = cli.main(argv)
    return res, tee.text()


def train_metrics(logdir: str, first: int) -> dict:
    """The loop's per-step records from ``first`` on (metrics.jsonl)."""
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    recs = [r for r in recs if "train/loss" in r and r["step"] >= first]
    return {"steps": [r["step"] for r in recs],
            "loss": [r["train/loss"] for r in recs],
            "grad_norm": [r["train/grad_norm"] for r in recs],
            "seconds": [r["train/seconds_per_step"] for r in recs]}


def train_step_card_vs_cpu(torch) -> dict:
    """One KD train step (w_bits 2, the default TrainConfig) of llama2_7b's
    widths at 1 layer on 128 tokens, from the same params, teacher and
    batch on the card and on the CPU (the body of
    ``train.make_train_step``, with the gradients kept): the loss and
    grad_norm apart (relative), the gradients apart over each leaf's
    max|g| (the worst leaf), and the updated params: max|card - cpu| over
    all leaves against max|p| over all leaves, and (reported, not gated)
    the worst leaf against its own max|p| and the largest difference in
    units of the learning rate."""
    import dataclasses as dc
    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.qat import train

    def copy(tree, dev):
        return {k: copy(v, dev) if isinstance(v, dict)
                else v.detach().to(dev, copy=True) for k, v in tree.items()}

    cfg = llama.LlamaConfig.llama2_7b(num_hidden_layers=1, w_bits=2)
    full = dc.replace(cfg, w_bits=32, a_bits=32, kv_bits=32)
    tc = train.TrainConfig()
    init = llama.init_params(cfg, SEED, torch.float32, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    ids = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen,
                        device="cuda")
    out = {}
    for dev in ("cuda", "cpu"):
        params, teacher = copy(init, dev), copy(init, dev)
        named = train.leaves(params)
        for p in named.values():
            p.requires_grad_(True)
        opt = train.make_optimizer(tc, params)
        t0 = time.monotonic()
        loss = train.loss_fn(params, teacher, {"input_ids": ids.to(dev)},
                             cfg, full, tc)
        loss.backward()
        grads = {k: p.grad.detach().clone() for k, p in named.items()}
        norm = opt.step()
        out[dev] = dict(loss=float(loss), grad_norm=float(norm),
                        seconds=time.monotonic() - t0, grads=grads,
                        params={k: p.detach() for k, p in named.items()})
        del params, teacher, named, opt
    card, host = out["cuda"], out["cpu"]
    res = {k: abs(card[k] - host[k]) / abs(host[k])
           for k in ("loss", "grad_norm")}
    res["grads"] = max(
        float((card["grads"][k].cpu() - g).abs().max() / g.abs().max())
        for k, g in host["grads"].items())
    diff = {k: float((card["params"][k].cpu() - p).abs().max())
            for k, p in host["params"].items()}
    peak = {k: float(p.abs().max()) for k, p in host["params"].items()}
    res["params"] = max(diff.values()) / max(peak.values())
    worst = max(diff, key=lambda k: diff[k] / peak[k])
    res.update(params_worst_leaf=[worst, diff[worst] / peak[worst]],
               params_max_diff_over_lr=max(diff.values())
               / tc.learning_rate,
               loss_card=card["loss"], grad_norm_card=card["grad_norm"],
               seconds_card=card["seconds"], seconds_cpu=host["seconds"])
    return res


# a train step's device time by kind, first match by name; the rest is
# PyTorch's elementwise ops, copies and reductions (the fake-quant, the
# losses, the clip)
TRAIN_GROUPS = (("attention (library)", ("fmha", "flash", "attention")),
                ("GEMM (library)", ("gemm", "cutlass", "xmma")),
                ("AdamW (foreach)", ("multi_tensor", "foreach")))


def train_step_profile(torch, steps=3) -> dict:
    """One KD train step as ``cli train`` runs it (TRAIN_ARGV's model and
    batch: 4 layers of llama2_7b, w_bits 2, remat, [2, 2048]): the
    CUDA-event span of a step, median of ``steps`` after a warm-up step,
    then one profiled step: device time per kernel (torch.profiler) by
    TRAIN_GROUPS, its top ops and the idle share = 1 - device busy / the
    median span."""
    import dataclasses as dc
    from torch.profiler import ProfilerActivity, profile

    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.qat import train

    cfg = llama.LlamaConfig.llama2_7b(num_hidden_layers=4, w_bits=2)
    params = llama.init_params(cfg, SEED, torch.float32, "cuda")
    teacher = llama.init_params(dc.replace(cfg, w_bits=32), SEED,
                                torch.float32, "cuda")
    for p in train.leaves(params).values():
        p.requires_grad_(True)
    tc = train.TrainConfig(total_steps=100)
    step = train.make_train_step(cfg, tc, train.make_optimizer(tc, params))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = {"input_ids": torch.randint(0, cfg.vocab_size, (2, 2048),
                                        generator=gen, device="cuda")}
    step(params, teacher, batch)
    ts = []
    for _ in range(steps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        step(params, teacher, batch)
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, teacher, batch)
        torch.cuda.synchronize()
    per_kernel = device_ms_by_name(torch, prof, 1)
    busy = sum(per_kernel.values())
    span = statistics.median(ts)
    groups = {}
    for k, v in per_kernel.items():
        g = next((g for g, names in TRAIN_GROUPS
                  if any(n in k.lower() for n in names)),
                 "elementwise, copies, reductions")
        groups[g] = groups.get(g, 0.0) + v
    return {"event_ms": span, "event_ms_rounds": ts,
            "device_busy_ms": busy, "idle_share": 1.0 - busy / span,
            "device_ms_by_group": groups,
            "top_device_ops_ms": top_ms(per_kernel, 12)}


def phase_train(torch):
    """QAT at llama2_7b's widths, each step a hard check:
    1. the QAT fake-quants of a (256, 4096) normal on the card equal the
       CPU's bit for bit (``spec_probe.fake_quants_differing``);
    2. ``cli train`` (TRAIN_ARGV, ``--max_steps 8``, checkpoints into a
       temporary directory): every step's loss finite, 8 steps,
       checkpoint 8 the only one kept; each step's loss and gradient
       norm, the median seconds per step after the first, the peak
       device memory, the seconds of the whole command;
    3. the same command with ``--max_steps 12``: "resumed from step 8",
       trained to step 12, checkpoint 12 kept;
    4. CE training (no KD, w_bits 2, lr 1e-3, no remat) of 2 layers on
       one repeated [2, 256] batch for 15 steps: the last loss below 0.9
       x the first (the criterion of tests/test_qat.py's
       test_training_reduces_ce_loss);
    5. ``train_step_card_vs_cpu`` within TRAIN_CPU_GATES;
    6. ``cli generate-data --layers 4 --num_seeds 8 --length 128``: every
       token of each row's greedy prefix (``qat.data.greedy_lengths``,
       the generator's first draw) equals the argmax of a no-cache
       forward of the tokens before it;
    then where a train step's time goes (``train_step_profile``).
    No kernel of the repo runs here; the launches are read all the same.
    Returns the failures."""
    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.qat import data as qdata
    from mxq_tpu_torch.qat import train
    from mxq_tpu_torch.spec_probe import fake_quants_differing

    kernels = all_kernels()
    runs, failures, counted = {}, [], []
    torch.cuda.empty_cache()

    # 1. the fake-quants
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    runs["fake_quants_differing"] = diff = fake_quants_differing(
        torch.randn((256, 4096), generator=gen, device="cuda"))
    if any(diff.values()):
        failures.append(f"train: fake-quants on the card differ from the "
                        f"CPU's: {diff}")

    with tempfile.TemporaryDirectory(prefix="mxq_qat_") as tmp:
        out = os.path.join(tmp, "qat")
        argv = TRAIN_ARGV + ["--output_dir", out]
        # 2. 8 steps
        torch.cuda.reset_peak_memory_stats()
        res = count_launches(torch, kernels, lambda: dict(zip(
            ("result", "printed"), cli_with_output(argv + ["--max_steps",
                                                           "8"]))))
        counted.append(res.pop("launches"))
        m = train_metrics(os.path.join(out, "logs"), 1)
        run = {"command_seconds": res["seconds"], **m,
               "median_seconds_per_step_after_first": statistics.median(
                   m["seconds"][1:]) if len(m["seconds"]) > 1 else None,
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
               "eval_ppl": res["result"].get("eval_ppl"),
               "checkpoints": sorted(os.listdir(out))}
        runs["cli_train"] = run
        if (res["result"]["last_step"] != 8 or m["steps"] != list(
                range(1, 9)) or not all(map(math.isfinite, m["loss"]))
                or run["checkpoints"] != ["8", "logs"]):
            failures.append(f"train cli_train: {run}")
        # 3. resumed to 12
        res = count_launches(torch, kernels, lambda: dict(zip(
            ("result", "printed"), cli_with_output(argv + ["--max_steps",
                                                           "12"]))))
        counted.append(res.pop("launches"))
        m = train_metrics(os.path.join(out, "logs"), 9)
        run = {"command_seconds": res["seconds"], **m,
               "resumed": "resumed from step 8" in res["printed"],
               "checkpoints": sorted(os.listdir(out))}
        runs["cli_train_resume"] = run
        if (not run["resumed"] or res["result"]["last_step"] != 12
                or m["steps"] != list(range(9, 13))
                or not all(map(math.isfinite, m["loss"]))
                or run["checkpoints"] != ["12", "logs"]):
            failures.append(f"train cli_train_resume: {run}")
    torch.cuda.empty_cache()

    # 4. CE training on one repeated batch
    cfg = llama.LlamaConfig.llama2_7b(num_hidden_layers=2, w_bits=2)
    params = llama.init_params(cfg, SEED, torch.float32, "cuda")
    for p in train.leaves(params).values():
        p.requires_grad_(True)
    tc = train.TrainConfig(learning_rate=1e-3, use_kd=False, total_steps=30,
                           remat=False)
    step = train.make_train_step(cfg, tc, train.make_optimizer(tc, params))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = {"input_ids": torch.randint(0, cfg.vocab_size, (2, 256),
                                        generator=gen, device="cuda")}
    losses = [float(step(params, None, batch)["loss"]) for _ in range(15)]
    runs["ce_overfit"] = {"loss": losses,
                          "last_over_first": losses[-1] / losses[0]}
    if not losses[-1] < 0.9 * losses[0]:
        failures.append(f"train ce_overfit: losses {losses}")
    del params, step, batch
    torch.cuda.empty_cache()

    # 5. card against CPU
    runs["card_vs_cpu_step"] = r = train_step_card_vs_cpu(torch)
    bad = {k: r[k] for k, gate in TRAIN_CPU_GATES.items() if not r[k] <= gate}
    if bad:
        failures.append(f"train card_vs_cpu_step: {bad} beyond "
                        f"{TRAIN_CPU_GATES}")
    torch.cuda.empty_cache()

    # 6. generate-data
    with tempfile.TemporaryDirectory(prefix="mxq_gen_") as tmp:
        res = count_launches(torch, kernels, lambda: cli_with_output(
            ["generate-data", "--preset", "llama2_7b", "--layers", "4",
             "--num_seeds", "8", "--length", "128", "--seed", str(SEED),
             "--out_dir", tmp])[0])
        counted.append(res.pop("launches"))
        rows = len(qdata.read_jsonl_texts(res["path"]))
    tokens = torch.as_tensor(res.pop("tokens"), device="cuda")
    cfg = llama.LlamaConfig.llama2_7b(num_hidden_layers=4)
    params = llama.init_params(cfg, SEED, torch.float32, "cuda")
    with torch.no_grad():
        argmax = llama.forward(params, tokens, cfg, device="cuda")[0].argmax(
            -1)
    glen = qdata.greedy_lengths(8, 3, 5, torch.Generator(
        device="cuda").manual_seed(0)).tolist()
    checked = sum(g - 1 for g in glen)
    equal = sum(int((tokens[b, 1:g] == argmax[b, :g - 1]).sum())
                for b, g in enumerate(glen))
    runs["generate_data"] = {"seconds": res["seconds"], "rows": rows,
                             "greedy_tokens_checked": checked,
                             "greedy_tokens_equal": equal,
                             "in_vocab": bool(0 <= int(tokens.min())
                                              and int(tokens.max())
                                              < cfg.vocab_size)}
    if (equal != checked or rows != 8 or tuple(tokens.shape) != (8, 128)
            or not runs["generate_data"]["in_vocab"]):
        failures.append(f"train generate_data: {runs['generate_data']}")
    del params, tokens, argmax
    torch.cuda.empty_cache()
    runs["train_step_profile"] = train_step_profile(torch)
    torch.cuda.empty_cache()

    launches = {k: sum(c[k] for c in counted) for k in kernels}
    emit({"phase": "train", **runs, "launches_total": launches,
          "card": smi()})
    return failures


@contextlib.contextmanager
def plain_versions(mm, a8):
    """Route the packed linears (K1-K3, K5, K6), the K4 family, K11 and the
    uniform linears (K7, K8) through their plain PyTorch versions on the
    card, so one forward can be held against the same forward with the
    kernels on the same device (no kernel launches, no counts)."""
    from mxq_tpu_torch.ops import uniform4 as u4
    swaps = [(mm, "gemv_batched", mm.gemv_plain),
             (mm, "gemv_single", mm.gemv_plain),
             (mm, "gemv_quad", mm.gemv_plain),
             (mm, "gemv_bfexp", mm.gemv_bfexp_plain),
             (mm, "dequant_planes", mm.dequant_planes_plain),
             (mm, "dequant_int8_planes", mm.dequant_int8_planes_plain),
             (a8, "int8_decode_attention_fused_write",
              a8.int8_decode_attention_fused_write_plain),
             (a8, "int8_decode_attention_stacked",
              a8.int8_decode_attention_stacked_plain),
             (a8, "int8_decode_attention_cur_folded",
              a8.int8_decode_attention_cur_folded_plain),
             (a8, "int8_paged_decode_attend_update",
              a8.int8_paged_decode_attend_update_plain),
             (u4, "u4_gemv", u4.uniform_matmul_plain),
             (u4, "u2_gemv", u4.uniform_matmul_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


class WordIds:
    """The synthetic task's tokenizer: each word is a token id; ``bos``
    leads the ids unless ``add_special_tokens=False``."""
    bos_token_id = 1

    def __call__(self, text, add_special_tokens=True):
        ids = [int(w) for w in text.split()]
        head = [self.bos_token_id] if add_special_tokens else []
        return {"input_ids": head + ids}


def word_ids(text):
    """``WordIds`` without special tokens, as cli eval-tasks encodes."""
    import numpy as np
    return np.asarray(WordIds()(text, add_special_tokens=False)["input_ids"],
                      np.int32)


def synthetic_task(harness, vocab: int):
    """A multiple-choice task of random-token documents drawn from SEED:
    for each (lo, hi] of TASK_CLASSES, TASK_DOCS documents of
    TASK_CHOICES choices whose bos-prefixed requests are lo+1 to hi
    tokens long, so each class fills its own power-of-two length."""
    import numpy as np

    class Synthetic(harness.MultipleChoiceTask):
        name = "synthetic_random_tokens"

        def docs(self):
            rng = np.random.RandomState(SEED)
            words = lambda n: " ".join(  # noqa: E731
                map(str, rng.randint(3, vocab, size=n)))
            out = []
            for lo, hi in TASK_CLASSES:
                for _ in range(TASK_DOCS):
                    # 1 + ctx + choice in (lo, hi]: choices of 2-8 tokens
                    ctx = words(rng.randint(lo, hi - 8))
                    out.append(harness.MCDoc(
                        ctx, [words(rng.randint(2, 9))
                              for _ in range(TASK_CHOICES)],
                        int(rng.randint(TASK_CHOICES))))
            return out

    return Synthetic()


@contextlib.contextmanager
def recorded_scores(harness):
    """Record every ``MXQLM.loglikelihood`` call as (requests, results)."""
    calls, orig = [], harness.MXQLM.loglikelihood

    def recording(self, requests):
        out = orig(self, requests)
        calls.append((list(requests), out))
        return out

    harness.MXQLM.loglikelihood = recording
    try:
        yield calls
    finally:
        harness.MXQLM.loglikelihood = orig


def score_gaps(reqs, got, want) -> list:
    """|score - reference| per continuation token, per request (nats)."""
    return [abs(g[0] - w[0]) / len(r[1]) for r, g, w in zip(reqs, got, want)]


@contextlib.contextmanager
def reordered_gemv(torch, mm):
    """The GEMV's plain version with its K sum in another f32 order (two
    halves, added last): the same function, rounded as differently as a
    kernel's own order rounds it. Scores through it against the plain
    version's measure how far the model carries such rounding."""
    def halves(x, p, cfg=mm.DEFAULT_SCHEME):
        from mxq_tpu_torch import packfmt
        xb = x.to(torch.bfloat16).float()
        w = packfmt.unpack_dequant(p, cfg)
        h = w.shape[0] // 2
        return xb[:, :h] @ w[:h] + xb[:, h:] @ w[h:]

    names = ("gemv_batched", "gemv_single", "gemv_quad")
    saved = [getattr(mm, n) for n in names]
    for n in names:
        setattr(mm, n, halves)
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(mm, n, fn)


def task_batches(torch, lm, reqs, kernels, rounds=3) -> dict:
    """Per padded length of ``lm.loglikelihood(reqs)``: the rows each
    linear sees, the route (the kernels launched by one batch), and the
    CUDA-event ms of each batch's forward and scoring over ``rounds`` runs
    (after the caller's warm-up); then one profiled batch of each length:
    device busy ms, the idle share = 1 - busy / median event ms, and the
    device ms by kind (TASK_GROUPS; "other" is PyTorch's elementwise ops,
    copies and reductions)."""
    from torch.profiler import ProfilerActivity, profile

    orig, per = lm._score, {}

    def timed(ids, mask):
        before = {k: fn.launches for k, fn in kernels.items()}
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig(ids, mask)
        e1.record()
        e1.synchronize()
        b = per.setdefault(int(ids.shape[1]), {
            "rows_per_linear": int(ids.numel()), "ms": [],
            "route": sorted(k for k, fn in kernels.items()
                            if fn.launches > before[k]),
            "batch": (ids, mask)})
        b["ms"].append(e0.elapsed_time(e1))
        return out

    lm._score = timed
    try:
        for _ in range(rounds):
            lm.loglikelihood(reqs)
    finally:
        lm._score = orig
    for b in per.values():
        ids, mask = b.pop("batch")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lm._score(ids, mask)
            torch.cuda.synchronize()
        per_kernel = device_ms_by_name(torch, prof, 1)
        busy = sum(per_kernel.values())
        groups = {}
        for k, v in per_kernel.items():
            g = next((g for g, names in TASK_GROUPS
                      if any(n in k for n in names)), "other")
            groups[g] = groups.get(g, 0.0) + v
        b.update(batches_per_run=len(b["ms"]) // rounds,
                 device_ms_by_group=groups,
                 top_device_ops_ms=top_ms(per_kernel, 6),
                 ms_per_batch=statistics.median(b["ms"]),
                 device_busy_ms=busy,
                 idle_share=1.0 - busy / statistics.median(b["ms"]))
    return per


def generate_against_greedy(torch, lm, ctxs, tokens) -> dict:
    """``tokens`` (generate_batch's) teacher-forced through the forward
    ``greedy_generate`` runs for the last of them (bos + context + the
    tokens before it, right-padded to a power of two): at each position
    how far the token's logit trails the argmax's, over max|logit|."""
    from mxq_tpu_torch.eval import harness
    from mxq_tpu_torch.models import llama
    worst, off_argmax = 0.0, 0
    for ctx, gen in zip(ctxs, tokens):
        seq = [lm.bos_id, *map(int, ctx), *map(int, gen[:-1])]
        t_pad = min(harness._round_pow2(len(seq)), lm.max_len)
        ids = torch.zeros((1, t_pad), dtype=torch.int32, device="cuda")
        ids[0, :len(seq)] = torch.tensor(seq, dtype=torch.int32)
        with torch.no_grad():
            logits, _ = llama.forward(lm.params, ids, lm.cfg, device="cuda")
        start = len(ctx)                  # bos + ctx - 1: the first pick
        for j, tok in enumerate(map(int, gen)):
            row = logits[0, start + j]
            trail = float(row.max() - row[tok]) / float(row.abs().max())
            off_argmax += int(tok != int(row.argmax()))
            worst = max(worst, trail)
    return {"worst_trail_over_max_logit": worst,
            "tokens_off_argmax": off_argmax}


def task_gates(torch, lm, task, reqs, got, kernels, tag) -> tuple:
    """Checks b-d of :func:`phase_tasks` on ``lm``'s model, whose kernel
    scores of ``reqs`` are ``got``: (results by check, failures)."""
    from mxq_tpu_torch.ops import attn_int8 as a8
    from mxq_tpu_torch.ops import mxq_matmul as mm
    runs, failures = {}, []

    # b. kernels against their plain versions on the card; the gate per
    # continuation token: TASK_GATE, or FLOOR_FACTOR x the floor where
    # the model carries a reordered f32 sum further
    with plain_versions(mm, a8):
        plain = lm.loglikelihood(reqs)
        with reordered_gemv(torch, mm):
            reordered = lm.loglikelihood(reqs)
    floor = max(score_gaps(reqs, reordered, plain))
    gate = max(TASK_GATE, FLOOR_FACTOR * floor)
    gaps = score_gaps(reqs, got, plain)
    picks_equal = picks_gated = 0
    for d in range(0, len(reqs), TASK_CHOICES):
        doc = range(d, d + TASK_CHOICES)
        top = sorted(doc, key=lambda i: -got[i][0])
        apart = gate * (len(reqs[top[0]][1]) + len(reqs[top[1]][1]))
        same = (max(doc, key=lambda i: got[i][0])
                == max(doc, key=lambda i: plain[i][0]))
        picks_equal += same
        if got[top[0]][0] - got[top[1]][0] > apart:
            picks_gated += 1
            if not same:
                failures.append(f"tasks {tag} plain: document "
                                f"{d // TASK_CHOICES} picks another choice")
    runs["plain_versions"] = {
        "worst_gap_nats_per_token": max(gaps),
        "max_abs_gap_nats": max(abs(g[0] - w[0]) for g, w in zip(got, plain)),
        "floor_nats_per_token": floor, "gate_nats_per_token": gate,
        "picks_equal": picks_equal, "picks_gated": picks_gated,
        "documents": len(reqs) // TASK_CHOICES,
        "exact_flags_equal": sum(g[1] == w[1] for g, w in zip(got, plain))}
    if max(gaps) > gate:
        failures.append(f"tasks {tag} plain: a score off its plain version "
                        f"by {max(gaps):.3g} nats a token (gate "
                        f"{gate:.3g})")

    # c. right padding: alone (K1) and beside a long request (K3)
    short = min(reqs, key=lambda r: len(r[0]) + len(r[1]))
    long_ = max(reqs, key=lambda r: len(r[0]) + len(r[1]))
    alone = count_launches(torch, kernels, lambda: {
        "score": lm.loglikelihood([short])[0]})
    batched = count_launches(torch, kernels, lambda: {
        "score": lm.loglikelihood([short, long_])[0]})
    (gap,) = score_gaps([short], [alone["score"]], [batched["score"]])
    runs["right_padding"] = routes = {
        "alone": alone["score"][0], "batched": batched["score"][0],
        "gap_nats_per_token": gap, "gate_nats_per_token": gate,
        "continuation_tokens": len(short[1]),
        "alone_K1_K3": [alone["launches"]["K1"], alone["launches"]["K3"]],
        "batched_K1_K3": [batched["launches"]["K1"],
                          batched["launches"]["K3"]]}
    if (routes["alone_K1_K3"][0] == 0 or routes["alone_K1_K3"][1] > 0
            or routes["batched_K1_K3"][0] > 0
            or routes["batched_K1_K3"][1] == 0):
        failures.append(f"tasks {tag} right padding: routes {routes}")
    if gap > gate:
        failures.append(f"tasks {tag} right padding: {gap:.3g} nats a "
                        f"token (gate {gate:.3g})")

    # d. generate_batch against greedy_generate
    ctxs = [word_ids(doc.context)[:40] for doc in task.docs()[8:16]]
    runs["generate_batch"] = gen = count_launches(
        torch, kernels, lambda: {"tokens": [
            g.tolist() for g in lm.generate_batch(ctxs, max_new_tokens=16)]})
    if gen["launches"]["K1"] + gen["launches"]["K2"] <= 0:
        failures.append(f"tasks {tag} generate_batch: neither K1 nor K2 "
                        "launched")
    greedy = [lm.greedy_generate(c, 16).tolist() for c in ctxs]
    gen.update(generate_against_greedy(torch, lm, ctxs, gen["tokens"]),
               sequences_equal_greedy=sum(a == b for a, b in
                                          zip(gen["tokens"], greedy)),
               sequences=len(ctxs))
    if not all(len(t) == 16 for t in gen["tokens"]):
        failures.append(f"tasks {tag} generate_batch: a sequence is short")
    return runs, failures


def phase_tasks(torch):
    """Task evaluation (eval/harness.py) of llama2_7b at full depth, each
    run with its own launch counts:
    a. the packed model (bf16, random weights from the seed, packed on the
       card) scores a synthetic multiple-choice task (``synthetic_task``)
       through ``MXQLM(batch_size=8)``: batches of 8 rows padded to 32
       (256 rows a linear, K1), 64 and 128 tokens (512 and 1024 rows, K3);
       acc, acc_norm, the ms per batch of each length (CUDA events, after
       the scoring run as warm-up), its idle share (torch.profiler) and
       the tokens scored per second;
    b. the same requests with the plain versions on the card, and with
       the plain GEMV summing K in another f32 order (``reordered_gemv``:
       the floor, how far the model carries a rounding difference of the
       kind a kernel's order makes): each score within max(TASK_GATE,
       FLOOR_FACTOR x the floor) nats per continuation token of its
       plain version, and each document's pick equal where its top two
       choices lie further apart than their two gates;
    c. right padding: a short request alone (256 rows, K1) and batched
       beside a long one (1024 rows, K3), under the same gate;
    d. ``generate_batch`` (the Engine, bf16 cache: K1, or K2 at one live
       slot) on 8 contexts, 16 new tokens: teacher-forced through
       ``greedy_generate``'s forward, how far each token trails its
       argmax, over max|logit|; the sequences equal to
       ``greedy_generate``'s are counted;
    then b-d again with the same weights in float32 (only the linears'
    inputs rounded to bf16, as the kernels take them), where d's tokens
    must trail by at most GEN_GATE (the spec check's model and gate: at
    bf16 the two paths' own bf16 roundings part them further);
    e. ``cli eval-tasks --tasks list`` prints the registry; ``cli
       eval-tasks`` on the dense model with ``--w_bits 2`` (the fake-quant
       forward) scores the synthetic task through the ``WordIds``
       tokenizer: finite scores, no launch of a repo kernel.
    Returns (launches summed over the runs, failures)."""
    import io

    from mxq_tpu_torch import cli
    from mxq_tpu_torch.eval import harness
    from mxq_tpu_torch.models import llama

    kernels = all_kernels()
    runs, failures = {}, []
    t_phase = time.monotonic()
    cfg = llama.LlamaConfig.llama2_7b()
    task = synthetic_task(harness, cfg.vocab_size)
    for dtype in ("bfloat16", "float32"):
        params = llama.quantize_params_packed(
            llama.init_params(cfg, SEED, getattr(torch, dtype), "cuda"), cfg,
            device="cuda")
        lm = harness.MXQLM(params, cfg, batch_size=8,
                           bos_id=WordIds.bos_token_id, device="cuda")
        tag = f"packed_{dtype}"

        # a. the packed model's scores
        with recorded_scores(harness) as calls:
            runs[tag] = res = count_launches(
                torch, kernels, lambda: task.evaluate(lm, word_ids))
        (reqs, got), = calls
        for k in ("K1", "K3"):
            if res["launches"][k] <= 0:
                failures.append(f"tasks {tag}: {k} never launched")
        tokens = sum(len(c) + len(g) + 1 for c, g in reqs)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        again = lm.loglikelihood(reqs)
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        res.update(requests=len(reqs), tokens=tokens,
                   tokens_scored_per_s=tokens / seconds,
                   repeat_max_abs_gap=max(abs(a[0] - g[0])
                                          for a, g in zip(again, got)))
        if dtype == "bfloat16":
            res["batches"] = task_batches(torch, lm, reqs, kernels)
            for b in res["batches"].values():
                want = "K1" if b["rows_per_linear"] < 512 else "K3"
                if want not in b["route"]:
                    failures.append(f"tasks {tag}: {b['rows_per_linear']} "
                                    f"rows took {b['route']}, not {want}")
        more, f = task_gates(torch, lm, task, reqs, got, kernels, tag)
        runs.update({f"{tag}_{k}": v for k, v in more.items()})
        failures += f
        trail = more["generate_batch"]["worst_trail_over_max_logit"]
        if dtype == "float32" and trail > GEN_GATE:
            failures.append(f"tasks {tag} generate_batch: a token trails "
                            f"greedy's argmax by {trail:.3g} of max|logit| "
                            f"(gate {GEN_GATE})")
        del lm, params
        torch.cuda.empty_cache()

    # e. the registry, and cli eval-tasks on the fake-quant dense model
    listing = io.StringIO()
    with contextlib.redirect_stdout(listing):
        names = cli.main(["eval-tasks", "--tasks", "list"])
    printed = listing.getvalue().split()
    # wmt20's language pairs join the registry where sacrebleu is
    # installed (tasks_ext._translation_pairs), as in mxq_tpu
    runs["cli_list"] = {"names": len(printed), "sacrebleu": any(
        n.startswith("wmt20-") for n in printed)}
    if printed != sorted(harness.all_tasks()) or printed != names or \
            len(set(printed)) < REGISTRY_TASKS_AT_LEAST:
        failures.append(f"tasks cli list: {len(printed)} names printed")
    registry, tokenizer = harness.all_tasks, cli._tokenizer
    harness.all_tasks = lambda: {**registry(), task.name: task}
    cli._tokenizer = lambda args: WordIds()
    try:
        with recorded_scores(harness) as calls:
            runs["cli_w2"] = res = count_launches(torch, kernels, lambda: {
                "results": cli.main(
                    ["eval-tasks", "--preset", "llama2_7b", "--dtype",
                     "bfloat16", "--w_bits", "2", "--tasks", task.name,
                     "--limit", "4", "--seed", str(SEED)])})
    finally:
        harness.all_tasks, cli._tokenizer = registry, tokenizer
    scores = [s for _, out in calls for s, _ in out]
    res["scores"] = len(scores)
    if not (scores and all(math.isfinite(s) for s in scores)):
        failures.append("tasks cli_w2: a score is not finite")
    if any(res["launches"].values()):
        failures.append(f"tasks cli_w2: repo kernels launched "
                        f"{res['launches']}")
    torch.cuda.empty_cache()
    launches = {k: sum(r["launches"][k] for r in runs.values()
                       if "launches" in r) for k in kernels}
    emit({"phase": "tasks", **runs, "launches_total": launches,
          "seconds": time.monotonic() - t_phase, "card": smi()})
    return launches, failures


def phase_e2e(torch):
    """2 layers of 7B width, for two weight seeds and f32 and bf16
    activations: one B=8 decode step from a prefilled int8 cache (K1 + K4)
    and one 512-token prefill (K3).

    Gates, as rel = max|diff| / max|logit|:
    - on the card, kernels against the plain versions on the card (the same
      forward with every kernel swapped for its plain version): prefill
      <= 1e-3, which isolates K3 (its planes are bit-equal, so everything
      else is the same computation); decode <= 1e-2.
    - card against CPU from the same weights and state: decode <= 1e-2;
      prefill <= 1e-2 with f32 activations and <= 3e-2 with bf16, where
      the bf16 outputs of the two prefill GEMMs come from cuBLAS on one
      side and the CPU library on the other.
    - the paged decode step (K1 + K11) from a pool holding the same int8
      rows: against itself with the plain versions on the card, and
      against the slot engine's K4 step, each <= 1e-2 (K11 rounds
      p * v_scale against the running max of each page, K4 against the
      global max).
    - the slot engine's options (:func:`e2e_serve_options`).
    - the K6 layouts (:func:`e2e_layouts`): a decode step and a 128-row
      forward, each <= 1e-2 against the card's plain versions and against
      the CPU."""
    from mxq_tpu_torch import weights
    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.ops import attn_int8 as a8
    from mxq_tpu_torch.ops import mxq_matmul as mm
    from mxq_tpu_torch.serving import kvcache, paged

    cfg = llama.LlamaConfig.llama2_7b(num_hidden_layers=2)
    # both sides attend through SDPA in the prefill ("flash"), so the
    # kernels are what differs
    sdpa_cfg = dataclasses.replace(cfg, attn_impl="flash")
    gen = torch.Generator().manual_seed(SEED)
    b, t0, s = 8, 32, 256
    ids = torch.randint(0, cfg.vocab_size, (b, t0 + 1), generator=gen)
    pids = torch.randint(0, cfg.vocab_size, (1, 512), generator=gen)
    vids = torch.randint(0, cfg.vocab_size, (b, 5), generator=gen)
    rids = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen)
    counts = (mm.gemv_batched, a8.int8_decode_attention_fused_write,
              mm.dequant_planes)
    k11 = a8.KERNELS["K11"]
    failures, out = [], {"phase": "e2e"}

    def agree(a, ref):
        return float((a.argmax(-1) == ref.argmax(-1)).float().mean())

    def paged_logits(params, pool, tables):
        pos = torch.full((b,), t0, dtype=torch.int32, device="cuda")
        logits, _, _ = paged.paged_decode_step(
            params, pool.k_pages, pool.v_pages,
            ids[:, t0:].to("cuda", torch.int32), pos, tables, cfg)
        return logits.cpu()

    for dtype, host_pre_gate in ((torch.float32, 1e-2),
                                 (torch.bfloat16, 3e-2)):
        for wseed in (SEED + 1, SEED + 2):
            name = f"{str(dtype).split('.')[-1]}_seed{wseed}"
            params = llama.quantize_params_packed(
                llama.init_params(cfg, wseed, dtype, "cuda"), cfg,
                device="cuda")
            cache = kvcache.init_quant_cache(
                2, b, s, cfg.num_key_value_heads, cfg.head_dim,
                device="cuda")
            llama.forward(params, ids[:, :t0], cfg, caches=cache,
                          cache_pos=0, device="cuda")
            cpu_params = weights.params_to(params, "cpu")
            cpu_cache = {k: v.cpu() for k, v in cache.items()}
            plain_cache = {k: v.clone() for k, v in cache.items()}
            base = {k: v.clone() for k, v in cache.items()}
            opt_res, opt_fail = e2e_serve_options(
                torch, cfg, sdpa_cfg, params, cache, ids[:, t0:], vids, pids,
                t0)
            failures += [f"e2e {name} {f}" for f in opt_fail]
            pool, tables = pool_from_slot_cache(torch, paged, cfg, cache)
            plain_pool, _ = pool_from_slot_cache(torch, paged, cfg, cache)
            before = [fn.launches for fn in counts]
            k11_before = k11.launches
            card, _ = llama.forward(params, ids[:, t0:], cfg, caches=cache,
                                    cache_pos=t0, device="cuda")
            card_p, _ = llama.forward(params, pids, sdpa_cfg, device="cuda")
            card_paged = paged_logits(params, pool, tables)
            used = [fn.launches - n for fn, n in zip(counts, before)]
            k11_used = k11.launches - k11_before
            with plain_versions(mm, a8):
                plain, _ = llama.forward(params, ids[:, t0:], cfg,
                                         caches=plain_cache, cache_pos=t0,
                                         device="cuda")
                plain_p, _ = llama.forward(params, pids, sdpa_cfg,
                                           device="cuda")
                plain_paged = paged_logits(params, plain_pool, tables)
            plain_used = [fn.launches - n for fn, n in zip(counts, before)]
            k11_plain_used = k11.launches - k11_before - k11_used
            host, _ = llama.forward(cpu_params, ids[:, t0:], cfg,
                                    caches=cpu_cache, cache_pos=t0,
                                    device="cpu")
            host_p, _ = llama.forward(cpu_params, pids, sdpa_cfg,
                                      device="cpu")
            card, card_p = card.cpu(), card_p.cpu()
            plain, plain_p = plain.cpu(), plain_p.cpu()
            res = {"decode_rel_vs_card_plain": rel_err(card, plain),
                   "prefill_rel_vs_card_plain": rel_err(card_p, plain_p),
                   "decode_rel_vs_cpu": rel_err(card, host),
                   "prefill_rel_vs_cpu": rel_err(card_p, host_p),
                   "decode_argmax_agreement_vs_cpu": agree(card, host),
                   "prefill_argmax_agreement_vs_cpu": agree(card_p, host_p),
                   "paged_rel_vs_card_plain": rel_err(card_paged,
                                                      plain_paged),
                   "paged_rel_vs_slot_k4": rel_err(card_paged, card[:, 0]),
                   "paged_argmax_agreement_vs_slot_k4": agree(card_paged,
                                                              card[:, 0]),
                   "k1_k4_k3_launches": used,
                   "k11_launches": k11_used,
                   "shapes_finite": (
                       tuple(card.shape) == (b, 1, cfg.vocab_size)
                       and tuple(card_p.shape) == (1, 512, cfg.vocab_size)
                       and tuple(card_paged.shape) == (b, cfg.vocab_size)
                       and bool(torch.isfinite(card).all())
                       and bool(torch.isfinite(card_p).all())
                       and bool(torch.isfinite(card_paged).all())),
                   **opt_res}
            lay_res, lay_fail = e2e_layouts(torch, cfg, sdpa_cfg, params,
                                            cpu_params, base, ids[:, t0:],
                                            rids, t0)
            res.update(lay_res)
            failures += [f"e2e {name} {f}" for f in lay_fail]
            out[name] = res
            gates = {"decode_rel_vs_card_plain": 1e-2,
                     "prefill_rel_vs_card_plain": 1e-3,
                     "decode_rel_vs_cpu": 1e-2,
                     "prefill_rel_vs_cpu": host_pre_gate,
                     "paged_rel_vs_card_plain": 1e-2,
                     "paged_rel_vs_slot_k4": 1e-2}
            failures += [f"e2e {name} {k} {res[k]:.3g} > {g}"
                         for k, g in gates.items() if not res[k] <= g]
            if not res["shapes_finite"] or min(used) <= 0 \
                    or plain_used != used or k11_plain_used != 0 \
                    or k11_used != cfg.num_hidden_layers:
                failures.append(f"e2e {name}: shapes/launches {res}, "
                                f"plain run {plain_used}, K11 "
                                f"{k11_plain_used}")
            del params, cpu_params, cache, cpu_cache, plain_cache, pool, base
            del plain_pool
    emit(out)
    return failures


def e2e_layouts(torch, cfg, sdpa_cfg, params, cpu_params, base, ids, rids,
                t0):
    """The K6 layouts at 2 layers of 7B width, with ``mm.GEMV_LAYOUT`` set
    to quad, then bfexp: one B=8 decode step of ``ids`` from the prefilled
    int8 state ``base`` (left unchanged) and one 128-row forward of
    ``rids`` without a cache (under the 512-row prefill switch, so every
    packed linear is a K6 GEMV), each against the same with the plain
    versions on the card and against the CPU (which runs the layout's
    plain version): <= 1e-2 of max|logit|, the decode gates of
    :func:`phase_e2e`. K6 launches 8 times per layer (4 linears in each
    of the two calls), K1 never. Returns (results, failures)."""
    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.ops import attn_int8 as a8
    from mxq_tpu_torch.ops import mxq_matmul as mm

    def run(p, dev):
        state = {k: v.to(dev, copy=True) for k, v in base.items()}
        dec, _ = llama.forward(p, ids, cfg, caches=state, cache_pos=t0,
                               device=dev)
        fwd, _ = llama.forward(p, rids, sdpa_cfg, device=dev)
        return dec.cpu(), fwd.cpu()

    res, failures = {}, []
    saved = mm.GEMV_LAYOUT
    try:
        for layout in ("quad", "bfexp"):
            mm.GEMV_LAYOUT = layout
            k6 = mm.KERNELS["K6-" + layout]
            before = (k6.launches, mm.gemv_batched.launches)
            card = run(params, "cuda")
            used = [k6.launches - before[0],
                    mm.gemv_batched.launches - before[1]]
            with plain_versions(mm, a8):
                plain = run(params, "cuda")
            host = run(cpu_params, "cpu")
            r = {"decode_rel_vs_card_plain": rel_err(card[0], plain[0]),
                 "forward128_rel_vs_card_plain": rel_err(card[1], plain[1]),
                 "decode_rel_vs_cpu": rel_err(card[0], host[0]),
                 "forward128_rel_vs_cpu": rel_err(card[1], host[1])}
            failures += [f"{layout} {k} {v:.3g} > 0.01" for k, v in r.items()
                         if not v <= 1e-2]
            finite = all(bool(torch.isfinite(t).all()) for t in card)
            if not finite or used != [8 * cfg.num_hidden_layers, 0]:
                failures.append(f"{layout}: finite {finite}, K6 and K1 "
                                f"launches {used}")
            r["forward128_argmax_agreement_vs_cpu"] = float(
                (card[1].argmax(-1) == host[1].argmax(-1)).float().mean())
            r["k6_k1_launches"] = used
            res.update({f"{layout}_{k}": v for k, v in r.items()})
    finally:
        mm.GEMV_LAYOUT = saved
    return res, failures


def e2e_serve_options(torch, cfg, sdpa_cfg, params, cache, ids, vids, pids,
                      t0):
    """The slot engine's three serve options at 2 layers of 7B width, from
    the prefilled int8 state ``cache`` (left unchanged):
    - the int8-activation prefill (K5) of the 512 tokens ``pids``, against
      the same forward with the plain versions on the card (<= 1e-3: K5's
      planes equal its plain version's, the int8 GEMM is exact) and
      reported against the bf16-plane (K3) prefill (<= 0.1: the int8
      quantization error, 4.7e-2 to 5.9e-2 of max|logit| on the tiny
      model's CPU tests; the linear alone is held to 3e-2 in the kernels
      phase);
    - one B=8 decode step with the uniform-4b head (K7) against the plain
      versions (<= 1e-2);
    - one T=5 verify step (``vids``; K4a) against 5 sequential decode steps
      fed the same tokens from the same state (<= 1e-2; argmax agreement
      reported).
    Returns (results, failures)."""
    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.ops import attn_int8 as a8
    from mxq_tpu_torch.ops import mxq_matmul as mm
    from mxq_tpu_torch.ops import uniform4 as u4

    b = ids.shape[0]
    k5, k7, k4a = mm.KERNELS["K5"], u4.KERNELS["K7"], a8.KERNELS["K4a"]
    state = lambda: {k: v.clone() for k, v in cache.items()}  # noqa: E731
    a8_cfg = dataclasses.replace(sdpa_cfg, prefill_act_bits=8)
    params_u4 = dict(params, lm_head=u4.quantize_pack_u4(
        params["lm_head"].T))
    dev_ids = ids.to("cuda", torch.int32)
    dev_vids = vids.to("cuda", torch.int32)
    pos = torch.full((b,), t0, dtype=torch.int32, device="cuda")
    before = (k5.launches, k7.launches, k4a.launches)
    card_a8, _ = llama.forward(params, pids, a8_cfg, device="cuda")
    card_u4 = llama.decode_slots(params_u4, dev_ids, cfg, state(), pos)
    verify = llama.decode_slots(params, dev_vids, cfg, state(), pos)
    used = [c.launches - n for c, n in zip((k5, k7, k4a), before)]
    seq_cache = state()
    steps = torch.cat([llama.decode_slots(params, dev_vids[:, i:i + 1], cfg,
                                          seq_cache, pos + i)
                       for i in range(vids.shape[1])], dim=1)
    with plain_versions(mm, a8):
        plain_a8, _ = llama.forward(params, pids, a8_cfg, device="cuda")
        plain_u4 = llama.decode_slots(params_u4, dev_ids, cfg, state(), pos)
    k3_pre, _ = llama.forward(params, pids, sdpa_cfg, device="cuda")
    plain_used = [c.launches - n for c, n in zip((k5, k7, k4a), before)]
    res = {"a8_prefill_rel_vs_card_plain": rel_err(card_a8, plain_a8),
           "a8_prefill_rel_vs_k3_prefill": rel_err(card_a8, k3_pre),
           "a8_prefill_argmax_agreement_vs_k3": float(
               (card_a8.argmax(-1) == k3_pre.argmax(-1)).float().mean()),
           "u4_head_decode_rel_vs_card_plain": rel_err(card_u4, plain_u4),
           "verify_rel_vs_sequential_decode": rel_err(verify, steps),
           "verify_argmax_agreement_vs_sequential": float(
               (verify.argmax(-1) == steps.argmax(-1)).float().mean()),
           "k5_k7_k4a_launches": used}
    gates = {"a8_prefill_rel_vs_card_plain": 1e-3,
             "a8_prefill_rel_vs_k3_prefill": 0.1,
             "u4_head_decode_rel_vs_card_plain": 1e-2,
             "verify_rel_vs_sequential_decode": SPEC_GATE}
    failures = [f"{k} {res[k]:.3g} > {g}" for k, g in gates.items()
                if not res[k] <= g]
    finite = all(bool(torch.isfinite(t).all())
                 for t in (card_a8, card_u4, verify))
    if not finite or min(used) <= 0 or plain_used != used:
        failures.append(f"options: finite {finite}, K5/K7/K4a launches "
                        f"{used}, after the plain run {plain_used}")
    return res, failures


def pool_from_slot_cache(torch, paged, cfg, cache):
    """A PagedPool holding the rows of the stacked int8 slot cache (codes
    [L, B, H, S, D], S a multiple of 128): slot b's rows in logical pages
    1 + b*pps .. (b+1)*pps in order. Returns (pool, page tables [B, pps])."""
    l, b, h, s, d = cache["k_codes"].shape
    ps = 128
    pps = s // ps
    npg = 1 + b * pps
    pool = paged.PagedPool.create(cfg, b, npg, max_len=s, kv_bits=8,
                                  device="cuda")
    for name, pages in (("k", pool.k_pages), ("v", pool.v_pages)):
        codes = cache[f"{name}_codes"].reshape(l, b, h, pps, ps, d)
        pages["codes"].view(h, l, npg, ps, d)[:, :, 1:] = codes.permute(
            2, 0, 1, 3, 4, 5).reshape(h, l, b * pps, ps, d)
        scales = cache[f"{name}_scale"].reshape(l, b, h, pps, ps)
        pages["scales"].view(h, l, npg, ps)[:, :, 1:] = scales.permute(
            2, 0, 1, 3, 4).reshape(h, l, b * pps, ps)
    tables = (1 + torch.arange(b * pps, dtype=torch.int32,
                               device="cuda")).reshape(b, pps)
    return pool, tables


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    # one run of CLI_SERVE printing its launch counts and tokens
    # (layout_serve's child process)
    ap.add_argument("--serve-child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import mxq_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the mxq_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.serve_child:
        emit(count_launches(torch, all_kernels(),
                            lambda: serve_with_tokens(CLI_SERVE)))
        return 0

    failures, summary, launches = [], {}, {}
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        summary, f = phase_kernels(torch, Timer(torch))
        failures += f
    if "serve" in phases:
        launches, f = phase_serve(torch)
        failures += f
    if "eval" in phases:
        more, f = phase_eval(torch)
        for k, n in more.items():
            launches[k] = launches.get(k, 0) + n
        failures += f
    if "ptq" in phases:
        more, f = phase_ptq(torch)
        for k, n in more.items():
            launches[k] = launches.get(k, 0) + n
        failures += f
    if "train" in phases:
        failures += phase_train(torch)
    if "tasks" in phases:
        more, f = phase_tasks(torch)
        for k, n in more.items():
            launches[k] = launches.get(k, 0) + n
        failures += f
    if "e2e" in phases:
        failures += phase_e2e(torch)
    torch.cuda.synchronize()

    if summary:
        emit({"kernels": [
            {"name": k, "route": KERNEL_INFO[k][0],
             "source": KERNEL_INFO[k][1], "replaces": KERNEL_INFO[k][2],
             "launches": launches.get(COUNTER.get(k, k)), **summary[k]}
            for k in sorted(summary)]})
    print(smi(), flush=True)
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
