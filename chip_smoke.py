#!/usr/bin/env python3
"""Drive the PyTorch port (mxq_tpu_torch) on one NVIDIA H100 and check it.

    python3 chip_smoke.py                  # every phase, as the checks run it
    python3 chip_smoke.py --phases build,kernels

Phases, each printing one JSON line:
  build    compile csrc/*.cu with nvcc (one process per source, in parallel)
  kernels  hold K1-K4 against their plain PyTorch versions at llama2_7b's
           shapes and time kernel, plain version, bound and library call
  serve    three runs of llama2_7b at full depth, each with the launch
           counts set to 0 before it and read after it:
           `mxq_tpu_torch.cli serve --preset llama2_7b --packed --kv_bits 8`
           in-process (must launch K1, K4), the Engine at 8 slots with
           prompts in every prefill bucket (K1, K3, K4), and a one-slot
           Engine (K2, K4)
  e2e      at 2 layers of 7B width, one B=8 decode step and one 512-token
           prefill with the kernels, held against the same forward with
           the plain versions on the card and against the CPU
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
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (data sheet)
BF16_FLOP_PER_S = 989e12      # H100 SXM dense bf16 tensor cores (data sheet)
BOUND_BASIS = "max(bytes / 3.35 TB/s HBM, operations / 989 TFLOP/s bf16)"
SEED = 0
PHASES = ("build", "kernels", "serve", "e2e")

# llama2_7b packed linears of one layer: name -> (out, in)
SHAPES_7B = {"qkv": (3 * 4096, 4096), "o": (4096, 4096),
             "gate_up": (2 * 11008, 4096), "down": (4096, 11008)}

KERNEL_INFO = {
    "K1": ("cuda", "mxq_tpu_torch/csrc/mxq_gemv.cu",
           "mxq_tpu/ops/mxq_matmul.py:66"),
    "K2": ("cuda", "mxq_tpu_torch/csrc/mxq_gemv.cu",
           "mxq_tpu/ops/mxq_matmul.py:360"),
    "K3": ("cuda", "mxq_tpu_torch/csrc/mxq_dequant.cu",
           "mxq_tpu/ops/mxq_matmul.py:713"),
    "K4": ("cuda", "mxq_tpu_torch/csrc/attn_int8.cu",
           "mxq_tpu/ops/attn_int8.py:318"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median of CUDA-event timings of device work. Before every timed call
    the L2 cache (50 MB) is flushed, as the decode path finds weights cold,
    and the card spins for about a millisecond so that the host has queued
    the whole call before the first event: the events then bracket device
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

    # K1 (B=8, B=128) and K2 (B=1): fp32 FMA on CUDA cores, gate 1e-4
    for key, batches in (("K2", (1,)), ("K1", (8, 128))):
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
    return summary, failures


def phase_serve(torch):
    from mxq_tpu_torch import cli
    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.ops import attn_int8 as a8
    from mxq_tpu_torch.ops import mxq_matmul as mm
    from mxq_tpu_torch.serving import engine as eng
    import numpy as np

    kernels = {**mm.KERNELS, **a8.KERNELS}
    runs, failures = {}, []

    def counted(name, need, drive):
        """Run ``drive`` with every launch count set to 0 just before it
        and read just after; fail if a kernel in ``need`` never launched."""
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.monotonic()
        res = drive()
        torch.cuda.synchronize()
        res["seconds"] = time.monotonic() - t0
        res["launches"] = {k: fn.launches for k, fn in kernels.items()}
        runs[name] = res
        failures.extend(f"{name}: {k} never launched" for k in need
                        if res["launches"][k] <= 0)

    # the README's main-path command, at the cli's default dtype (float32)
    counted("cli", ("K1", "K4"), lambda: cli.main(
        ["serve", "--preset", "llama2_7b", "--packed", "--kv_bits", "8",
         "--slots", "8", "--max_len", "2048", "--requests", "8",
         "--prompt_len", "100", "--max_new_tokens", "32",
         "--seed", str(SEED)]))
    if runs["cli"]["requests"] != 8 or runs["cli"]["tokens"] != 8 * 32:
        failures.append(f"cli serve finished {runs['cli']['requests']} "
                        f"requests, {runs['cli']['tokens']} tokens")

    cfg = llama.LlamaConfig.llama2_7b()
    params = llama.quantize_params_packed(
        llama.init_params(cfg, SEED, torch.bfloat16, "cuda"), cfg,
        device="cuda")
    rng = np.random.default_rng(SEED)

    def engine_run(slots, plens):
        e = eng.Engine(params, cfg, eng.EngineConfig(
            num_slots=slots, max_len=2048, seed=SEED), device="cuda")
        reqs = [e.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                         max_new_tokens=16) for n in plens]
        t1 = time.monotonic()
        done = e.run()
        torch.cuda.synchronize()
        dt = time.monotonic() - t1
        toks = [len(r.generated) for r in reqs]
        if len(done) != len(reqs) or any(n != 16 for n in toks) or any(
                not 0 <= t < cfg.vocab_size for r in reqs
                for t in r.generated):
            failures.append(f"engine slots={slots}: tokens {toks}")
        return {"prompt_lens": list(plens), "requests_finished": len(done),
                "tokens": sum(toks), "tokens_per_sec": sum(toks) / dt,
                "stats": e.stats()}

    # prompts in the 128 (K1), 512 and 2048 (K3) prefill buckets; decode
    # at 8 slots (K1, K4) and at 1 slot (K2, K4)
    counted("engine_slots8", ("K1", "K3", "K4"),
            lambda: engine_run(8, (100, 400, 1500, 100, 400, 1500)))
    counted("engine_slots1", ("K2", "K4"), lambda: engine_run(1, (100,)))
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in kernels}
    profile = decode_step_profile(torch, params, cfg)
    del params
    emit({"phase": "serve", **runs, "launches_total": launches,
          "decode_step_profile": profile})
    return launches, failures


def decode_step_profile(torch, params, cfg, b=8, pos=1000, steps=4):
    """Where a decode step's time goes: the engine's decode forward for
    ``b`` slots at cache position ``pos`` of the full model. Wall time per
    step from the host clock without the profiler; device time per kernel
    from torch.profiler; idle share = 1 - device busy / wall."""
    from torch.profiler import ProfilerActivity, profile
    from mxq_tpu_torch.serving import engine as eng
    from mxq_tpu_torch.serving import kvcache

    cache = kvcache.init_quant_cache(cfg.num_hidden_layers, b, 2048,
                                     cfg.num_key_value_heads, cfg.head_dim,
                                     device="cuda")
    toks = torch.zeros((b, 1), dtype=torch.int32, device="cuda")
    start = torch.full((b,), pos, dtype=torch.int32, device="cuda")

    def run():
        for i in range(steps):
            eng._forward_multipos(params, toks, cfg, cache, start + i)
        torch.cuda.synchronize()

    run()
    t0 = time.monotonic()
    run()
    wall_ms = (time.monotonic() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    per_kernel = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us / 1e3 / steps
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"slots": b, "position": pos, "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy,
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "top_kernels_ms_per_step": {k[:80]: v for k, v in top}}


@contextlib.contextmanager
def plain_versions(mm, a8):
    """Route the packed linears and K4 through their plain PyTorch versions
    on the card, so one forward can be held against the same forward with
    the kernels on the same device (no kernel launches, no counts)."""
    saved = (mm.gemv_batched, mm.gemv_single, mm.dequant_planes,
             a8.int8_decode_attention_fused_write)
    mm.gemv_batched = mm.gemv_single = mm.gemv_plain
    mm.dequant_planes = mm.dequant_planes_plain
    a8.int8_decode_attention_fused_write = \
        a8.int8_decode_attention_fused_write_plain
    try:
        yield
    finally:
        (mm.gemv_batched, mm.gemv_single, mm.dequant_planes,
         a8.int8_decode_attention_fused_write) = saved


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
      side and the CPU library on the other."""
    from mxq_tpu_torch import weights
    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.ops import attn_int8 as a8
    from mxq_tpu_torch.ops import mxq_matmul as mm
    from mxq_tpu_torch.serving import kvcache

    cfg = llama.LlamaConfig.llama2_7b(num_hidden_layers=2)
    # both sides attend through SDPA in the prefill ("flash"), so the
    # kernels are what differs
    sdpa_cfg = dataclasses.replace(cfg, attn_impl="flash")
    gen = torch.Generator().manual_seed(SEED)
    b, t0, s = 8, 32, 256
    ids = torch.randint(0, cfg.vocab_size, (b, t0 + 1), generator=gen)
    pids = torch.randint(0, cfg.vocab_size, (1, 512), generator=gen)
    counts = (mm.gemv_batched, a8.int8_decode_attention_fused_write,
              mm.dequant_planes)
    failures, out = [], {"phase": "e2e"}

    def agree(a, ref):
        return float((a.argmax(-1) == ref.argmax(-1)).float().mean())

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
            before = [fn.launches for fn in counts]
            card, _ = llama.forward(params, ids[:, t0:], cfg, caches=cache,
                                    cache_pos=t0, device="cuda")
            card_p, _ = llama.forward(params, pids, sdpa_cfg, device="cuda")
            used = [fn.launches - n for fn, n in zip(counts, before)]
            with plain_versions(mm, a8):
                plain, _ = llama.forward(params, ids[:, t0:], cfg,
                                         caches=plain_cache, cache_pos=t0,
                                         device="cuda")
                plain_p, _ = llama.forward(params, pids, sdpa_cfg,
                                           device="cuda")
            plain_used = [fn.launches - n for fn, n in zip(counts, before)]
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
                   "k1_k4_k3_launches": used,
                   "shapes_finite": (
                       tuple(card.shape) == (b, 1, cfg.vocab_size)
                       and tuple(card_p.shape) == (1, 512, cfg.vocab_size)
                       and bool(torch.isfinite(card).all())
                       and bool(torch.isfinite(card_p).all()))}
            out[name] = res
            gates = {"decode_rel_vs_card_plain": 1e-2,
                     "prefill_rel_vs_card_plain": 1e-3,
                     "decode_rel_vs_cpu": 1e-2,
                     "prefill_rel_vs_cpu": host_pre_gate}
            failures += [f"e2e {name} {k} {res[k]:.3g} > {g}"
                         for k, g in gates.items() if not res[k] <= g]
            if not res["shapes_finite"] or min(used) <= 0 \
                    or plain_used != used:
                failures.append(f"e2e {name}: shapes/launches {res}, "
                                f"plain run {plain_used}")
            del params, cpu_params, cache, cpu_cache, plain_cache
    emit(out)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    phases = [p for p in ap.parse_args(argv).phases.split(",") if p]
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

    failures, summary, launches = [], {}, {}
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        summary, f = phase_kernels(torch, Timer(torch))
        failures += f
    if "serve" in phases:
        launches, f = phase_serve(torch)
        failures += f
    if "e2e" in phases:
        failures += phase_e2e(torch)
    torch.cuda.synchronize()

    if summary:
        emit({"kernels": [
            {"name": k, "route": KERNEL_INFO[k][0],
             "source": KERNEL_INFO[k][1], "replaces": KERNEL_INFO[k][2],
             "launches": launches.get(k), **summary[k]}
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
