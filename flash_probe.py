"""Check and time K13's kernels (``mxq_tpu_torch/csrc/flash_attn.cu``)
and K13-bwd's (``csrc/flash_attn_bwd.cu``), at bfloat16 and float32, on
the card beside SDPA, and beside the same kernels of other trees of the
package.

    python3 flash_probe.py                             # this tree alone
    python3 flash_probe.py --trees parent=out/parent   # and a parent's

Each tree (this one as ``this``; ``--trees NAME=ROOT,...`` adds other
trees, a ``git archive`` of the parent, say) runs in a process of its own
with its root first on ``sys.path``: it builds its own sources through its
own ``_build`` (into ``ROOT/mxq_tpu_torch/_build/``) and is called through
its own wrappers, ``flash_prefill_attention``, ``flash_attention_forward``
and ``flash_attention_backward``, whatever their C entries take. With
other trees the processes run as the others, this, this, then the others
in reverse, so that a drift of the card over the call falls on both sides.
A tree prints ptxas' registers and spills for the kernels it built, then
per case and type one JSON line: the forward's max error over max|ctx| against the
plain version (``flash_prefill_attention_plain``) on q, k, v sliced from
one fused qkv tensor with k, v 7 rows longer than q, whether two calls
give the same bits, and whether k, v rows past T filled with NaN give the
bits that zeros there give; the backward's max error of dQ, dK and dV over
each one's max against ``flash_attention_bwd_plain`` on the tree's own o
and lse, and whether two calls give the same bits (gates: bf16 2e-2,
float32 1e-4). Then per type and shape (llama2_7b's prefills at T = 512
and 2048, 32 heads of 128, and llama2_70b's G = 8 at 512) the CUDA-event
median with the L2 flushed before each call (``utils.benchlib.Timer``, as
``chip_smoke.py``'s kernels phase times K13 and K13-bwd) of the forward
and of the backward, the TFLOP/s of each over the causal half (4 and 10
Hq D T(T+1)/2 operations), at float32 the device ms of each kernel of one
call by name (torch.profiler: the split pass's share), and SDPA's times on
the same inputs (``is_causal``, k and v repeated to Hq heads; its
backward one ``torch.autograd.grad`` from a kept graph). Needs a CUDA
device."""

from __future__ import annotations

import argparse
import itertools
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

# (B, T, Hq, Hkv, D) held against the plain versions: tile and block edges
CHECKS = [(2, 1, 4, 2, 64), (2, 127, 8, 8, 128), (2, 129, 16, 2, 128),
          (1, 257, 4, 2, 64), (1, 2048, 32, 32, 128), (1, 512, 64, 8, 128)]
# (T, Hq, Hkv) timed at B = 1, D = 128
TIMED = [(2048, 32, 32), (512, 32, 32), (512, 64, 8)]
DTYPES = {"bfloat16": 2e-2, "float32": 1e-4}   # and each one's gate
SOURCES = ("flash_attn", "flash_attn_bwd")
HERE = Path(__file__).resolve().parent


def qkv(gen, b, t, hq, hkv, d, dtype):
    """q, k, v as the fused qkv projection's strided slices, k and v 7
    rows longer than q."""
    x = torch.randn((b, t + 7, (hq + 2 * hkv) * d), generator=gen,
                    device="cuda").to(dtype)
    return (x[:, :t, :hq * d].reshape(b, t, hq, d),
            x[..., hq * d:(hq + hkv) * d].reshape(b, t + 7, hkv, d),
            x[..., (hq + hkv) * d:].reshape(b, t + 7, hkv, d))


def grad_errs(got, ref) -> list:
    """Each gradient's max |got - ref| over its max |ref| (dV's max for dQ
    and dK at T = 1, where both are rounding noise around 0)."""
    scale = [float(r.float().abs().max()) for r in ref]
    if ref[0].shape[1] == 1:
        scale[0] = scale[1] = scale[2]
    return [float((g.float() - r.float()).abs().max()) / m
            for g, r, m in zip(got, ref, scale)]


def by_name(fn, calls=3) -> dict:
    """Device ms a call of ``fn`` by kernel name (torch.profiler over
    ``calls`` calls after one warm-up), the first 60 characters of each
    name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out[e.key[:60]] = out.get(e.key[:60], 0.0) + us / 1e3 / calls
    return out


def probe_tree(name: str, root: str) -> int:
    """Build, check and time one tree's kernels through its own package."""
    sys.path.insert(0, str(Path(root).resolve()))
    from mxq_tpu_torch import _build
    from mxq_tpu_torch.ops import attn_bf16 as ab
    from mxq_tpu_torch.utils.benchlib import Timer
    if not Path(ab.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"tree {name}: imported {ab.__file__}")
    logs = {}
    _build.build(SOURCES, verbose=True, logs=logs)
    for src, log in logs.items():
        print(json.dumps({"tree": name, "source": src,
                          **_build.ptxas_report(log, "kernel")}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for (b, t, hq, hkv, d), (dname, gate) in itertools.product(
            CHECKS, DTYPES.items()):
        dtype = getattr(torch, dname)
        q, k, v = qkv(gen, b, t, hq, hkv, d, dtype)
        ref = ab.flash_prefill_attention_plain(q, k, v).float()
        kn, vn = k.clone(), v.clone()
        kn[:, t:] = vn[:, t:] = float("nan")
        kz, vz = k.clone(), v.clone()
        kz[:, t:] = vz[:, t:] = 0
        do = torch.randn((b, t, hq, d), generator=gen, device="cuda").to(
            dtype)
        got = ab.flash_prefill_attention(q, k, v)
        again = ab.flash_prefill_attention(q, k, v)
        nan_tail = ab.flash_prefill_attention(q, kn, vn)
        zero_tail = ab.flash_prefill_attention(q, kz, vz)
        o, lse = ab.flash_attention_forward(q, k, v)
        gref = ab.flash_attention_bwd_plain(q, k, v, o, lse, do)
        grads = ab.flash_attention_backward(q, k, v, o, lse, do)
        grads2 = ab.flash_attention_backward(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        print(json.dumps({
            "tree": name, "B": b, "T": t, "Hq": hq, "Hkv": hkv, "D": d,
            "dtype": dname, "gate": gate,
            "rel_err": float((got.float() - ref).abs().max()
                             / ref.abs().max()),
            "deterministic": torch.equal(got, again),
            "nan_tail_equal": torch.equal(nan_tail, zero_tail),
            "finite": bool(torch.isfinite(nan_tail).all()),
            "bwd_rel_err_dq_dk_dv": grad_errs(grads, gref),
            "bwd_deterministic": all(torch.equal(x, y)
                                     for x, y in zip(grads, grads2)),
            "bwd_finite": all(bool(torch.isfinite(x).all()) for x in grads)}),
            flush=True)

    timer = Timer()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dname, (t, hq, hkv) in itertools.product(DTYPES, TIMED):
        d = 128
        q, k, v, do = (torch.randn((1, t, h, d), generator=gen,
                                   device="cuda").to(getattr(torch, dname))
                       for h in (hq, hkv, hkv, hq))
        o, lse = ab.flash_attention_forward(q, k, v)
        flops = 4.0 * hq * d * t * (t + 1) / 2
        row = {"tree": name, "dtype": dname, "T": t, "Hq": hq, "Hkv": hkv,
               "D": d}
        ms = timer(lambda: ab.flash_prefill_attention(q, k, v))
        bms = timer(lambda: ab.flash_attention_backward(q, k, v, o, lse, do))
        row["kernels"] = {"ms": ms, "tflops": flops / ms * 1e-9,
                          "bwd_ms": bms, "bwd_tflops": 2.5 * flops / bms
                          * 1e-9}
        if dname == "float32":
            row["kernels"]["device_ms_by_name"] = {
                "forward": by_name(lambda: ab.flash_prefill_attention(
                    q, k, v)),
                "backward": by_name(lambda: ab.flash_attention_backward(
                    q, k, v, o, lse, do))}
        kr, vr = (a.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
                  for a in (k, v))
        ms = timer(lambda: sdpa(q.transpose(1, 2), kr, vr, is_causal=True,
                                scale=1.0 / math.sqrt(d)))
        leaves = [a.detach().requires_grad_() for a in (q.transpose(1, 2),
                                                        kr, vr)]
        lib = sdpa(*leaves, is_causal=True, scale=1.0 / math.sqrt(d))
        dot = do.transpose(1, 2)
        bms = timer(lambda: torch.autograd.grad(lib, leaves, dot,
                                                retain_graph=True))
        row["sdpa"] = {"ms": ms, "tflops": flops / ms * 1e-9,
                       "bwd_ms": bms, "bwd_tflops": 2.5 * flops / bms * 1e-9}
        print(json.dumps(row), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", default="",
                    help="NAME=ROOT,...: other trees of the package, each "
                         "built and timed as NAME")
    ap.add_argument("--tree", help=argparse.SUPPRESS)   # NAME=ROOT: one tree
    args = ap.parse_args(argv)
    if args.tree:
        return probe_tree(*args.tree.split("=", 1))
    others = [t.split("=", 1) for t in filter(None, args.trees.split(","))]
    order = [*others, ("this", str(HERE))]
    if others:
        order += [("this", str(HERE)), *others[::-1]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    for name, root in order:
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--tree", f"{name}={root}"], check=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
