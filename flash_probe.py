"""Check and time K13's bf16 kernel (``mxq_tpu_torch/csrc/flash_attn.cu``)
on the card beside SDPA, and beside the same source of other trees.

    python3 flash_probe.py                             # this tree alone
    python3 flash_probe.py --trees parent=out/parent   # and a parent's

Each tree's ``mxq_tpu_torch/csrc/flash_attn.cu`` (this one's as ``this``;
``--trees NAME=ROOT,...`` adds those of other trees of the package, a
``git archive`` of the parent, say) is built with nvcc into
``_build/probe/`` and called through the C entry ``flash_attn``. Each
prints ptxas' registers and spills for its kernels, then per case one
JSON line: the max error over max|ctx| against the plain version
(``flash_prefill_attention_plain``) on q, k, v sliced from one fused qkv tensor with k, v 7 rows longer than q,
whether two calls give the same bits, and whether k, v rows past T
filled with NaN give the bits that zeros there give. Then per shape
(llama2_7b's prefills at T = 512 and 2048, 32 heads of 128, and
llama2_70b's G = 8 at 512) the CUDA-event median with the L2 flushed
before each call (``utils.benchlib.Timer``, as ``chip_smoke.py``'s
kernels phase times K13), its TFLOP/s over the causal half's 4 Hq D
T(T+1)/2 operations, and SDPA's time on the same inputs (``is_causal``,
k and v repeated to Hq heads). Needs a CUDA device."""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
from pathlib import Path

import torch

from mxq_tpu_torch import _build
from mxq_tpu_torch.ops import attn_bf16 as ab
from mxq_tpu_torch.utils.benchlib import Timer

# (B, T, Hq, Hkv, D) held against the plain version: tile and block edges
CHECKS = [(2, 1, 4, 2, 64), (2, 127, 8, 8, 128), (2, 129, 16, 2, 128),
          (1, 257, 4, 2, 64), (1, 2048, 32, 32, 128), (1, 512, 64, 8, 128)]
# (T, Hq, Hkv) timed at B = 1, D = 128
TIMED = [(2048, 32, 32), (512, 32, 32), (512, 64, 8)]


def build_trees(csrcs: dict) -> dict:
    """{tree: loaded library} from {tree: its csrc directory}, built in
    parallel."""
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for v, csrc in csrcs.items():
        lib = out_dir / f"libflash_attn_{v}.so"
        cmd = [_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-I", str(csrc), "-Xptxas", "-v", "-o", str(lib),
               str(csrc / "flash_attn.cu")]
        procs[v] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    libs = {}
    for v, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for tree {v}:\n{log}")
        print(json.dumps({"tree": v, **_build.ptxas_report(log, "flash_")}),
              flush=True)
        dll = ctypes.CDLL(str(lib))
        dll.flash_attn.argtypes = _build.SIGNATURES["flash_attn"]["flash_attn"]
        dll.flash_attn.restype = ctypes.c_int
        libs[v] = dll
    return libs


def call(dll, q, k, v):
    b, t, hq, d = q.shape
    q, k, v = ab._rows(q), ab._rows(k), ab._rows(v)
    out = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    err = dll.flash_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), b, t, hq, k.shape[2], d, 0, 1.0 / math.sqrt(d),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "K13")
    return out


def qkv(gen, b, t, hq, hkv, d):
    """q, k, v as the fused qkv projection's strided slices, k and v 7
    rows longer than q."""
    x = torch.randn((b, t + 7, (hq + 2 * hkv) * d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    return (x[:, :t, :hq * d].reshape(b, t, hq, d),
            x[..., hq * d:(hq + hkv) * d].reshape(b, t + 7, hkv, d),
            x[..., (hq + hkv) * d:].reshape(b, t + 7, hkv, d))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", default="",
                    help="NAME=ROOT,...: other trees of the package, each "
                         "built and timed as NAME")
    args = ap.parse_args(argv)
    csrcs = {"this": _build.CSRC}
    for tree in filter(None, args.trees.split(",")):
        name, root = tree.split("=")
        csrcs[name] = Path(root) / "mxq_tpu_torch" / "csrc"
    libs = build_trees(csrcs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi,
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, t, hq, hkv, d in CHECKS:
        q, k, v = qkv(gen, b, t, hq, hkv, d)
        ref = ab.flash_prefill_attention_plain(q, k, v).float()
        kn, vn = k.clone(), v.clone()
        kn[:, t:] = vn[:, t:] = float("nan")
        kz, vz = k.clone(), v.clone()
        kz[:, t:] = vz[:, t:] = 0
        for name, dll in libs.items():
            got = call(dll, q, k, v)
            again = call(dll, q, k, v)
            nan_tail = call(dll, q, kn, vn)
            zero_tail = call(dll, q, kz, vz)
            torch.cuda.synchronize()
            print(json.dumps({
                "tree": name, "B": b, "T": t, "Hq": hq, "Hkv": hkv,
                "D": d, "rel_err": float((got.float() - ref).abs().max()
                                         / ref.abs().max()),
                "deterministic": torch.equal(got, again),
                "nan_tail_equal": torch.equal(nan_tail, zero_tail),
                "finite": bool(torch.isfinite(nan_tail).all())}),
                flush=True)

    timer = Timer()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for t, hq, hkv in TIMED:
        d = 128
        q, k, v = (torch.randn((1, t, h, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for h in (hq, hkv, hkv))
        flops = 4.0 * hq * d * t * (t + 1) / 2
        row = {"T": t, "Hq": hq, "Hkv": hkv, "D": d}
        for name, dll in libs.items():
            ms = timer(lambda: call(dll, q, k, v))
            row[name] = {"ms": ms, "tflops": flops / ms * 1e-9}
        kr, vr = (a.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
                  for a in (k, v))
        ms = timer(lambda: sdpa(q.transpose(1, 2), kr, vr, is_causal=True,
                                scale=1.0 / math.sqrt(d)))
        row["sdpa"] = {"ms": ms, "tflops": flops / ms * 1e-9}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
