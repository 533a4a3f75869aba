"""Time the one-row GEMVs of ``csrc/mxq_gemv.cu`` (K2's
``gemv_row_kernel``, K6-bfexp's ``bfexp_row_kernel``) and variants of them
at llama2_7b's four packed linears on the card.

    python -m mxq_tpu_torch.gemv_row_probe             # K2 as built
    python -m mxq_tpu_torch.gemv_row_probe --variants base,warps4
    python -m mxq_tpu_torch.gemv_row_probe --kernel bfexp  # bfexp_row_kernel

A variant is ``csrc/mxq_gemv.cu`` with some of its ``constexpr`` lines
replaced (:data:`VARIANTS`), built with nvcc into ``_build/probe/`` and
called through the kernel's C entry, with the K split that its geometry
gives (``mxq_gemv_tiles``, ``ops.mxq_matmul._split_rows``). Each (variant,
linear) prints one JSON line: the CUDA-event median of device time with
the L2 flushed before each call (256 MB written, then read, so that no
dirty line is left to write back: as ``chip_smoke.py``'s kernels phase
times it, ``cold_ms``) and without a flush (``warm_ms``: the weight is
read from L2 where it fits), the rel error against the kernel's plain
version and whether the output equals the built kernel's. ``floor`` lines
time one small copy kernel under the same two clocks: what the timing
method itself costs. Needs a CUDA device."""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import statistics
import subprocess

import torch

from mxq_tpu_torch import _build, packfmt
from mxq_tpu_torch.ops import mxq_matmul as mm

# llama2_7b packed linears of one layer: name -> (out, in)
SHAPES_7B = {"qkv": (3 * 4096, 4096), "o": (4096, 4096),
             "gate_up": (2 * 11008, 4096), "down": (4096, 11008)}
# per kernel: its C entry, its row of mxq_gemv_tiles, its kernel's name in
# ptxas' report, the built wrapper and the plain version
KERNELS = {
    "k2": ("mxq_gemv_k2", 0, "gemv_row_kernelILi0E", "gemv_single",
           "gemv_plain"),
    "bfexp": ("mxq_gemv_k6_bfexp1", 1, "bfexp_row_kernel", "gemv_bfexp",
              "gemv_bfexp_plain"),
}
# per kernel, variant -> {constexpr name: value} replaced in
# csrc/mxq_gemv.cu; measured ones are in PERF.md
VARIANTS = {
    "k2": {
        "base": {},
        "warps4": {"ROW_WARPS": "4", "ROW_MIN_BLOCKS": "4"},
        "warps16": {"ROW_WARPS": "16", "ROW_MIN_BLOCKS": "1"},
    },
    "bfexp": {
        "base": {},
        "stages3": {"BF_STAGES": "3"},
        "warps2": {"BF_WARPS": "2", "BF_MIN_BLOCKS": "16"},
        "warps8": {"BF_WARPS": "8", "BF_MIN_BLOCKS": "4"},
    },
}


def variant_source(changes: dict) -> str:
    src = (_build.CSRC / "mxq_gemv.cu").read_text()
    for name, value in changes.items():
        src, n = re.subn(rf"(constexpr int {name} = )[^;]+;",
                         rf"\g<1>{value};", src)
        if n != 1:
            raise ValueError(f"{name}: {n} definitions in mxq_gemv.cu")
    return src


def build_variants(kernel: str, names) -> dict:
    """{variant: loaded library}, built in parallel."""
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    kname = KERNELS[kernel][2]
    procs = {}
    for v in names:
        src = out_dir / f"mxq_gemv_{kernel}_{v}.cu"
        src.write_text(variant_source(VARIANTS[kernel][v]))
        lib = out_dir / f"libmxq_gemv_{kernel}_{v}.so"
        cmd = [_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-I", str(_build.CSRC), "-Xptxas", "-v", "-o", str(lib),
               str(src)]
        procs[v] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    libs = {}
    for v, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {v}:\n{log}")
        report = re.findall(rf"Compiling entry function '\w*{kname}\w*'.*?"
                            r"(Used \d+ registers[^\n]*)", log, re.S)
        spills = re.findall(rf"Compiling entry function '\w*{kname}\w*'.*?"
                            r"(\d+ bytes spill stores)", log, re.S)
        print(json.dumps({"variant": v, "ptxas": report, "spills": spills}),
              flush=True)
        dll = ctypes.CDLL(str(lib))
        for fn, argtypes in _build.SIGNATURES["mxq_gemv"].items():
            getattr(dll, fn).argtypes = argtypes
            getattr(dll, fn).restype = ctypes.c_int
        libs[v] = dll
    return libs


def tiles_of(dll) -> tuple:
    buf = (ctypes.c_int * 6)()
    n = dll.mxq_gemv_tiles(buf, 2)
    return tuple(tuple(buf[3 * i: 3 * i + 3]) for i in range(n))


def call(dll, fn, x, p, rows):
    """Entry ``fn`` of ``dll`` with ``rows`` meta rows per split."""
    nbp, n = p.meta2.shape
    ksplit = -(-nbp // rows)
    part = torch.empty((ksplit, 1, n), dtype=torch.float32, device="cuda")
    y = torch.empty((1, p.out_features), dtype=torch.float32, device="cuda")
    err = getattr(dll, fn)(
        x.data_ptr(), 1, x.shape[1], x.shape[1], p.w2.data_ptr(),
        p.w4.data_ptr(), p.meta2.data_ptr(), p.qscale.data_ptr(),
        p.qmin.data_ptr(), p.smeta4.data_ptr(), nbp, n, p.out_features,
        rows, ksplit, part.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, fn)
    return y


def time_ms(fn, flush, iters=20) -> float:
    """Median CUDA-event ms of ``fn``; before each call the L2 is flushed
    (when ``flush`` is given: written, then read, leaving no dirty line)
    and the card spins ~1 ms so that the events bracket device time
    only."""
    for _ in range(3):
        fn()
    ts = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
            flush.view(torch.float32).sum()
        torch.cuda._sleep(2_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    return statistics.median(ts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="k2", choices=sorted(KERNELS))
    ap.add_argument("--variants", default="base")
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    libs = build_variants(args.kernel, names)
    fn, tiles_row = KERNELS[args.kernel][:2]
    built = getattr(mm, KERNELS[args.kernel][3])
    plain = getattr(mm, KERNELS[args.kernel][4])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    small = torch.empty(4096, dtype=torch.float32, device="cuda")
    for clock, fl in (("cold_ms", flush), ("warm_ms", None)):
        print(json.dumps({"floor": "4 KB copy", clock: time_ms(
            lambda: small.copy_(small), fl)}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sums = {v: {"cold_ms": 0.0, "warm_ms": 0.0} for v in names}
    for name, (o, k) in SHAPES_7B.items():
        w = torch.randn((o, k), generator=gen, device="cuda") / math.sqrt(k)
        p = packfmt.quantize_pack(w)
        del w
        x = torch.randn((1, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        ref = plain(x, p)
        base = built(x, p)
        nbp, n = p.meta2.shape
        for v, dll in libs.items():
            tile = tiles_of(dll)[tiles_row]
            rows = mm._split_rows(nbp, n, sms, tile)
            y = call(dll, fn, x, p, rows)
            torch.cuda.synchronize()
            row = {"kernel": args.kernel, "variant": v, "linear": name,
                   "tile": tile, "rows_per_split": rows,
                   "rel_err": float((y - ref).abs().max()
                                    / ref.abs().max()),
                   "equal_to_built": torch.equal(y, base)}
            for clock, fl in (("cold_ms", flush), ("warm_ms", None)):
                row[clock] = time_ms(lambda: call(dll, fn, x, p, rows), fl)
                sums[v][clock] += row[clock]
            print(json.dumps(row), flush=True)
        del p
    for v in names:
        print(json.dumps({"kernel": args.kernel, "variant": v,
                          "layer": sums[v]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
