"""Build the CUDA kernels under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes
``_build/lib<name>.so``, compiled for ``sm_90a`` the first time a kernel of
it is launched, and again whenever the source or a header under ``csrc/``
is newer than the library.
Nothing is imported from PyTorch's headers, so a build takes seconds.
A failed build raises; there is no fallback.

    python -m mxq_tpu_torch._build      # build every kernel now, with
                                        # the register/shared-memory report
"""

from __future__ import annotations

import ctypes
import functools
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("mxq_gemv", "mxq_gemv_tc", "mxq_dequant", "attn_int8",
           "paged_attn_int8", "uniform_gemv", "paged_attn_bf16", "flash_attn",
           "flash_attn_bwd", "attn_int8_wide", "paged_attn_bf16_wide",
           "flash_attn_wide")
_EXTRA_FLAGS = {
    # K3 and K5 must equal their plain PyTorch versions bit for bit: no
    # FMA fusion.
    "mxq_dequant": ["--fmad=false"],
}
_CUTLASS = Path("/usr/local/cutlass/include")

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float
# argtypes of every exported function (pointers and the stream as c_void_p)
SIGNATURES = {
    "mxq_gemv": {
        name: [P, I, I, I, P, P, P, P, P, P, I, I, I, I, I, P, P, P]
        for name in ("mxq_gemv_k2", "mxq_gemv_k6_quad1",
                     "mxq_gemv_k6_bfexp1")} | {"mxq_gemv_tiles": [P, I]},
    "mxq_gemv_tc": {
        "mxq_gemv_tc": [I, I, P, I, I, I, I, P, P, P, P, P, P, I, I, I, I, I,
                        P, P, P, P],
        "mxq_gemv_tc_tiles": [P, I]},
    "mxq_dequant": {"mxq_dequant_k3": [P, P, P, P, P, P, I, I, P, P, P],
                    "mxq_dequant_k5": [P, P, P, P, P, P, I, I, P, P, P]},
    "attn_int8": {
        "attn_int8": [P] * 10 + [I] * 13 + [F] + [P] * 4},
    "paged_attn_int8": {
        "paged_attn_int8": [P] * 11 + [I] * 11 + [F] + [P] * 4},
    "uniform_gemv": {
        "uniform_gemv": [I, I, P, I, I, P, P, P, I, I, I, I, I, P, P, P],
        "uniform_gemv_tiles": [P, I]},
    "paged_attn_bf16": {
        "paged_attn_bf16": [P, I] + [P] * 4 + [I] * 10 + [F] + [P] * 4,
        "paged_attn_bf16_blocks": [I, I, P]},
    "flash_attn": {
        "flash_attn": [P] * 5 + [L] * 6 + [I] * 8 + [F, P, P],
        "flash_split": [P, L, L, P] + [I] * 5 + [P]},
    "flash_attn_bwd": {
        "flash_attn_bwd": [P] * 12 + [L] * 11 + [I] * 8 + [F, P],
        "flash_attn_bwd_scratch": [I] * 6 + [P]},
    # the wide paths (head_dim > 256) of the int8 family, K12, K13 and
    # K13-bwd
    "attn_int8_wide": {
        "attn_int8_wide": [P] * 10 + [I] * 13 + [F] + [P] * 4,
        "paged_attn_int8_wide": [P] * 11 + [I] * 11 + [F] + [P] * 4},
    "paged_attn_bf16_wide": {
        "paged_attn_bf16_wide": [P, I] + [P] * 4 + [I] * 10 + [F] + [P] * 4},
    "flash_attn_wide": {
        "flash_attn_wide": [P] * 5 + [L] * 6 + [I] * 7 + [F, P, P],
        "flash_attn_bwd_wide": [P] * 11 + [L] * 11 + [I] * 7 + [F, P]},
}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(PATH and /usr/local/cuda/bin were searched)")


def _command(name: str, out: Path, verbose: bool) -> list[str]:
    cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
           *_EXTRA_FLAGS.get(name, [])]
    if _CUTLASS.is_dir():
        cmd += ["-I", str(_CUTLASS)]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    return cmd + ["-o", str(out), str(CSRC / f"{name}.cu")]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def ptxas_report(log: str, kernel: str) -> dict:
    """ptxas' registers and spills for each instantiation of ``kernel`` in
    an ``-Xptxas -v`` build log (none without ``-v``), and the log's
    warnings (a serialized wgmma shows there)."""
    found = {}
    for block in log.split("ptxas info    : Compiling entry function ")[1:]:
        name = block.split("'")[1]
        if kernel not in name:
            continue
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        found[name] = {"registers": int(regs.group(1)) if regs else None,
                       "spill_stores": int(spill.group(1)) if spill else None,
                       "spill_loads": int(spill.group(2)) if spill else None}
    return {"kernels": found,
            "warnings": [ln for ln in log.splitlines() if "arning" in ln]}


def _stale(name: str) -> bool:
    """The library is missing or older than its source or any header."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    srcs = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in srcs)


def build(names=SOURCES, verbose: bool = False, force: bool = False,
          logs: dict | None = None) -> dict:
    """Compile the named sources in parallel (one nvcc each). Returns
    {name: seconds} for the ones built, and puts nvcc's output of each
    (with ``verbose``, ptxas' report of every kernel) into ``logs`` where
    given; raises with nvcc's output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if force or _stale(n)]
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        procs[name] = (tmp, time.monotonic(), subprocess.Popen(
            _command(name, tmp, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    took, failed = {}, []
    for name, (tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.monotonic() - t0
        if logs is not None:
            logs[name] = log
        if verbose and log:
            print(log, file=sys.stderr)
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return took


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library ``lib<name>.so`` with its argtypes set, building
    it first if needed."""
    build((name,))
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


if __name__ == "__main__":
    for n, s in build(verbose=True, force=True).items():
        print(f"built {n} in {s:.1f} s")
