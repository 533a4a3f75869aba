"""Check and time K13's kernels (``mxq_tpu_torch/csrc/flash_attn.cu``)
and K13-bwd's (``csrc/flash_attn_bwd.cu``), at bfloat16 and float32,
K12's (``csrc/paged_attn_bf16.cu``) and the int8 family's K4 and K11
(``csrc/attn_int8.cu``, ``csrc/paged_attn_int8.cu``), on the card beside
SDPA, and beside the same kernels of other trees of the package.

    python3 flash_probe.py                             # this tree alone
    python3 flash_probe.py --trees parent=out/parent   # and a parent's
    python3 flash_probe.py --kernels k12               # K12 alone
    python3 flash_probe.py --kernels int8              # K4 and K11 alone
    python3 flash_probe.py --kernels k13 --timed 2048:8:1:256,512:8:1:256
                                # K13 checked and timed at these cases only

A case at a head_dim a tree's wrappers refuse (D > 128 before they took
it) prints one line with the tree's ValueError under ``refused``.

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
and 2048, 32 heads of 128, and llama2_70b's G = 8 at 512; 32 heads of
64 at 2048; Gemma-2B's 8 heads of 256 over one kv head at 512 and 2048,
Gemma-7B's 16 heads of 256 over 16 kv heads at 2048; the wide path's 8
heads of 512 over 2 kv heads at 512 and 2048, and of 384 at 2048; 32
heads of 80, 96 and 100 at 2048, the head_dims between the templates:
bf16 rows read by TMA at 80 and 96, by cp.async at 100, a tree before
that on zero-padded copies) the CUDA-event
median with the L2 flushed before each call (``utils.benchlib.Timer``, as
``chip_smoke.py``'s kernels phase times K13 and K13-bwd) of the forward
and of the backward, the TFLOP/s of each over the causal half (4 and 10
Hq D T(T+1)/2 operations), the device ms of each kernel of one call by
name (torch.profiler) with the backward's dQ and dK/dV kernels summed
(``bwd_dq_ms``, ``bwd_dkv_ms``; at float32 the split pass's share), and
SDPA's times on
the same inputs (``is_causal``, k and v repeated to Hq heads; its
backward one ``torch.autograd.grad`` from a kept graph).

K12 (``paged_decode_attention``) at K12_CASES, pages of 64 rows, 32 a
sequence, shuffled tables: its max error over max|ctx| against the plain
version (gates: bf16 q 1e-2, float32 q 1e-5), the kernel reading a pool
with NaN in the null page and past each length in its last live page,
the plain version the same pool with finite rows there; whether two
calls give the same bits and the output is finite; the wrapper's
CUDA-event median (``Timer``), the device ms of one call by kernel name
(torch.profiler) and the kernel's own; the bound (K and V rows below the
lengths read once, q read and the output written once, over 3.35 TB/s);
SDPA over the gathered pages with the length mask (bf16 q, k and v
repeated to Hq heads).

K4 (``int8_decode_attention_fused_write``) and K11
(``int8_paged_decode_attend_update``) at INT8_CASES, 8 sequences at the
positions of chip_smoke.py's K4 row: the max error over max|ctx| against
the plain version (gate 1e-3), the written rows equal to the plain
version's, the CUDA-event median and the bound (the history's codes and
scales read once). Needs a CUDA device."""

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
# (at D = 256 the items are 64 rows and the tiles fewer keys)
CHECKS = [(2, 1, 4, 2, 64), (2, 127, 8, 8, 128), (2, 129, 16, 2, 128),
          (1, 257, 4, 2, 64), (1, 2048, 32, 32, 128), (1, 512, 64, 8, 128),
          (1, 257, 8, 1, 256), (2, 129, 4, 2, 192), (1, 2048, 8, 1, 256),
          (2, 129, 4, 4, 100), (1, 257, 2, 2, 98), (1, 2048, 32, 32, 96)]
# (T, Hq, Hkv, D) timed at B = 1
TIMED = [(2048, 32, 32, 128), (512, 32, 32, 128), (512, 64, 8, 128),
         (2048, 32, 32, 64), (2048, 8, 1, 256), (512, 8, 1, 256),
         (2048, 16, 16, 256),
         (2048, 8, 2, 512), (512, 8, 2, 512), (2048, 8, 2, 384),
         (2048, 32, 32, 80), (2048, 32, 32, 96), (2048, 32, 32, 100)]
DTYPES = {"bfloat16": 2e-2, "float32": 1e-4}   # and each one's gate
SOURCES = {"k13": ("flash_attn", "flash_attn_bwd"),
           "k12": ("paged_attn_bf16",),
           "int8": ("attn_int8", "paged_attn_int8")}
HERE = Path(__file__).resolve().parent
# K12's mixed lengths (chip_smoke's K12 rows: rows 1 .. 2047, 3,651 in
# all) and cli serve --paged --kv_bits 32's decode (100-token prompts, 32
# new tokens: lengths 101 .. 132)
K12_LENGTHS = [1, 2, 18, 128, 129, 301, 1025, 2047]
K12_SERVE = [101, 105, 110, 114, 119, 123, 128, 132]
# (name, Hq, Hkv, D, q's type, lengths) at B = 8: llama2_7b's heads at
# bf16 and float32 q, head_dim 96, the serve decode (float32, the serving
# path's default type), llama2_70b's G = 8, and one layer of the paged
# bf16 decode step that chip_smoke profiles (8 slots at row 1000)
K12_CASES = [("K12", 32, 32, 128, "bfloat16", K12_LENGTHS),
             ("K12-f32", 32, 32, 128, "float32", K12_LENGTHS),
             ("K12-d96", 32, 32, 96, "bfloat16", K12_LENGTHS),
             ("K12-serve", 32, 32, 128, "float32", K12_SERVE),
             ("K12-g8", 64, 8, 128, "float32", K12_LENGTHS),
             ("K12-step", 32, 32, 128, "float32", [1001] * 8),
             ("K12-d256", 8, 1, 256, "bfloat16", K12_LENGTHS)]
# and probed here alone: 32 heads of 64, Gemma-2B's heads with float32 q
K12_PROBE_EXTRA = [("K12-d64", 32, 32, 64, "bfloat16", K12_LENGTHS),
                   ("K12-d256-f32", 8, 1, 256, "float32", K12_LENGTHS)]
# (name, Hq, Hkv, D) of K4 and K11 at B = 8, S = 2048: llama2_7b's heads,
# 64 heads of 64, open_llama_3b's 32 heads of 100 (in place at 128) and
# Gemma-2B's 8 heads of 256 over one kv head
INT8_CASES = [("d128", 32, 32, 128), ("d64", 64, 64, 64),
              ("d100", 32, 32, 100), ("d256", 8, 1, 256)]
INT8_POSITIONS = [0, 1, 17, 300, 1024, 1500, 2000, 2046]
K12_GATES = {"bfloat16": 1e-2, "float32": 1e-5}
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (data sheet)


def k12_inputs(gen, hq, hkv, d, dtype, lengths, ps=64, pps=32):
    """K12's inputs at B = len(lengths): q [B, Hq, D] of ``dtype``; k, v
    pages [Hkv, 1 + B * pps, ps, D] bf16 with NaN in the null page 0 and
    past each length in its last live page (what the kernel reads), the
    same pages with those rows finite (what the plain version, which
    gathers every page, reads); lengths; shuffled tables with the null
    page past each length; and for SDPA k, v gathered to [B, Hq, pps * ps,
    D] and the length mask."""
    b = len(lengths)
    lp = 1 + b * pps
    cat = dict(generator=gen, device="cuda")
    kz, vz = (torch.randn((hkv, lp, ps, d), **cat).to(torch.bfloat16)
              for _ in range(2))
    tables = (torch.randperm(lp - 1, **cat)[:b * pps] + 1).reshape(
        b, pps).to(torch.int32)
    kn, vn = kz.clone(), vz.clone()
    kn[:, 0] = vn[:, 0] = float("nan")
    for i, n in enumerate(lengths):
        tables[i, -(-n // ps):] = 0
        if n % ps and n < pps * ps:
            last = int(tables[i, n // ps])
            kn[:, last, n % ps:] = vn[:, last, n % ps:] = float("nan")
    q = torch.randn((b, hq, d), **cat).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    idx = tables.long()
    kd, vd = (x[:, idx].permute(1, 0, 2, 3, 4).reshape(b, hkv, pps * ps, d)
              .repeat_interleave(hq // hkv, dim=1) for x in (kz, vz))
    amask = (torch.arange(pps * ps, device="cuda")[None, None, None, :]
             < lens[:, None, None, None])
    return q, (kn, vn), (kz, vz), lens, tables, (kd, vd, amask)


def k12_bound_ms(q, hkv, lengths, pps) -> float:
    """The least time of K12's work on the card: each K and V row below
    the lengths read once, q, lengths and tables read and the output
    written once, over the HBM rate (operations: 4 Hq D a row, far below
    the tensor rate)."""
    b, _, d = q.shape
    nbytes = (sum(lengths) * hkv * d * 2 * 2 + 2 * q.numel()
              * q.element_size() + b * 4 + b * pps * 4)
    return nbytes / HBM_BYTES_PER_S * 1e3


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


def probe_k12(name: str, ab, timer) -> None:
    """K12 of one tree at K12_CASES: one JSON line a case."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(0)
    for key, hq, hkv, d, dname, lengths in K12_CASES + K12_PROBE_EXTRA:
        q, nan, zero, lens, tables, (kd, vd, amask) = k12_inputs(
            gen, hq, hkv, d, getattr(torch, dname), lengths)
        out = {}
        if refused(name, {"kernel": key, "Hq": hq, "Hkv": hkv, "D": d,
                          "q_dtype": dname},
                   lambda: out.update(got=ab.paged_decode_attention(
                       q, *nan, lens, tables))):
            continue
        got = out["got"]
        again = ab.paged_decode_attention(q, *nan, lens, tables)
        ref = ab.paged_decode_attention_plain(q, *zero, lens, tables).float()
        torch.cuda.synchronize()
        call = (lambda: ab.paged_decode_attention(q, *nan, lens, tables))
        per_name = by_name(call)
        qs = q[:, :, None, :].to(torch.bfloat16)
        row = {"tree": name, "kernel": key, "B": len(lengths), "Hq": hq,
               "Hkv": hkv, "D": d, "q_dtype": dname, "lengths": lengths,
               "gate": K12_GATES[dname],
               "rel_err": float((got.float() - ref).abs().max()
                                / ref.abs().max()),
               "deterministic": torch.equal(got, again),
               "finite": bool(torch.isfinite(got).all()),
               "ms": timer(call),
               "kernel_device_ms": sum(v for k, v in per_name.items()
                                       if "paged_bf16_kernel" in k),
               "device_ms_by_name": per_name,
               "bound_ms": k12_bound_ms(q, hkv, lengths, tables.shape[1]),
               "sdpa_ms": timer(lambda: sdpa(qs, kd, vd, attn_mask=amask))}
        if hasattr(ab, "paged_decode_blocks"):
            w = ab.kernel_head_dim(d)
            per = (ab.heads_per_launch(w) if hasattr(ab, "heads_per_launch")
                   else ab.GMAX)
            row["blocks_per_sm"] = ab.paged_decode_blocks(
                w, min(hq // hkv, per))
        print(json.dumps(row), flush=True)
        del q, nan, zero, kd, vd


def refused(name: str, case: dict, fn) -> bool:
    """Run ``fn``; where the tree's wrappers refuse the case's head_dim
    (a ValueError), print that and return True."""
    try:
        fn()
    except ValueError as e:
        print(json.dumps({"tree": name, **case, "refused": str(e)}),
              flush=True)
        return True
    return False


def int8_inputs(gen, a8, hq, hkv, d, s=2048):
    """K4's and K11's inputs at B = len(INT8_POSITIONS): q [B, Hq, D]
    bf16; one layer of codes [1, B, Hkv, S, D] int8 and scales [1, B,
    Hkv, S] bf16; the current token's rows for K4 ([B, Hkv, 1, D], [B,
    Hkv, 1]) and for K11 ([B, Hkv, D], [B, Hkv]); the same history as a
    pool of 128-row pages under shuffled tables (a sequence's S rows on
    its S / 128 pages, the null page 0 unused); the positions."""
    cat = dict(generator=gen, device="cuda")
    b, ps = len(INT8_POSITIONS), a8.PAGE_INT8
    codes = lambda *sh: torch.randint(  # noqa: E731
        -127, 128, sh, dtype=torch.int8, **cat)
    scales = lambda *sh: (torch.rand(sh, **cat) * 0.02  # noqa: E731
                          + 1e-3).to(torch.bfloat16)
    kc, vc = codes(1, b, hkv, s, d), codes(1, b, hkv, s, d)
    ks, vs = scales(1, b, hkv, s), scales(1, b, hkv, s)
    cur = [codes(b, hkv, 1, d), scales(b, hkv, 1), codes(b, hkv, 1, d),
           scales(b, hkv, 1)]
    pps = s // ps
    lp = 1 + b * pps
    tables = (torch.randperm(lp - 1, **cat)[:b * pps] + 1).reshape(
        b, pps).to(torch.int32)
    idx = tables.long()

    def paged(x):                        # [1, B, Hkv, S, ...] -> pages
        out = x.new_zeros((hkv, lp, ps) + tuple(x.shape[4:]))
        out[:, idx] = x[0].transpose(0, 1).reshape(
            (hkv, b, pps, ps) + tuple(x.shape[4:]))
        return out
    pool = [paged(kc), paged(ks)[:, :, None], paged(vc),
            paged(vs)[:, :, None]]
    return dict(q=torch.randn((b, hq, d), **cat).to(torch.bfloat16),
                kc=kc, ks=ks, vc=vc, vs=vs, cur=cur,
                pcur=[x[:, :, 0].contiguous() for x in cur],
                pool=[x.contiguous() for x in pool], tables=tables,
                pos=torch.tensor(INT8_POSITIONS, dtype=torch.int32,
                                 device="cuda"))


def int8_bytes(hq, hkv, d, rows) -> int:
    """The bytes K4's or K11's work at B = len(INT8_POSITIONS) must move:
    the codes and scales of ``rows`` history rows a kv head read once, q
    read, the current token's rows read and written, the f32 output
    written (operations, 4 Hq D a row, sit far below the tensor rate)."""
    b = len(INT8_POSITIONS)
    return (rows * hkv * (2 * d + 4) + b * hq * d * (2 + 4)
            + 4 * b * hkv * (d + 2))


def probe_int8(name: str, a8, timer) -> None:
    """K4 and K11 of one tree at INT8_CASES: one JSON line each."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for key, hq, hkv, d in INT8_CASES:
        x = int8_inputs(gen, a8, hq, hkv, d)
        q, cur, pos, tables = x["q"], x["cur"], x["pos"], x["tables"]
        case = {"kernel": "K4", "case": key, "B": len(INT8_POSITIONS),
                "Hq": hq, "Hkv": hkv, "D": d,
                "bound_ms": int8_bytes(hq, hkv, d, int(pos.sum()))
                / HBM_BYTES_PER_S * 1e3}
        mine = [x["kc"].clone(), x["vc"].clone()]
        out = {}
        if refused(name, case, lambda: out.update(ctx=(
                a8.int8_decode_attention_fused_write(
                    q, mine[0], x["ks"], mine[1], x["vs"], *cur, 0,
                    pos)[0]))):
            continue
        theirs = [x["kc"].clone(), x["vc"].clone()]
        ref = a8.int8_decode_attention_fused_write_plain(
            q, theirs[0], x["ks"], theirs[1], x["vs"], *cur, 0, pos)[0]
        torch.cuda.synchronize()
        print(json.dumps({
            "tree": name, **case, "gate": 1e-3,
            "rel_err": float((out["ctx"] - ref).abs().max()
                             / ref.abs().max()),
            "written_equal": all(torch.equal(a, b)
                                 for a, b in zip(mine, theirs)),
            "ms": timer(lambda: a8.int8_decode_attention_fused_write(
                q, mine[0], x["ks"], mine[1], x["vs"], *cur, 0, pos))}),
            flush=True)
        pool = [t.clone() for t in x["pool"]]
        theirs = [t.clone() for t in x["pool"]]
        ctx = a8.int8_paged_decode_attend_update(q, *pool, *x["pcur"], pos,
                                                 tables)[0]
        ref = a8.int8_paged_decode_attend_update_plain(
            q, *theirs, *x["pcur"], pos, tables)[0]
        torch.cuda.synchronize()
        print(json.dumps({
            "tree": name, **case, "kernel": "K11", "gate": 1e-3,
            "rel_err": float((ctx - ref).abs().max() / ref.abs().max()),
            "written_equal": all(torch.equal(a.view(torch.uint8),
                                             b.view(torch.uint8))
                                 for a, b in zip(pool, theirs)),
            "ms": timer(lambda: a8.int8_paged_decode_attend_update(
                q, *pool, *x["pcur"], pos, tables))}), flush=True)
        del x, mine, theirs, pool


def probe_tree(name: str, root: str, kernels=("k13", "k12"),
               timed=None) -> int:
    """Build, check and time one tree's kernels through its own package
    (K13's and K13-bwd's: CHECKS and TIMED, or only the cases ``timed``,
    each checked at B = 1 before it is timed)."""
    checks = CHECKS if timed is None else [(1, *c) for c in timed]
    timed = TIMED if timed is None else timed
    sys.path.insert(0, str(Path(root).resolve()))
    from mxq_tpu_torch import _build
    from mxq_tpu_torch.ops import attn_bf16 as ab
    from mxq_tpu_torch.ops import attn_int8 as a8
    from mxq_tpu_torch.utils.benchlib import Timer
    if not Path(ab.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"tree {name}: imported {ab.__file__}")
    logs = {}
    _build.build([s for k in kernels for s in SOURCES[k]], verbose=True,
                 logs=logs)
    for src, log in logs.items():
        print(json.dumps({"tree": name, "source": src,
                          **_build.ptxas_report(log, "kernel")}), flush=True)
    if "int8" in kernels:
        probe_int8(name, a8, Timer())
    if "k12" in kernels:
        probe_k12(name, ab, Timer())
    if "k13" not in kernels:
        return 0

    gen = torch.Generator(device="cuda").manual_seed(0)
    for (b, t, hq, hkv, d), (dname, gate) in itertools.product(
            checks, DTYPES.items()):
        dtype = getattr(torch, dname)
        q, k, v = qkv(gen, b, t, hq, hkv, d, dtype)
        ref = ab.flash_prefill_attention_plain(q, k, v).float()
        kn, vn = k.clone(), v.clone()
        kn[:, t:] = vn[:, t:] = float("nan")
        kz, vz = k.clone(), v.clone()
        kz[:, t:] = vz[:, t:] = 0
        do = torch.randn((b, t, hq, d), generator=gen, device="cuda").to(
            dtype)
        out = {}
        if refused(name, {"B": b, "T": t, "Hq": hq, "Hkv": hkv, "D": d,
                          "dtype": dname},
                   lambda: out.update(got=ab.flash_prefill_attention(
                       q, k, v))):
            continue
        got = out["got"]
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
    for dname, (t, hq, hkv, d) in itertools.product(DTYPES, timed):
        q, k, v, do = (torch.randn((1, t, h, d), generator=gen,
                                   device="cuda").to(getattr(torch, dname))
                       for h in (hq, hkv, hkv, hq))
        out = {}
        if refused(name, {"dtype": dname, "T": t, "Hq": hq, "Hkv": hkv,
                          "D": d},
                   lambda: out.update(fwd=ab.flash_attention_forward(
                       q, k, v))):
            continue
        o, lse = out["fwd"]
        flops = 4.0 * hq * d * t * (t + 1) / 2
        row = {"tree": name, "dtype": dname, "T": t, "Hq": hq, "Hkv": hkv,
               "D": d}
        ms = timer(lambda: ab.flash_prefill_attention(q, k, v))
        bms = timer(lambda: ab.flash_attention_backward(q, k, v, o, lse, do))
        row["kernels"] = {"ms": ms, "tflops": flops / ms * 1e-9,
                          "bwd_ms": bms, "bwd_tflops": 2.5 * flops / bms
                          * 1e-9}
        names = {"forward": by_name(lambda: ab.flash_prefill_attention(
                     q, k, v)),
                 "backward": by_name(lambda: ab.flash_attention_backward(
                     q, k, v, o, lse, do))}
        row["kernels"]["device_ms_by_name"] = names
        for key, part in (("bwd_dq_ms", "dq_"), ("bwd_dkv_ms", "dkv_")):
            row["kernels"][key] = sum(ms for n, ms in names["backward"].items()
                                      if part in n)
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
    ap.add_argument("--kernels", default="k13,k12,int8",
                    help="comma-separated subset of k13 (K13 and K13-bwd), "
                         "k12 and int8 (K4 and K11)")
    ap.add_argument("--timed", default="",
                    help="T:Hq:Hkv:D,...: K13's cases, checked and timed "
                         "(default CHECKS and TIMED)")
    ap.add_argument("--tree", help=argparse.SUPPRESS)   # NAME=ROOT: one tree
    args = ap.parse_args(argv)
    kernels = [k for k in args.kernels.split(",") if k]
    timed = [tuple(int(x) for x in c.split(":"))
             for c in args.timed.split(",") if c] or None
    if args.tree:
        return probe_tree(*args.tree.split("=", 1), kernels=kernels,
                          timed=timed)
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
                        "--tree", f"{name}={root}", "--kernels",
                        args.kernels, "--timed", args.timed], check=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
