"""The host runtime in C++ (port of ``mxq_tpu/runtime/native.py``): the
packers of the packed format and the continuous-batching scheduler that
``serving.engine.Engine`` drives.

``csrc/mxq_runtime.cc`` is compiled with g++ into
``mxq_tpu_torch/_build/libmxq_runtime.so`` the first time it is needed,
and again whenever the source is newer than the library; several
processes may start at once, so each compiles to a name of its own and
renames the result into place. A failed build raises with the compiler's
output; there is no fallback (``mxq_tpu`` falls back to numpy and to its
Python scheduler, the port does not). The numpy bodies of the packers stay
here as their plain versions (``*_plain``), and ``serving.engine.
_PyScheduler`` is the scheduler's.

    python -m mxq_tpu_torch.runtime.native     # build now, print the path
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from mxq_tpu_torch._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "csrc" / "mxq_runtime.cc"
LIB_PATH = BUILD_DIR / "libmxq_runtime.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def build(out: Path = LIB_PATH, cxx: str = "g++", force: bool = False
          ) -> Path:
    """Compile the runtime into ``out`` unless it is newer than the source
    (or ``force``). Raises with the compiler's output on a failure."""
    out = Path(out)
    if (not force and out.exists()
            and out.stat().st_mtime >= SRC.stat().st_mtime):
        return out
    exe = shutil.which(cxx)
    if exe is None:
        raise RuntimeError(f"{cxx} not found: the C++ runtime "
                           f"({SRC.name}) cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([exe, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed to build {SRC.name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The runtime library with its argtypes set, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def _declare(lib):
    i8p = ctypes.POINTER(ctypes.c_int8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32, i64, vp = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
    sigs = {
        "mxq_pack2b": (None, [i8p, i64, i64, i32p]),
        "mxq_pack4b": (None, [i8p, i64, i64, i32p]),
        "mxq_pack_meta": (None, [i8p, i8p, i64, i64, i32p]),
        "mxq_unpack2b": (None, [i32p, i64, i64, i8p]),
        "mxq_sched_new": (vp, [i32, i32]),
        "mxq_sched_free": (None, [vp]),
        "mxq_sched_submit": (None, [vp, i64, i32, i32, i32]),
        "mxq_sched_admit": (i32, [vp, i32p, i64p, i32p]),
        "mxq_sched_on_token": (i32, [vp, i32, i32]),
        "mxq_sched_active": (i32, [vp, i32p, i32p, i32p]),
        "mxq_sched_completed": (i64, [vp]),
        "mxq_sched_pending": (i32, [vp]),
        "mxq_sched_cancel": (i32, [vp, i64]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _i8(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int8)


# ---- packers: [K, N] codes -> [K / per_word, N] int32 words ----


def pack2b(codes: np.ndarray) -> np.ndarray:
    """[K2, N] 2-bit codes -> [K2/16, N] int32: word r, lane n holds
    codes[16r + j, n] at bits 2j (the packfmt layout)."""
    codes = _i8(codes)
    k2, n = codes.shape
    out = np.empty((k2 // 16, n), np.int32)
    get_lib().mxq_pack2b(_ptr(codes, ctypes.c_int8), k2, n,
                         _ptr(out, ctypes.c_int32))
    return out


def pack4b(codes: np.ndarray) -> np.ndarray:
    """[K4, N] 4-bit codes -> [K4/8, N] int32, codes[8r + j] at bits 4j."""
    codes = _i8(codes)
    k4, n = codes.shape
    out = np.empty((k4 // 8, n), np.int32)
    get_lib().mxq_pack4b(_ptr(codes, ctypes.c_int8), k4, n,
                         _ptr(out, ctypes.c_int32))
    return out


def pack_meta(zeros: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """[G2, N] zero / scale codes of the 2-bit groups (flat along K) ->
    [G2/3, N] int32 meta words: word (t, r) field i holds group
    t*48 + 16*i + r."""
    zeros, scales = _i8(zeros), _i8(scales)
    g2, n = zeros.shape
    out = np.empty((g2 // 3, n), np.int32)
    get_lib().mxq_pack_meta(_ptr(zeros, ctypes.c_int8),
                            _ptr(scales, ctypes.c_int8), g2, n,
                            _ptr(out, ctypes.c_int32))
    return out


def unpack2b(words: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack2b`."""
    words = np.ascontiguousarray(words, np.int32)
    rows, n = words.shape
    out = np.empty((rows * 16, n), np.int8)
    get_lib().mxq_unpack2b(_ptr(words, ctypes.c_int32), rows, n,
                           _ptr(out, ctypes.c_int8))
    return out


def _pack_plain(codes: np.ndarray, bits: int) -> np.ndarray:
    per = 32 // bits
    k, n = codes.shape
    shifts = (np.arange(per, dtype=np.int64) * bits)[None, :, None]
    c = _i8(codes).reshape(k // per, per, n).astype(np.int64)
    return (c << shifts).sum(1).astype(np.uint32).view(np.int32)


def pack2b_plain(codes: np.ndarray) -> np.ndarray:
    return _pack_plain(codes, 2)


def pack4b_plain(codes: np.ndarray) -> np.ndarray:
    return _pack_plain(codes, 4)


def pack_meta_plain(zeros: np.ndarray, scales: np.ndarray) -> np.ndarray:
    zeros, scales = _i8(zeros), _i8(scales)
    g2, n = zeros.shape
    n_kt = g2 // 48
    # group g = t*48 + 16*i + r  ->  axes [t, i, r]
    zv = zeros.reshape(n_kt, 3, 16, n).astype(np.int64) & 3
    sv = scales.reshape(n_kt, 3, 16, n).astype(np.int64) & 255
    out = np.zeros((n_kt, 16, n), np.int64)
    for i in range(3):
        out |= (zv[:, i] << (2 * i)) | (sv[:, i] << (6 + 8 * i))
    return out.reshape(g2 // 3, n).astype(np.int32)


def unpack2b_plain(words: np.ndarray) -> np.ndarray:
    words = np.ascontiguousarray(words, np.int32)
    rows, n = words.shape
    shifts = (np.arange(16, dtype=np.int64) * 2)[None, :, None]
    w = words.view(np.uint32).astype(np.int64)[:, None, :]
    return ((w >> shifts) & 3).reshape(rows * 16, n).astype(np.int8)


class NativeScheduler:
    """The C++ continuous-batching scheduler: a FIFO queue, admission into
    the lowest free slots, retirement on EOS, ``max_new_tokens`` or a full
    cache (a slot's position reaching ``max_len - 1``)."""

    def __init__(self, num_slots: int, max_len: int):
        self._lib = get_lib()
        self._h = self._lib.mxq_sched_new(num_slots, max_len)
        self.num_slots, self.max_len = num_slots, max_len

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mxq_sched_free(self._h)
            self._h = None

    def submit(self, uid: int, prompt_len: int, max_new_tokens: int,
               eos_token: int = -1) -> None:
        self._lib.mxq_sched_submit(self._h, uid, prompt_len, max_new_tokens,
                                   eos_token)

    def admit(self) -> list[tuple[int, int, int]]:
        """Queued requests moved into free slots: (slot, uid, prompt_len)
        each. The caller prefills them and reports each first token
        through :meth:`on_token`."""
        slots = np.empty(self.num_slots, np.int32)
        uids = np.empty(self.num_slots, np.int64)
        plens = np.empty(self.num_slots, np.int32)
        n = self._lib.mxq_sched_admit(self._h, _ptr(slots, ctypes.c_int32),
                                      _ptr(uids, ctypes.c_int64),
                                      _ptr(plens, ctypes.c_int32))
        return [(int(slots[i]), int(uids[i]), int(plens[i]))
                for i in range(n)]

    def on_token(self, slot: int, token: int) -> bool:
        """Record one token of ``slot``; True when its request finished
        (the slot is free again)."""
        return bool(self._lib.mxq_sched_on_token(self._h, slot, token))

    def active(self) -> list[tuple[int, int, int]]:
        """(slot, last token, position) of every occupied slot."""
        slots = np.empty(self.num_slots, np.int32)
        toks = np.empty(self.num_slots, np.int32)
        pos = np.empty(self.num_slots, np.int32)
        n = self._lib.mxq_sched_active(self._h, _ptr(slots, ctypes.c_int32),
                                       _ptr(toks, ctypes.c_int32),
                                       _ptr(pos, ctypes.c_int32))
        return [(int(slots[i]), int(toks[i]), int(pos[i])) for i in range(n)]

    def cancel(self, uid: int) -> int:
        """Cancel by uid: the freed slot, -1 if dequeued, -2 if unknown
        (already finished). A cancelled request is not counted as
        completed."""
        return int(self._lib.mxq_sched_cancel(self._h, uid))

    @property
    def completed(self) -> int:
        return int(self._lib.mxq_sched_completed(self._h))

    @property
    def pending(self) -> int:
        return int(self._lib.mxq_sched_pending(self._h))


def replay(sched, ops) -> list:
    """The decisions ``sched`` (native or plain) makes on a stream of
    operations: ``("submit", uid, prompt_len, max_new, eos)``,
    ``("admit",)``, ``("token", i, token)`` for the i-th occupied slot
    (modulo their count; skipped when none is) and ``("cancel", uid)``.
    Returns one entry per operation: the admissions, the finished flag,
    the cancel result, each with the pending and completed counts."""
    occupied: dict[int, int] = {}              # slot -> uid
    out = []
    for op in ops:
        kind = op[0]
        if kind == "submit":
            sched.submit(*op[1:])
            res = None
        elif kind == "admit":
            res = sched.admit()
            occupied.update((s, u) for s, u, _ in res)
        elif kind == "token":
            if not occupied:
                continue
            slot = sorted(occupied)[op[1] % len(occupied)]
            res = sched.on_token(slot, op[2])
            if res:
                del occupied[slot]
        elif kind == "cancel":
            res = sched.cancel(op[1])
            if res >= 0:
                del occupied[res]
        else:
            raise ValueError(f"unknown operation {op!r}")
        out.append((kind, res, sched.pending, sched.completed))
    return out


def random_ops(rng: np.random.Generator, n: int, max_len: int) -> list:
    """``n`` operations for :func:`replay` drawn from ``rng``: submits
    (uids in order, prompts up to ``max_len``, a third with an EOS token
    among 8), admissions, tokens (ids below 8) and cancels of past or
    future uids."""
    ops, uid = [], 0
    for kind in rng.choice(4, size=n, p=[0.25, 0.15, 0.5, 0.1]):
        if kind == 0:
            eos = int(rng.integers(0, 8)) if rng.random() < 1 / 3 else -1
            ops.append(("submit", uid, int(rng.integers(1, max_len)),
                        int(rng.integers(1, 40)), eos))
            uid += 1
        elif kind == 1:
            ops.append(("admit",))
        elif kind == 2:
            ops.append(("token", int(rng.integers(0, 64)),
                        int(rng.integers(0, 8))))
        else:
            ops.append(("cancel", int(rng.integers(0, uid + 2))))
    return ops


if __name__ == "__main__":
    print(build(force=True))
