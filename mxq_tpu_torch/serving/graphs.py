"""Decode chunks captured as CUDA graphs and replayed: the port's
counterpart of ``mxq_tpu``'s jitted chunk (``serving/engine.py:215``,
``paged.py:423``, ``spec.py:67,144``), one compiled program sent in one
dispatch, where the eager chunk is thousands of launches each sent by the
host.

A :class:`ChunkRunner` belongs to one engine. A chunk is a function of
device tensors (the eager chunk, which stays the plain version that is
captured), known by a key that fixes everything that changes its shapes or
its unrolled loop (the horizon; the verify's tokens; a spec chunk's draft
length, rounds and n-gram). Per key the runner holds:

* static inputs: :meth:`stage` copies host arrays into them through pinned
  buffers (one event guards a buffer until its copy has run) and device
  tensors device to device, all in stream order;
* on the card, one graph, captured on the key's first :meth:`run` into the
  engine's one memory pool and replayed from then on. Before the capture
  the chunk runs once for real on a side stream (the warm-up), so that the
  kernel libraries are built and loaded, the cached tile tables read and
  cuBLAS's handles made. The warm-up is harmless: every cache row that a
  chunk reads at or past its slot's position it has written itself
  earlier in the same chunk, so a replay rewrites whatever the warm-up
  wrote before anything reads it; and the generator's state is restored
  after it, so no sampled stream moves. The engine's generator is
  registered with every graph, so each replay draws fresh numbers;
* static outputs, which every replay overwrites. A chunk's outputs are
  valid until the runner's next run of any key: readers copy them first
  (the next chunk's staging, ``engine._HostCopy``). On the CPU the chunk
  runs eagerly on the static inputs and its results are copied into the
  static outputs exactly as a replay overwrites them, so the CPU tests
  (which overwrite every key's outputs between chunks) catch a reader
  that holds them longer.

Launch counts: the warm-up and the capture count nothing; each replay adds
what the captured call launched, per kernel wrapper (``ops.count_launch``),
so a run's totals equal those of the same run done eagerly. A failed
capture raises with the error of the op that broke it; there is no eager
fallback on the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from mxq_tpu_torch.ops import count_launch


def kernel_wrappers() -> list:
    """Every kernel wrapper of the port, once each (a wrapper that serves
    two kernel IDs, K4a/K4c or K4b/K4d, counts its launches once)."""
    from mxq_tpu_torch.ops import attn_bf16, attn_int8, mxq_matmul, uniform4
    return list(dict.fromkeys(f for mod in (mxq_matmul, attn_int8, uniform4,
                                            attn_bf16)
                              for f in mod.KERNELS.values()))


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(_clone(t) for t in tree)


def _copy_into(dst, src) -> None:
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
        return
    for d, s in zip(dst, src):
        _copy_into(d, s)


@dataclasses.dataclass
class _Chunk:
    inputs: dict = dataclasses.field(default_factory=dict)
    pinned: dict = dataclasses.field(default_factory=dict)
    staged: Optional[torch.cuda.Event] = None
    graph: Any = None
    outputs: Any = None
    launches: list = dataclasses.field(default_factory=list)


class ChunkRunner:
    """One engine's decode chunks, each captured once per key and replayed
    on the card, run eagerly into static outputs on the CPU."""

    def __init__(self, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        self.device = torch.device(device)
        self._gen = generator
        self._chunks: dict = {}
        self.captures: dict = {}      # key -> graphs captured
        self.capture_s: dict = {}     # key -> host seconds of its capture
        self.replays: dict = {}       # key -> replays
        if self.device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)

    def stage(self, key, **values) -> dict:
        """Copy ``values`` (host arrays or tensors) into chunk ``key``'s
        static inputs, allocated on the key's first call, and return them:
        a caller may still write into them before :meth:`run`. A value must
        keep the shape and type its input was made with."""
        c = self._chunks.setdefault(key, _Chunk())
        cuda = self.device.type == "cuda"
        if c.staged is not None:
            c.staged.synchronize()     # the last copies out of the pins ran
        for name, v in values.items():
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(np.ascontiguousarray(v))
                if cuda:
                    pin = c.pinned.get(name)
                    if pin is None:
                        pin = c.pinned[name] = torch.empty(
                            v.shape, dtype=v.dtype, pin_memory=True)
                    v = pin.copy_(v)
            dst = c.inputs.get(name)
            if dst is None:
                dst = c.inputs[name] = torch.empty(v.shape, dtype=v.dtype,
                                                   device=self.device)
            elif dst.shape != v.shape or dst.dtype != v.dtype:
                raise ValueError(
                    f"chunk {key!r} input {name}: {v.dtype} "
                    f"{tuple(v.shape)}, made as {dst.dtype} "
                    f"{tuple(dst.shape)}")
            dst.copy_(v, non_blocking=cuda)
        if cuda and c.pinned:
            c.staged = torch.cuda.Event()
            c.staged.record(torch.cuda.current_stream(self.device))
        return c.inputs

    def run(self, key, fn: Callable):
        """``fn(**static inputs)`` of chunk ``key``: on the card its graph
        replayed (captured first if the key is new), on the CPU the eager
        call copied into the static outputs. Returns the static outputs."""
        c = self._chunks[key]
        if self.device.type != "cuda":
            out = fn(**c.inputs)
            if c.outputs is None:
                c.outputs = _clone(out)
            else:
                _copy_into(c.outputs, out)
            return c.outputs
        if c.graph is None:
            self._capture(key, c, fn)
        c.graph.replay()
        for f, n in c.launches:
            count_launch(f, n)
        self.replays[key] = self.replays.get(key, 0) + 1
        return c.outputs

    def eager(self, key, fn: Callable):
        """``fn(**static inputs)`` of chunk ``key`` op by op, its results
        returned as they are (the sharded step, whose collectives are not
        captured; ``chip_smoke.py``'s graph-against-eager runs)."""
        return fn(**self._chunks[key].inputs)

    def _capture(self, key, c: _Chunk, fn: Callable) -> None:
        t0 = time.monotonic()
        wrappers = kernel_wrappers()
        before = [f.launches for f in wrappers]
        state = self._gen.get_state() if self._gen is not None else None
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            fn(**c.inputs)                                  # warm-up
        cur.wait_stream(self._stream)
        warm = [f.launches for f in wrappers]
        graph = torch.cuda.CUDAGraph()
        if self._gen is not None:
            graph.register_generator_state(self._gen)
        with torch.cuda.graph(graph, pool=self.pool, stream=self._stream):
            out = fn(**c.inputs)
        c.launches = [(f, f.launches - w) for f, w in zip(wrappers, warm)
                      if f.launches != w]
        for f, b in zip(wrappers, before):
            count_launch(f, b - f.launches)
        if state is not None:
            self._gen.set_state(state)
        c.graph, c.outputs = graph, out
        self.captures[key] = self.captures.get(key, 0) + 1
        self.capture_s[key] = time.monotonic() - t0
