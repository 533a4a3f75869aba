"""Tracing and roofline accounting (port of ``mxq_tpu/utils/profiling.py``).

* ``trace(dir)``: a ``torch.profiler`` capture of the host and the card,
  written as a Chrome trace into ``dir`` (open it in Perfetto).
* ``annotate(name)``: a named span (``torch.profiler.record_function``)
  that shows in such a trace; the QAT loop wraps each step in one.
* ``Roofline``: an op's achieved bandwidth and FLOP/s against the card's
  peaks, with the arithmetic of ``mxq_tpu``'s.
* ``MetricsLogger``: append-only JSONL metrics with wall-clock stamps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Optional

import torch

# Published peaks (NVIDIA's data sheet, SXM part, dense, at the 700 W
# limit): bf16 tensor-core TFLOP/s and HBM GB/s.
CHIP_PEAKS = {
    "h100": dict(bf16_tflops=989.0, hbm_gbps=3350.0),
}


@contextlib.contextmanager
def trace(log_dir: str = "out/trace"):
    """Capture a trace: ``with profiling.trace('out/t'): run()``."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


@dataclasses.dataclass
class Roofline:
    """Roofline accounting for one op."""

    name: str
    bytes_accessed: int
    flops: int
    chip: str = "h100"

    def report(self, seconds: float) -> dict:
        peaks = CHIP_PEAKS[self.chip]
        bw = self.bytes_accessed / seconds / 1e9
        tf = self.flops / seconds / 1e12
        t_bw = self.bytes_accessed / (peaks["hbm_gbps"] * 1e9)
        t_fl = self.flops / (peaks["bf16_tflops"] * 1e12)
        bound = "bandwidth" if t_bw > t_fl else "compute"
        t_roof = max(t_bw, t_fl)
        return {
            "op": self.name,
            "seconds": seconds,
            "achieved_gbps": round(bw, 1),
            "achieved_tflops": round(tf, 2),
            "bound": bound,
            "pct_of_roofline": round(100.0 * t_roof / seconds, 1),
            "roofline_seconds": t_roof,
        }


class MetricsLogger:
    """Append-only jsonl metrics with wall-clock stamps."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, **kv) -> None:
        kv.setdefault("ts", time.time())
        line = json.dumps(kv)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        if self.echo:
            print(line)

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
