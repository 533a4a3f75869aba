"""Training metrics (port of ``mxq_tpu/utils/metrics.py``, which needs no
JAX).

``MetricsWriter(logdir)`` writes both:
  * TensorBoard event files through ``torch.utils.tensorboard`` when it
    imports (``tensorboard --logdir ...`` reads them);
  * ``metrics.jsonl``: one ``{"step": N, "time": t, "<tag>": value, ...}``
    object per call, readable without TensorBoard.

If either backend cannot be set up the other still writes; neither ever
raises into the training loop."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsWriter:
    def __init__(self, logdir: Optional[str]):
        self._tb = None
        self._jsonl = None
        if not logdir:
            return
        try:
            os.makedirs(logdir, exist_ok=True)
        except Exception:  # noqa: BLE001 — unwritable logdir: no backends
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir=logdir)
        except Exception:  # noqa: BLE001 — no torch / no disk: JSONL only
            self._tb = None
        try:
            self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a",
                               buffering=1)
        except Exception:  # noqa: BLE001
            self._jsonl = None

    def log(self, step: int, **scalars: float) -> None:
        if self._tb is not None:
            for tag, v in scalars.items():
                try:
                    self._tb.add_scalar(tag, float(v), global_step=step)
                except Exception:  # noqa: BLE001
                    pass
        if self._jsonl is not None:
            rec = {"step": int(step), "time": time.time()}
            rec.update({k: float(v) for k, v in scalars.items()})
            try:
                self._jsonl.write(json.dumps(rec) + "\n")
            except Exception:  # noqa: BLE001
                pass

    def close(self) -> None:
        if self._tb is not None:
            try:
                self._tb.flush()
                self._tb.close()
            except Exception:  # noqa: BLE001
                pass
        if self._jsonl is not None:
            try:
                self._jsonl.close()
            except Exception:  # noqa: BLE001
                pass
