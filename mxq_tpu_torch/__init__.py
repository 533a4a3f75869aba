"""PyTorch/CUDA port of ``mxq_tpu`` for NVIDIA Hopper (H100).

The JAX package ``mxq_tpu`` stays the reference; this package imports
neither it nor JAX. Entry points take an explicit ``device`` that defaults
to ``"cuda"`` and raise when no CUDA device is present, so nothing runs on
the CPU unless the caller asks for it (the tests do, with ``device="cpu"``).
On CPU tensors every kernel wrapper runs its plain PyTorch version; on CUDA
tensors it launches the hand-written kernel under ``csrc/`` or raises.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. A CUDA device must exist; the CPU
    is used only when the caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"mxq_tpu_torch: device {str(device)!r} requested but no CUDA "
            "device is available; pass device='cpu' to run the plain "
            "PyTorch path on the host")
    return dev
