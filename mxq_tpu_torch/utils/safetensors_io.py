"""Reader and writer of the safetensors file format, so that the port
needs no ``safetensors`` package.

A file is an 8-byte little-endian header length, a JSON header mapping
each tensor's name to its ``dtype``, ``shape`` and ``data_offsets``
(begin, end) into the data that follows (plus an optional
``__metadata__`` map of strings, which the reader skips and the writer
leaves out), then the raw little-endian bytes of every tensor, back to
back. The writer pads the header with spaces to 8 bytes and lays the
tensors out in the order given, as the ``safetensors`` package does, so
each side reads the other's files.
"""

from __future__ import annotations

import json
import struct
from typing import Iterator

import torch

DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
          "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
          "BOOL": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}


def _read_header(f) -> tuple[dict, int]:
    """(header, offset of the data) of an open file."""
    (n,) = struct.unpack("<Q", f.read(8))
    return json.loads(f.read(n)), 8 + n


def iter_tensors(path: str) -> Iterator[tuple[str, torch.Tensor]]:
    """Yield ``(name, CPU tensor)`` for every tensor of the file, in the
    header's order, each read straight into its own memory."""
    with open(path, "rb") as f:
        header, start = _read_header(f)
        header.pop("__metadata__", None)
        for name, info in header.items():
            if info["dtype"] not in DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has unsupported "
                                 f"dtype {info['dtype']}")
            begin, end = info["data_offsets"]
            raw = torch.empty(end - begin, dtype=torch.uint8)
            f.seek(start + begin)
            if f.readinto(raw.numpy()) != end - begin:
                raise ValueError(f"{path}: tensor {name!r} runs past the "
                                 "end of the file")
            yield name, raw.view(DTYPES[info["dtype"]]).reshape(
                info["shape"])


def save_file(tensors: dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (on any device) to ``path``, moving one tensor at
    a time to the host."""
    header, off = {}, 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + nbytes]}
        off += nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().reshape(-1)
                    .view(torch.uint8).numpy())
