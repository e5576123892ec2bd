"""Minimal reader/writer of the safetensors file layout, on torch tensors.

Layout: an 8-byte little-endian header length, a JSON header (padded with
spaces to a multiple of 8 bytes), then the raw little-endian tensor bytes.
The header maps each tensor name to ``{"dtype", "shape", "data_offsets"}``
and may carry a ``"__metadata__"`` dict of strings.

Files are written as the ``safetensors`` package writes them (metadata
first, tensors ordered by dtype rank descending then by name, compact JSON):
byte for byte where there is no metadata, and up to the order of metadata
keys otherwise, which that package writes in hash order. Caches therefore
interchange with the JAX package and the reference implementation in both
directions. bf16 is stored as its 16 raw bits, viewed through int16.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
import torch

# name → (torch dtype, numpy dtype of the raw bits, rank in the safetensors
# Dtype enum — the writer orders tensors by this rank, highest first).
_DTYPES = {
    "BOOL": (torch.bool, np.bool_, 0),
    "U8": (torch.uint8, np.uint8, 4),
    "I8": (torch.int8, np.int8, 5),
    "I16": (torch.int16, np.int16, 9),
    "F16": (torch.float16, np.float16, 11),
    "BF16": (torch.bfloat16, np.int16, 12),
    "I32": (torch.int32, np.int32, 13),
    "F32": (torch.float32, np.float32, 15),
    "F64": (torch.float64, np.float64, 16),
    "I64": (torch.int64, np.int64, 17),
}
_BY_TORCH = {v[0]: k for k, v in _DTYPES.items()}


def _raw_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def save_file(tensors: dict[str, torch.Tensor], filename, metadata: dict[str, str] | None = None):
    """Write ``tensors`` (any device; copied to host) to ``filename``."""
    for name, t in tensors.items():
        if t.dtype not in _BY_TORCH:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors counterpart here")
    order = sorted(tensors, key=lambda k: (-_DTYPES[_BY_TORCH[tensors[k].dtype]][2], k))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs, offset = [], 0
    for name in order:
        t = tensors[name]
        blob = _raw_bytes(t)
        header[name] = {
            "dtype": _BY_TORCH[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + len(blob)],
        }
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(Path(filename), "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for blob in blobs:
            f.write(blob)


def _read_header(f) -> dict:
    (n,) = struct.unpack("<Q", f.read(8))
    return json.loads(f.read(n))


def read_metadata(filename) -> dict[str, str] | None:
    """The ``__metadata__`` dict of a safetensors file (None when absent)."""
    with open(Path(filename), "rb") as f:
        return _read_header(f).get("__metadata__")


def load_file(filename) -> dict[str, torch.Tensor]:
    """All tensors of a safetensors file, as CPU tensors."""
    with open(Path(filename), "rb") as f:
        header = _read_header(f)
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise TypeError(f"{name}: unsupported safetensors dtype {info['dtype']}")
        torch_dtype, np_dtype, _ = _DTYPES[info["dtype"]]
        start, stop = info["data_offsets"]
        arr = np.frombuffer(data[start:stop], dtype=np_dtype).reshape(info["shape"])
        t = torch.from_numpy(arr.copy())
        out[name] = t.view(torch.bfloat16) if torch_dtype == torch.bfloat16 else t
    return out
