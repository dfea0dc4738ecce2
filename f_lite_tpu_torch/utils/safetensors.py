"""A numpy-only reader and writer of the safetensors format.

Layout: an 8-byte little-endian header length N, N bytes of JSON
({name: {"dtype", "shape", "data_offsets": [begin, end]}, optional
"__metadata__"}), then the tensor bytes, offsets relative to the end of the
header. F32, F16 and I8 (int8 weights of a quantized DiT) load as such;
BF16 widens exactly to float32 (numpy has no bfloat16). The writer stores float32 arrays, in name order.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

_DTYPES = {"F32": np.float32, "F16": np.float16, "BF16": np.uint16,
           "I8": np.int8}


def load_file(path: str | Path) -> dict[str, np.ndarray]:
    data = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8 : 8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = info["dtype"]
        if dt not in _DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {dt}")
        begin, end = info["data_offsets"]
        arr = np.frombuffer(data, _DTYPES[dt], (end - begin)
                            // np.dtype(_DTYPES[dt]).itemsize, base + begin)
        arr = arr.reshape(info["shape"])
        if dt == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr.copy()
    return out


def save_file(tensors: dict[str, np.ndarray], path: str | Path) -> None:
    """Write `tensors` ({name: float32 array}) as one safetensors file."""
    header: dict = {}
    blobs, offset = [], 0
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        if arr.dtype != np.float32:
            raise ValueError(f"tensor {name}: {arr.dtype}, the writer takes float32")
        data = arr.astype("<f4", copy=False).tobytes()
        header[name] = {"dtype": "F32",
                        "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)
