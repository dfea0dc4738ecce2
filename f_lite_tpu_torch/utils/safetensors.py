"""A numpy-only reader of the safetensors format.

Layout: an 8-byte little-endian header length N, N bytes of JSON
({name: {"dtype", "shape", "data_offsets": [begin, end]}, optional
"__metadata__"}), then the tensor bytes, offsets relative to the end of the
header. F32 and F16 load as such; BF16 widens exactly to float32 (numpy has
no bfloat16).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

_DTYPES = {"F32": np.float32, "F16": np.float16, "BF16": np.uint16}


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
