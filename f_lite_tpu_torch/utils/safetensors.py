"""A numpy-only reader and writer of the safetensors format.

Layout: an 8-byte little-endian header length N, N bytes of JSON
({name: {"dtype", "shape", "data_offsets": [begin, end]}, optional
"__metadata__"}), then the tensor bytes, offsets relative to the end of the
header. F32, F16 and I8 (int8 weights of a quantized DiT) load as such;
BF16 widens exactly to float32 (numpy has no bfloat16). `raw_arrays` yields
each tensor as a view of a map of the file (BF16 as its uint16 bits), so a
caller can take one tensor at a time without reading the whole file. The
writer stores float32 and int8 arrays and float32, bfloat16 and int8
tensors, in name order (`order`), one tensor at a time (`writer`).
"""

from __future__ import annotations

import json
import struct
from contextlib import contextmanager
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

_DTYPES = {"F32": np.float32, "F16": np.float16, "BF16": np.uint16,
           "I8": np.int8}


def read_header(path: str | Path) -> tuple[dict, int]:
    """({name: info} without "__metadata__", offset of the tensor bytes)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def raw_arrays(path: str | Path) -> Iterator[tuple[str, str, np.ndarray]]:
    """(name, safetensors dtype, array) for every tensor of the file. The
    arrays are views of a copy-on-write map of the file, BF16 as uint16
    bits: a tensor's bytes are read when it is used."""
    header, base = read_header(path)
    data = np.memmap(path, np.uint8, mode="c")
    for name, info in header.items():
        dt = info["dtype"]
        if dt not in _DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {dt}")
        begin, end = info["data_offsets"]
        arr = data[base + begin : base + end].view(_DTYPES[dt])
        yield name, dt, arr.reshape(info["shape"])


def load_file(path: str | Path, bf16_bits: bool = False) -> dict[str, np.ndarray]:
    """{name: array} of the file, each a copy, BF16 widened to float32; with
    `bf16_bits` the arrays of `raw_arrays` instead (views of a
    copy-on-write map, BF16 as its uint16 bits), for a loader that copies
    what it keeps (the DiT's, `convert.from_jax`)."""
    out = {}
    for name, dt, arr in raw_arrays(path):
        if bf16_bits:
            out[name] = arr
        elif dt == "BF16":  # widened by torch, on every core
            out[name] = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).float().numpy()
        else:
            out[name] = np.array(arr)
    return out


_WRITE = {np.dtype(np.float32): "F32", np.dtype(np.int8): "I8"}
_WRITE_TORCH = {torch.float32: "F32", torch.bfloat16: "BF16", torch.int8: "I8"}


def _meta(name: str, value) -> tuple[str, list[int], int]:
    """(safetensors dtype, shape, byte count) of one tensor."""
    if isinstance(value, torch.Tensor):
        dt = _WRITE_TORCH.get(value.dtype)
        itemsize = value.dtype.itemsize
    else:
        value = np.asarray(value)
        dt = _WRITE.get(value.dtype)
        itemsize = value.dtype.itemsize
    if dt is None:
        raise ValueError(f"tensor {name}: {value.dtype}, the writer takes "
                         "float32, bfloat16 (torch) and int8")
    return dt, list(value.shape), int(np.prod(value.shape, dtype=np.int64)) * itemsize


def _bytes(value) -> np.ndarray:
    """One tensor's little-endian bytes, as a uint8 array (bfloat16 as its
    16-bit pattern)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        value = t.numpy()
    arr = np.ascontiguousarray(value).reshape(-1)
    return arr.astype(arr.dtype.newbyteorder("<"), copy=False).view(np.uint8)


def order(tensors) -> list[str]:
    """The names of `tensors` in the order a file holds them."""
    return sorted(tensors)


@contextmanager
def writer(tensors: dict, path: str | Path):
    """Open `path` for `tensors` ({name: array or tensor}; a DTensor's
    shape and dtype are its whole tensor's) and write the header; yields
    `put(name, value)`, which writes one whole value's bytes. Call it once
    for each name, in `order(tensors)`; a name out of that order raises."""
    names = order(tensors)
    header: dict = {}
    offset = 0
    for name in names:
        dt, shape, n = _meta(name, tensors[name])
        header[name] = {"dtype": dt, "shape": shape,
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # the data starts 8-byte aligned
    pending = iter(names)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)

        def put(name: str, value) -> None:
            want = next(pending, None)
            if name != want:
                raise ValueError(f"{path}: got tensor {name!r} where {want!r} is next")
            f.write(_bytes(value))

        yield put
        missing = next(pending, None)
        if missing is not None:
            raise ValueError(f"{path}: tensor {missing!r} was never written")


def save_file(tensors: dict, path: str | Path) -> None:
    """Write `tensors` ({name: array or tensor}) as one safetensors file,
    one tensor's bytes in memory at a time."""
    with writer(tensors, path) as put:
        for name in order(tensors):
            put(name, tensors[name])
