"""Weights of a Hugging Face model folder into a module of the port
(counterpart of `load_hf_weights` in `f_lite_tpu/convert/torch_to_jax.py`).

Files, in this order of preference (the first that exists is read):
1. the shards listed by `model.safetensors.index.json`;
2. `model.safetensors`;
3. every `*.safetensors`;
4. `pytorch_model*.bin`, through `torch.load(weights_only=True)`. Never a
   bare `*.bin`: trainer folders hold a pickled `training_args.bin`.

Tensors are taken one at a time, from a map of the file, and copied straight
into the module's parameter at its dtype and on its device. A text tower of
several billion parameters never exists on the host as a whole, let alone
widened to fp32.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Iterator

import torch
from torch import nn

from f_lite_tpu_torch.utils.safetensors import raw_arrays


def weight_files(path: str | Path) -> list[Path]:
    """The weight files of an HF model folder, in the order of preference."""
    path = Path(path)
    index = path / "model.safetensors.index.json"
    if index.exists():
        shards = set(json.loads(index.read_text())["weight_map"].values())
        return [path / f for f in sorted(shards)]
    single = path / "model.safetensors"
    if single.exists():
        return [single]
    for pattern in ("*.safetensors", "pytorch_model*.bin"):
        files = sorted(path.glob(pattern))
        if files:
            return files
    raise FileNotFoundError(f"no weights under {path}")


def iter_hf_tensors(path: str | Path) -> Iterator[tuple[str, torch.Tensor]]:
    """(name, CPU tensor) for every weight of the folder, file by file; a
    safetensors tensor is a view of the mapped file in its stored dtype."""
    for f in weight_files(path):
        if f.suffix == ".safetensors":
            for name, dt, arr in raw_arrays(f):
                t = torch.from_numpy(arr)
                yield name, t.view(torch.bfloat16) if dt == "BF16" else t
        else:
            sd = torch.load(f, map_location="cpu", weights_only=True, mmap=True)
            if isinstance(sd, dict) and "state_dict" in sd:
                sd = sd["state_dict"]
            yield from sd.items()


@torch.no_grad()
def load_hf_weights_into(module: nn.Module, path: str | Path,
                         key_of: Callable[[str], str | None]) -> nn.Module:
    """Copy the folder's weights into `module`'s parameters, each cast to
    the parameter's dtype on its device. `key_of(file key)` names the
    parameter, or returns None for a key outside the module's part of the
    checkpoint; a named parameter the module lacks raises. Every parameter
    must be filled (a key met twice must hold the same values)."""
    params = dict(module.named_parameters())
    filled: set[str] = set()
    for name, t in iter_hf_tensors(path):
        key = key_of(name)
        if key is None:
            continue
        if key not in params:
            raise KeyError(f"{path}: checkpoint key {name!r} -> {key!r}, "
                           "which the module does not have")
        p = params[key]
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{path}: {name} has shape {tuple(t.shape)}, "
                             f"{key} {tuple(p.shape)}")
        if key in filled:
            if not torch.equal(p, t.to(p.device, p.dtype)):
                raise ValueError(f"{path}: {name} disagrees with an earlier "
                                 f"key for {key}")
            continue
        p.copy_(t)
        filled.add(key)
    missing = sorted(set(params) - filled)
    if missing:
        raise KeyError(f"{path}: no weights for {len(missing)} parameters, "
                       f"e.g. {missing[:4]}")
    return module


def empty_module(factory: Callable[[], nn.Module], dtype: torch.dtype,
                 device) -> nn.Module:
    """`factory()` built without initialising anything: its parameters are
    allocated once, at `dtype` on `device`, and hold no values yet."""
    with torch.device("meta"):
        module = factory()
    return module.to(dtype).to_empty(device=device)
