"""Checkpoint and resume (counterpart of `f_lite_tpu/train/checkpoint.py`,
with the port's own format: the JAX package writes Orbax trees, which the
port neither reads nor writes).

Layout and rules are the JAX package's:
- `{output_dir}/checkpoints/{step}/` holds the `state` entry, the extras
  (e.g. `ema`) and `sampler_state.json`;
- an entry is a directory with `tensors.safetensors` (the port's numpy
  writer; fp32, bf16 or int8 tensors by name) and `meta.json` (ints and
  strings: step, epoch, optimizer counts);
- extras are written first and `state` last, under a temporary name
  renamed at the end: `state` is the commit marker, and `steps()` counts
  committed dirs only, so a torn or in-flight save is skipped by `latest`
  and never counted by `prune`;
- `prune` keeps the newest `total_limit` committed dirs;
- `save(..., wait=False)` returns once the tensors are copied to host
  memory, and a writer thread does the rest; at most one write is in
  flight, and the next save or `wait_until_finished` drains it (raising
  what the writer raised).
`timings` lists each save's step, mode, the seconds it waited for the
write before it (`drain_s`), the seconds the caller was blocked in all and
the seconds its own write took.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from f_lite_tpu_torch.utils.safetensors import raw_arrays, save_file

TENSORS = "tensors.safetensors"
META = "meta.json"


def _write_entry(path: Path, tensors: dict, meta: dict) -> None:
    path.mkdir(parents=True, exist_ok=True)
    save_file(tensors, path / TENSORS)
    (path / META).write_text(json.dumps(meta, indent=2))


def read_entry(path: Path) -> tuple[dict, dict]:
    """(meta, {name: CPU tensor}) of a saved entry, in the saved dtypes."""
    meta = json.loads((path / META).read_text())
    tensors = {}
    for name, dt, arr in raw_arrays(path / TENSORS):
        if dt == "BF16":  # uint16 bits
            tensors[name] = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
        else:
            tensors[name] = torch.from_numpy(np.array(arr))
    return meta, tensors


class Checkpointer:
    def __init__(self, output_dir: str | Path, total_limit: int | None = None):
        self.root = Path(output_dir).resolve() / "checkpoints"
        self.root.mkdir(parents=True, exist_ok=True)
        self.total_limit = total_limit
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None
        self.timings: list[dict] = []

    def steps(self) -> list[int]:
        """Committed checkpoints (a dir with its `state`), oldest first."""
        return sorted(int(d.name) for d in self.root.iterdir()
                      if d.is_dir() and d.name.isdigit() and (d / "state").is_dir())

    @property
    def latest(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def dir(self, step: int) -> Path:
        return self.root / str(step)

    def save(self, step: int, tensors: dict, meta: dict,
             sampler_state: dict | None = None, *, wait: bool = True,
             extra: dict | None = None) -> Path:
        """Write checkpoint `step`: the `state` entry (`tensors`, `meta`),
        each extra ({name: tensors}) and the sampler state. With
        `wait=False` the tensors are copied to host memory here and written
        by a thread."""
        t0 = time.perf_counter()
        self.wait_until_finished()
        t1 = time.perf_counter()
        d = self.dir(step)
        extra = extra or {}
        timing = {"step": step, "wait": wait, "drain_s": t1 - t0}
        self.timings.append(timing)
        if wait:
            self._write(d, tensors, meta, sampler_state, extra)
            timing["write_s"] = time.perf_counter() - t1
            timing["blocked_s"] = time.perf_counter() - t0
            return d
        host = {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}
        host_extra = {name: {k: v.detach().to("cpu", copy=True) for k, v in t.items()}
                      for name, t in extra.items()}
        timing["blocked_s"] = time.perf_counter() - t0
        self._writer = threading.Thread(
            target=self._write_async,
            args=(timing, d, host, meta, sampler_state, host_extra),
            name=f"checkpoint-{step}", daemon=False)
        self._writer.start()
        return d

    def _write_async(self, timing: dict, *args) -> None:
        t0 = time.perf_counter()
        try:
            self._write(*args)
        except Exception as e:  # re-raised by the next drain
            self._error = e
        timing["write_s"] = time.perf_counter() - t0

    def _write(self, d: Path, tensors, meta, sampler_state, extra) -> None:
        d.mkdir(parents=True, exist_ok=True)
        for name, t in extra.items():
            _write_entry(d / name, t, {})
        if sampler_state is not None:
            (d / "sampler_state.json").write_text(json.dumps(sampler_state, indent=2))
        tmp = d / f"state.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        _write_entry(tmp, tensors, meta)
        if (d / "state").exists():  # a save at a step saved before
            shutil.rmtree(d / "state")
        os.replace(tmp, d / "state")
        self.prune()

    def wait_until_finished(self) -> None:
        """Drain the write in flight, if any; raise what it raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("the checkpoint writer failed") from err

    def resolve(self, which: str | int) -> int | None:
        """"latest" (None without a committed checkpoint), a step, or a
        checkpoint dir's path."""
        if which == "latest":
            return self.latest
        return int(Path(str(which)).name)

    def load(self, step: int) -> tuple[dict, dict]:
        """(meta, tensors) of checkpoint `step`'s state."""
        return read_entry(self.dir(step) / "state")

    def load_extra(self, step: int, name: str) -> dict | None:
        """An extra's tensors, None if the checkpoint has none."""
        p = self.dir(step) / name
        return read_entry(p)[1] if p.is_dir() else None

    def load_sampler_state(self, step: int) -> dict | None:
        f = self.dir(step) / "sampler_state.json"
        return json.loads(f.read_text()) if f.exists() else None

    def prune(self) -> None:
        if self.total_limit is None:
            return
        steps = self.steps()
        while len(steps) > self.total_limit:
            shutil.rmtree(self.dir(steps.pop(0)), ignore_errors=True)
