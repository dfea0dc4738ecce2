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
write before it (`drain_s`), the seconds the caller was blocked in all,
the seconds its own write took and, of those, the seconds spent gathering
the tensors whole (`gather_s`).

Across ranks (FSDP2: the tensors are DTensor shards) every rank calls
`save` with the same names; each tensor is gathered whole, one at a time,
and rank 0 writes it (a sync save streams: at most one whole tensor is in
host memory; an async one gathers to rank 0's host memory, then its thread
writes). `prune` runs on rank 0 with the write, and every rank waits at a
barrier of `group` for the write in flight before the next save. The
files are the one-rank files, so a checkpoint resumes at any world size.
Reading is lazy (`read_entry`): each tensor is read from its file when it
is taken.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from collections.abc import Mapping
from contextlib import ExitStack, contextmanager
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from f_lite_tpu_torch.parallel.sharding import full_tensor
from f_lite_tpu_torch.utils.safetensors import order, raw_arrays, writer

TENSORS = "tensors.safetensors"
META = "meta.json"


def _gathered(entries: dict, gather):
    """(entry, name, `gather(tensor, name)`) for every tensor of `entries`, in
    the one order in which every rank gathers them and rank 0 writes
    them: the entries in turn (the extras, then `state`), each in its
    file's order."""
    for entry, tensors in entries.items():
        for name in order(tensors):
            yield entry, name, gather(tensors[name], name)


class _Entry(Mapping):
    """A saved entry's tensors by name, each read into a CPU tensor, in
    its saved dtype, when it is taken."""

    def __init__(self, path: Path):
        self._arrays = {name: (dt, arr) for name, dt, arr in raw_arrays(path)}

    def __getitem__(self, name: str) -> torch.Tensor:
        dt, arr = self._arrays[name]
        if dt == "BF16":  # uint16 bits
            return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(np.array(arr))

    def __iter__(self):
        return iter(self._arrays)

    def __len__(self) -> int:
        return len(self._arrays)


def read_entry(path: Path) -> tuple[dict, Mapping]:
    """(meta, {name: CPU tensor}) of a saved entry, in the saved dtypes;
    each tensor is read when it is taken."""
    return json.loads((path / META).read_text()), _Entry(path / TENSORS)


class Checkpointer:
    def __init__(self, output_dir: str | Path, total_limit: int | None = None, *,
                 rank: int = 0, group=None, stages=None):
        """`rank` writes where it is 0; `group` (a host-side process group,
        None for one rank) holds every rank at each save until the write
        before it is done; `stages`: the pipeline's `StageGroup`, whose
        other stages' tensors each save also writes."""
        self.root = Path(output_dir).resolve() / "checkpoints"
        self.root.mkdir(parents=True, exist_ok=True)
        self.total_limit = total_limit
        self.rank = rank
        self.group = group
        self.stages = stages
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
        if self.group is not None:
            dist.barrier(group=self.group)
        t1 = time.perf_counter()
        d = self.dir(step)
        entries = {**(extra or {}), "state": tensors}  # `state` last
        whole_of = full_tensor
        if self.stages is not None:
            entries = {k: self.stages.view(v) for k, v in entries.items()}
            whole_of = self.stages.whole
        timing = {"step": step, "wait": wait, "drain_s": t1 - t0, "gather_s": 0.0}
        self.timings.append(timing)

        def gather(t, name):
            tic = time.perf_counter()
            whole = whole_of(t.detach(), name)
            timing["gather_s"] += time.perf_counter() - tic
            return whole

        if wait:  # streamed: one whole tensor at a time on rank 0's host
            with self._writing(d, entries, meta, sampler_state) as put:
                for entry, name, whole in _gathered(entries, gather):
                    if put is not None:
                        put(entry, name, whole)
            timing["write_s"] = time.perf_counter() - t1
            timing["blocked_s"] = time.perf_counter() - t0
            return d
        host: dict = {entry: {} for entry in entries}
        for entry, name, whole in _gathered(entries, gather):
            if self.rank == 0:
                host[entry][name] = whole.to("cpu", copy=True)
        timing["blocked_s"] = time.perf_counter() - t0
        if self.rank == 0:
            self._writer = threading.Thread(
                target=self._write_async, args=(timing, d, host, meta, sampler_state),
                name=f"checkpoint-{step}", daemon=False)
            self._writer.start()
        return d

    def _write_async(self, timing: dict, d: Path, host: dict, meta, sampler_state) -> None:
        t0 = time.perf_counter()
        try:
            with self._writing(d, host, meta, sampler_state) as put:
                for entry, name, whole in _gathered(host, lambda t, _: t):
                    put(entry, name, whole)
        except Exception as e:  # re-raised by the next drain
            self._error = e
        timing["write_s"] = time.perf_counter() - t0

    @contextmanager
    def _writing(self, d: Path, entries: dict, meta, sampler_state):
        """On rank 0: open each entry's file (`state` under a temporary
        name) and yield `put(entry, name, whole)`, which writes one whole
        tensor; then write the metas and the sampler state, commit `state`
        by its rename and prune. On the other ranks: yield None."""
        if self.rank != 0:
            yield None
            return
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / f"state.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        paths = {name: tmp if name == "state" else d / name for name in entries}
        with ExitStack() as files:
            puts = {}
            for name, path in paths.items():
                path.mkdir(parents=True, exist_ok=True)
                puts[name] = files.enter_context(writer(entries[name], path / TENSORS))
            yield lambda entry, name, whole: puts[entry](name, whole)
        for name, path in paths.items():
            (path / META).write_text(json.dumps(meta if name == "state" else {}, indent=2))
        if sampler_state is not None:
            (d / "sampler_state.json").write_text(json.dumps(sampler_state, indent=2))
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

    def load(self, step: int) -> tuple[dict, Mapping]:
        """(meta, tensors) of checkpoint `step`'s state, read lazily."""
        return read_entry(self.dir(step) / "state")

    def load_extra(self, step: int, name: str) -> Mapping | None:
        """An extra's tensors (read lazily), None if the checkpoint has
        none."""
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
