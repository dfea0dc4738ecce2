"""The benchmark's own instruments: host spans around calls into the
program's layers, CUDA events, the program's launch counters, and
torch.profiler windows summarised by kernel class, phase and idle gap.

A profiled window is one or more segments, each a phase of the work (the
denoise steps, the decode, ...) that starts and ends at a synchronisation
and records the device's activity only: recording every host operation
too costs tens of microseconds an operation, which can leave a training
step host-bound under the profiler and its idle share that of the
profiler. Its summary gives the seconds in which some device
operation ran (the union of the kernels', copies' and sets' intervals),
the segments' length by the host clock, the device seconds of each kernel
class in each phase, the device operations that took most time, and the
longest idle gaps, each named by the operation that ended it (the one the
host was launching).
"""

from __future__ import annotations

import time

import torch

# kernel classes, matched on the lowercased kernel name in this order (the
# int8 kernels first: "gemm" in their names would file them as matmul)
CLASSES = (("int8_gemm", ("int8_gemm_kernel",)),
           ("int8_quantize", ("quantize_rows_kernel",)),
           ("flash_fwd", ("flash_fwd",)),
           ("flash_bwd_dq", ("flash_bwd_dq",)),
           ("flash_bwd_dkv", ("flash_bwd_dkv",)),
           ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "sm90")))


def kernel_class(name: str) -> str:
    n = name.lower()
    for cls, keys in CLASSES:
        if any(k in n for k in keys):
            return cls
    return "other"


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def launch_counts() -> dict:
    """The program's own kernel launch counters."""
    from f_lite_tpu_torch.ops.cuda import flash_attention as fa
    from f_lite_tpu_torch.ops.cuda import int8_gemm as ig

    return {"fwd": fa.LAUNCHES.count, "dq": fa.DQ_LAUNCHES.count,
            "dkv": fa.DKV_LAUNCHES.count, "quantize": ig.QUANTIZE_LAUNCHES.count,
            "gemm": ig.GEMM_LAUNCHES.count}


def counts_since(before: dict) -> dict:
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


class Window:
    """Profiled segments: `start(phase)`, `stop()` (again for each phase;
    `phase(name)` stops the running one and starts the next), then
    `summary()`."""

    def __init__(self, device):
        self.device = device
        self.segments = []  # (phase, profiler, wall seconds, launch counts)
        self._open = None

    def start(self, phase: str) -> None:
        from torch.profiler import ProfilerActivity, profile

        sync(self.device)
        cuda = torch.device(self.device).type == "cuda"
        prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        prof.start()
        self._open = (phase, prof, launch_counts(), time.perf_counter())

    def stop(self) -> None:
        sync(self.device)
        phase, prof, before, t0 = self._open
        wall = time.perf_counter() - t0
        prof.stop()
        self.segments.append((phase, prof, wall, counts_since(before)))
        self._open = None

    def phase(self, name: str) -> None:
        """End the running segment and start the next, `name`."""
        self.stop()
        self.start(name)

    @property
    def counts(self) -> dict | None:
        if not self.segments:
            return None
        return {k: sum(seg[3][k] for seg in self.segments) for k in self.segments[0][3]}

    def summary(self) -> dict:
        by_phase: dict = {}
        by_name: dict = {}
        busy = window = 0.0
        gaps = []
        for phase, prof, wall, _ in self.segments:
            dev = sorted((e.time_range.start, e.time_range.end, e.name)
                         for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
            slot = by_phase.setdefault(phase, {})
            for start, end, name in dev:
                cls = kernel_class(name)
                slot[cls] = slot.get(cls, 0.0) + (end - start) / 1e6
                by_name[name[:120]] = by_name.get(name[:120], 0.0) + (end - start) / 1e6
            hi = None
            for start, end, name in dev:
                if hi is None or start > hi:
                    if hi is not None:
                        gaps.append((start - hi, name))
                    hi = end
                    busy += (end - start) / 1e6
                elif end > hi:
                    busy += (end - hi) / 1e6
                    hi = end
            window += wall
        named: dict = {}
        for length, name in gaps:
            named[name[:120]] = named.get(name[:120], 0.0) + length / 1e6
        return {"window_s": window, "busy_s": busy, "phases": by_phase,
                "counts": self.counts,
                "device_ops": sorted(([n, s] for n, s in by_name.items()),
                                     key=lambda x: -x[1])[:10],
                "idle_gaps": sorted(([n, s] for n, s in named.items()),
                                    key=lambda x: -x[1])[:10]}
