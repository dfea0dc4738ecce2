"""The program's spans joined with a profiled window's device activity, and
a probe that records both in one cell.

    python3 -m portbench.spans --workload <cell> --seed <n> [--out <file>]

The join (`attribute`): each kernel, copy or set on the device is put down
to the innermost program span open when the CUDA call that launched it
ran, launch and operation matched by the profiler's correlation id; each
idle gap between the union of the operations' intervals is put down to the
innermost span open on the recording's thread when the launch that ended
the gap ran. Times are compared on one clock: the spans' Unix-epoch ns
(`f_lite_tpu_torch/utils/trace.py`) and the kineto events' absolute ns.
The profiler records the device alone, as `portbench/trace.py` does, but
the launching calls come with it (every one with thread id 1, so a kernel
goes to the latest started of the spans open on any thread: the port's
threads issue work one at a time, the main thread waiting in the backward
while the autograd engine's launches).

The probe builds the cell as its driver does (the same weights and inputs
from the seed) and prints one JSON object: the clock check (spans around
one launch each), the cost of an open recording (requests or steps with
the recording closed and open in turns), the host time of the spans over
the unprofiled ones, and the join of one profiled window (serving: the
mix's last `trace.steps` steps, the decode and the return of one request;
training: `trace.steps` steps, each synchronised as the driver does). Its
`metrics` are the per-layer metrics that read spans, under the names
`PERF.md` proposes for them; nothing of `BENCHMARK.json` reads this
module. It does not check `correct`: the benchmark's runs do.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

# the elementwise op spans, which never nest in one another
OPS = ("op.rms_norm", "block.adaln", "op.rope", "op.swiglu")
OP_METRICS = {"op.rms_norm": "norm_ms.serve", "block.adaln": "adaln_ms.serve",
              "op.rope": "rope_ms.serve", "op.swiglu": "swiglu_ms.serve"}


def profiler_events(prof) -> tuple[list, dict]:
    """(device operations, launches) of a stopped torch.profiler session:
    [(start_ns, end_ns, correlation id, name)] for every kernel, copy and
    set on the device, ordered by start, and {correlation id: (start_ns,
    end_ns)} of the CUDA runtime or driver call that launched each."""
    import torch

    ops, calls = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ops.append((e.start_ns(), e.end_ns(), e.correlation_id(), e.name()))
        elif e.name().startswith("cu"):  # cudaLaunchKernel, cuLaunchKernelEx, ...
            calls[e.correlation_id()] = (e.start_ns(), e.end_ns())
    ops.sort()
    return ops, {op[2]: calls[op[2]] for op in ops if op[2] in calls}


class Index:
    """Spans (anything with id, parent, thread, start_ns, end_ns) by thread,
    ordered by start."""

    def __init__(self, spans):
        self.by_id = {s.id: s for s in spans}
        self.threads: dict = {}
        for s in sorted(spans, key=lambda s: s.start_ns):
            starts, ordered = self.threads.setdefault(s.thread, ([], []))
            starts.append(s.start_ns)
            ordered.append(s)

    def innermost(self, t: int, thread=None):
        """The innermost span open at `t` on `thread`: the last one started
        by then, or the first of its ancestors on that thread still open.
        With no thread, the latest started of each thread's."""
        if thread is None:
            found = [s for th in self.threads if (s := self.innermost(t, th))]
            return max(found, key=lambda s: s.start_ns, default=None)
        if thread not in self.threads:
            return None
        starts, ordered = self.threads[thread]
        i = bisect.bisect_right(starts, t) - 1
        s = ordered[i] if i >= 0 else None
        while s is not None and s.thread == thread and s.end_ns < t:
            s = self.by_id.get(s.parent)
        return s if s is not None and s.thread == thread else None

    def lineage(self, sid) -> list:
        """The names from span `sid` up to its root ([] for None)."""
        names = []
        s = self.by_id.get(sid)
        while s is not None:
            names.append(s.name)
            s = self.by_id.get(s.parent)
        return names


def attribute(ops: list, launches: dict, spans, main_thread: int,
              window: tuple | None = None) -> dict:
    """Put a profiled window's device time down to `spans`.

    `ops` and `launches` as `profiler_events` gives them (an operation
    without a launch is taken as launched when it started). "kernels":
    [(device ns, span id or None, name)], each operation to the innermost
    span open on any thread when its launch ran. "gaps": [(idle ns, span
    id or None)], each gap between the union of the operations' intervals
    to the innermost span open on `main_thread` when the launch that ended
    it ran; with `window` (start_ns, end_ns) also the gap before the first
    operation and the one after the last (to no span)."""
    index = Index(spans)

    def sid(s):
        return None if s is None else s.id

    kernels, gaps = [], []
    hi = window[0] if window else None
    for start, end, corr, name in ops:
        t = launches[corr][0] if corr in launches else start
        kernels.append((end - start, sid(index.innermost(t)), name))
        if hi is not None and start > hi:
            gaps.append((start - hi, sid(index.innermost(t, main_thread))))
        hi = end if hi is None else max(hi, end)
    if window and hi is not None and window[1] > hi:
        gaps.append((window[1] - hi, None))
    return {"kernels": kernels, "gaps": gaps}


def nearest(lineage: list, names) -> str | None:
    """The first of `lineage` (innermost first) that is one of `names`."""
    return next((n for n in lineage if n in names), None)


def op_ms(joined: dict, index: Index, within: str, per: int, kernel_class) -> dict:
    """Device ms per `per` of the kernels under span `within`: by their
    nearest op span ("op_ms"), the elementwise class "other" in all
    ("other_ms"), in op spans ("other_in_ops_ms"), and outside them by
    kernel name ("rest_by_kernel")."""
    ops = dict.fromkeys(OPS, 0.0)
    other = in_ops = 0.0
    rest: dict = {}
    for ns, sid, name in joined["kernels"]:
        lin = index.lineage(sid)
        if within not in lin:
            continue
        op = nearest(lin, OPS)
        ms = ns / 1e6 / per
        if op is not None:
            ops[op] += ms
        if kernel_class(name) == "other":
            other += ms
            if op is not None:
                in_ops += ms
            else:
                rest[name[:100]] = rest.get(name[:100], 0.0) + ms
    return {"op_ms": ops, "other_ms": other, "other_in_ops_ms": in_ops,
            "rest_by_kernel": dict(sorted(rest.items(), key=lambda kv: -kv[1])[:8])}


def device_ms_under(joined: dict, index: Index, name: str) -> float:
    return sum(ns for ns, sid, _ in joined["kernels"] if name in index.lineage(sid)) / 1e6


def idle_parts(joined: dict, index: Index, per: int) -> dict:
    """The gaps' ms per `per` by the part of a training step they fall in:
    under `train.loss` (forward), `train.backward` (the recompute too), an
    `optim.*` span, elsewhere in `train.step`, or outside every step."""
    parts = dict.fromkeys(("forward", "backward", "optimizer", "step_other", "outside"), 0.0)
    for ns, sid in joined["gaps"]:
        lin = index.lineage(sid)
        if "train.loss" in lin:
            part = "forward"
        elif "train.backward" in lin:
            part = "backward"
        elif any(n.startswith("optim.") for n in lin):
            part = "optimizer"
        elif "train.step" in lin:
            part = "step_other"
        else:
            part = "outside"
        parts[part] += ns / 1e6 / per
    return parts


def idle_by_span(joined: dict, index: Index, per: int, top: int = 10) -> dict:
    """The gaps' ms per `per` by the innermost span and its two parents."""
    out: dict = {}
    for ns, sid in joined["gaps"]:
        key = " < ".join(index.lineage(sid)[:3]) or "none"
        out[key] = out.get(key, 0.0) + ns / 1e6 / per
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:top])


def busy_ms(ops: list) -> float:
    """The union of the operations' intervals, in ms."""
    busy, hi = 0, None
    for start, end, *_ in ops:
        if hi is None or start > hi:
            busy += end - start
            hi = end
        elif end > hi:
            busy += end - hi
            hi = end
    return busy / 1e6


def host_ms(spans, name: str) -> list:
    return [(s.end_ns - s.start_ns) / 1e6 for s in spans if s.name == name]


def _mean(xs) -> float | None:
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


class Profiled:
    """A device-only torch.profiler session (the CPU's where there is no
    card), started and stopped at a synchronisation, with its bounds in
    Unix-epoch ns."""

    def __init__(self, device):
        self.device = device

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        from portbench.trace import sync

        sync(self.device)
        cuda = self.device.type == "cuda"
        self.prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        self.prof.start()
        self.start_ns = time.time_ns()

    def stop(self) -> None:
        from portbench.trace import sync

        sync(self.device)
        self.end_ns = time.time_ns()
        self.prof.stop()

    def join(self, rec) -> tuple:
        """(ops, launches, attribute's result, Index) of the window with
        `rec`."""
        ops, launches = profiler_events(self.prof)
        joined = attribute(ops, launches, rec.spans, rec.thread, (self.start_ns, self.end_ns))
        return ops, launches, joined, Index(rec.spans)

    def window_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def first_gap(self, ops: list, joined: dict, index: Index) -> dict:
        """The idle from the window's start to its first operation (the
        profiler's own start-up lies in it) and the span it goes to."""
        if not ops or ops[0][0] <= self.start_ns:
            return {"ms": 0.0, "span": None}
        return {"ms": (ops[0][0] - self.start_ns) / 1e6,
                "span": " < ".join(index.lineage(joined["gaps"][0][1])) or None}


def clock_check(device, n: int = 200) -> dict | None:
    """Spans around one launch each on the card, the i-th span's launch the
    one of the i-th kernel: how many spans hold their launch's start (the
    join's test) and the whole launch, how many kernels start after their
    launch began, and quartiles (us) of the launch's start less the span's,
    the span's end less the launch's and the kernel's start less the
    launch's."""
    import torch

    from f_lite_tpu_torch.utils import trace

    if device.type != "cuda":
        return None
    x = torch.zeros(1, device=device)
    x.add_(1)
    prof = Profiled(device)
    with trace.recording() as rec:
        prof.start()
        for _ in range(n):
            with trace.span("clock"):
                x.add_(1)
        prof.stop()
    ops, launches = profiler_events(prof.prof)
    pairs = [(s, launches[op[2]], op[0]) for s, op in
             zip(sorted(rec.spans, key=lambda s: s.start_ns), ops) if op[2] in launches]

    def quartiles(xs):
        return statistics.quantiles(xs, n=4) if len(xs) > 1 else xs

    return {"spans": len(rec.spans), "kernels": len(ops), "launches": len(launches),
            "start_inside": sum(s.start_ns <= c[0] <= s.end_ns for s, c, _ in pairs),
            "whole_inside": sum(s.start_ns <= c[0] and c[1] <= s.end_ns for s, c, _ in pairs),
            "kernel_after_launch": sum(k >= c[0] for _, c, k in pairs),
            "launch_after_span_start_us": quartiles([(c[0] - s.start_ns) / 1e3
                                                     for s, c, _ in pairs]),
            "span_end_after_launch_us": quartiles([(s.end_ns - c[1]) / 1e3
                                                   for s, c, _ in pairs]),
            "kernel_minus_launch_us": quartiles([(k - c[0]) / 1e3 for _, c, k in pairs]),
            "span_us_median": statistics.median(
                (s.end_ns - s.start_ns) / 1e3 for s in rec.spans)}


def serve(cell, seed: int, device, pairs: int = 2) -> dict:
    """The probe in a serving cell."""
    import torch

    from f_lite_tpu_torch.utils import trace
    from portbench.drivers import serve as drv
    from portbench.reference import strict_fp32
    from portbench.trace import kernel_class

    cfg, traffic = cell.config, cell.traffic
    steps, n_prof = traffic["steps"], traffic["trace"]["steps"]
    strict_fp32()
    pipe = drv.build_pipeline(cfg, traffic, seed, device, bool(traffic["quantize"]))
    lengths = drv.text_lengths(traffic, seed)
    reqs = [drv.draw_request(cfg, traffic, seed, i, lengths, device)
            for i in range(2 * pairs + 1)]

    def call(req, n_steps=steps):
        return pipe(prompt_embeds=req["embeds"], context_mask=req["mask"],
                    height=traffic["height"], width=traffic["width"],
                    num_inference_steps=n_steps, guidance_scale=traffic["guidance_scale"],
                    latents=req["latents"], output_type="uint8").images

    call(reqs[0], n_steps=1)
    out = {"clock": clock_check(device)}
    # the recording closed and open in turns, one request each
    seconds = {"closed": [], "open": []}
    recs = []
    for i in range(pairs):
        for j, opened in enumerate((False, True) if i % 2 == 0 else (True, False)):
            with trace.recording() if opened else contextlib.nullcontext() as rec:
                t = time.perf_counter()
                call(reqs[2 * i + j])
                seconds["open" if opened else "closed"].append(time.perf_counter() - t)
            if opened:
                recs.append(rec)
    spans = [s for rec in recs for s in rec.spans]
    out["request_s"] = seconds
    out["spans_a_request"] = len(spans) / len(recs)

    # one profiled request: the last steps, the decode and the return
    prof = Profiled(device)
    seen = {"dit": 0}

    def pre(_m, _args):
        if seen["dit"] == steps - n_prof:
            prof.start()
        seen["dit"] += 1

    hook = pipe.dit.register_forward_pre_hook(pre)
    with trace.recording() as rec:
        call(reqs[-1])
        prof.stop()
    hook.remove()
    ops, launches, joined, index = prof.join(rec)
    ew = op_ms(joined, index, "sample.step", n_prof, kernel_class)
    busy = busy_ms(ops)
    out["profiled"] = {
        "steps": n_prof, "window_ms": prof.window_ms(), "busy_ms": busy,
        "idle_ms": prof.window_ms() - busy, "first_gap": prof.first_gap(ops, joined, index),
        "idle_by_span_ms": idle_by_span(joined, index, 1),
        "launches_matched": [len(launches), len(ops)],
        **ew,
        "op_share_of_other": ew["other_in_ops_ms"] / ew["other_ms"] if ew["other_ms"] else None,
    }
    metrics = {OP_METRICS[op]: (ms if ops else None) for op, ms in ew["op_ms"].items()}
    metrics["step_host_ms.serve"] = _mean(host_ms(spans, "sample.step"))
    metrics["prepare_host_ms.spans"] = _mean(host_ms(spans, "pipeline.prepare"))
    metrics["return_idle_ms.spans"] = sum(
        ns for ns, sid in joined["gaps"]
        if not {"pipeline.denoise", "pipeline.decode"} & set(index.lineage(sid))) / 1e6 \
        if ops else None
    metrics["vae_decode_ms.spans"] = device_ms_under(joined, index, "pipeline.decode") if ops \
        else None
    out["metrics"] = metrics
    del pipe
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def train(cell, seed: int, device, pairs: int = 4) -> dict:
    """The probe in a training cell."""
    from f_lite_tpu_torch.train.loss import LossDraws
    from f_lite_tpu_torch.train.step import train_step
    from f_lite_tpu_torch.utils import trace
    from portbench.drivers import train as drv
    from portbench.reference import strict_fp32
    from portbench.trace import kernel_class, sync

    cfg, traffic = cell.config, cell.traffic
    strict_fp32()
    state = drv.build_state(cfg, traffic, seed, device)
    lengths = drv.text_lengths(traffic, seed)
    timing, events = {"on": True}, []
    if device.type == "cuda":
        drv.time_optimizer(state.optimizer, timing, events)
    fed = {"k": 0}

    def feed():
        fed["k"] += 1
        return drv.draw_batch(cfg, traffic, seed, fed["k"], lengths, device)

    def step(b):
        train_step(state, b["latents"], b["context"], b["mask"],
                   draws=LossDraws(b["drop"], b["t"], b["noise"], None),
                   patch_size=cfg["patch_size"])

    for _ in range(traffic["check_steps"]):  # the driver's warm-up
        step(feed())
    sync(device)
    out = {"clock": clock_check(device)}
    rows, spans = [], []
    for i in range(pairs):
        for opened in ((False, True) if i % 2 == 0 else (True, False)):
            b = feed()
            sync(device)
            with trace.recording() if opened else contextlib.nullcontext() as rec:
                t = time.perf_counter()
                step(b)
                sync(device)
                s = time.perf_counter() - t
            if opened:
                spans += rec.spans
            rows.append({"open": opened, "step_s": s,
                         "optimizer_ms": events[-1][0].elapsed_time(events[-1][1])
                         if events else None})
    out["steps"] = rows
    n_prof = traffic["trace"]["steps"]
    batches = [feed() for _ in range(n_prof)]
    prof = Profiled(device)
    prof.start()
    with trace.recording() as rec:
        for b in batches:
            step(b)
            sync(device)
        prof.stop()
    ops, _, joined, index = prof.join(rec)
    busy = busy_ms(ops)
    parts = idle_parts(joined, index, n_prof)
    by_span: dict = {}
    for ns, sid, name in joined["kernels"]:
        if kernel_class(name) == "other":
            key = (index.lineage(sid) or ["none"])[0]
            by_span[key] = by_span.get(key, 0.0) + ns / 1e6 / n_prof
    out["profiled"] = {
        "steps": n_prof, "window_ms": prof.window_ms(), "busy_ms": busy,
        "idle_ms": prof.window_ms() - busy, "first_gap": prof.first_gap(ops, joined, index),
        "idle_parts_ms_a_step": parts,
        "idle_parts_sum_ms": sum(parts.values()) * n_prof,
        "idle_by_span_ms": idle_by_span(joined, index, n_prof),
        "other_ms_a_step_by_innermost_span": dict(sorted(by_span.items(),
                                                         key=lambda kv: -kv[1])),
    }
    out["metrics"] = {
        "step_host_ms.train": _mean(host_ms(spans, "train.step")),
        "forward_idle_ms.train": parts["forward"] if ops else None,
        "backward_idle_ms.train": parts["backward"] if ops else None,
        "optimizer_idle_ms.train": parts["optimizer"] if ops else None,
    }
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", default=None, help="also write the JSON object here")
    args = p.parse_args(argv)
    from portbench.run import power_limit, prepare_environment

    prepare_environment()
    import torch

    from portbench import registry

    cell = registry.cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench.spans: needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t = time.perf_counter()
    probe = serve if cell.traffic["driver"] == "serve" else train
    out = {"cell": args.workload, "seed": args.seed, "torch": torch.__version__,
           "card": power_limit(), **probe(cell, args.seed, device),
           "seconds": time.perf_counter() - t}
    text = json.dumps(out, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
