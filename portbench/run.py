"""Run one cell of the port's benchmark once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones), `device`
(with `--trace 1` also `busy_s` and `window_s`), with `--trace 1`
`breakdown`, and last `checks`, each number compared beside its limit;
the same comparisons end standard error. The run exits non-zero and
prints no result without enough CUDA devices, or if the process holds a
JAX module once the window has closed.

Every cache the run writes stays in the checkout, at fixed paths under
`portbench/.cache/`: Python's bytecode (so that only the first run in a
checkout compiles torch's modules), and the caches of nvcc, Triton and
torch extensions; the port builds its kernels into
`f_lite_tpu_torch/csrc/build/`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "portbench" / ".cache"
# top-level modules the measured process may not hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "f_lite_tpu")


def process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat[stat.rindex(")") + 2:].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def prepare_environment() -> None:
    """Fixed cache directories inside the checkout, set before torch loads;
    libraries kept from loading JAX on their own."""
    for env, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[env] = str(CACHE / sub)
    for env in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[env] = "0"
    sys.pycache_prefix = str(CACHE / "pycache")
    sys.dont_write_bytecode = False


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class RunContext:
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    control: dict | None = None  # the control's settings (portbench.control)
    requests: int | None = None  # serve exactly this many instead of a timed window
    steps: int | None = None     # train exactly this many window steps


def run_cell(cell, ctx: RunContext) -> dict:
    """The driver's record of one run, with `correct` and the checks."""
    from portbench import checks, registry

    record = registry.driver(cell.traffic["driver"]).run(ctx)
    record["correct"], record["checks"] = checks.judge(record["numbers"], cell.limits)
    return record


def result(cell, record: dict, trace: bool, device) -> dict:
    """The printed result of a run's record."""
    from portbench import registry

    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": record["e2e"][m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = registry.metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": device_kind(device), "count": cell.chips,
           "memory_peak_bytes": record["memory_peak_bytes"]}
    out = {"correct": record["correct"], "attempted": record["attempted"],
           "failed": record["failed"], "metrics": metrics, "device": dev}
    if trace and "profile" in record:
        prof = record["profile"]
        dev["busy_s"], dev["window_s"] = prof["busy_s"], prof["window_s"]
        out["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    out["checks"] = record["checks"]
    return out


def device_kind(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def power_limit() -> str | None:
    """The card's name and power limit by nvidia-smi, where it answers."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def main(argv=None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    prepare_environment()

    import torch

    from portbench import registry

    cell = registry.cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), "
              f"found {found}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = RunContext(cell.config, cell.traffic, args.seed, args.seconds, bool(args.trace),
                     device, t_start)
    record = run_cell(cell, ctx)
    out = result(cell, record, bool(args.trace), device)
    out["device"]["card"] = power_limit()
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process holds {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
