"""Everything a cell needs, found by the names in `BENCHMARK.json`.

- a configuration: the file its entry of `configs` names
  (`portbench/configs/<config>.json`);
- a traffic mix: `portbench/traffic/<traffic>.json`, whose "driver" names
  `portbench/drivers/<driver>.py`;
- the limits of the cell's comparison: `portbench/limits/<cell>.json`;
- a per-layer metric: `portbench/metrics/<metric>.py`, whose `read(record)`
  returns the number or None.
A new configuration, mix, driver, cell or metric is a new file and a new
entry; no file that exists changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


def _load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def benchmark(root: Path = ROOT) -> dict:
    return _load_json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        names = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: {names})")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(name=name, chips=entry["chips"],
                config=_load_json(root / conf["file"]),
                traffic=_load_json(root / "portbench" / "traffic" / f"{entry['traffic']}.json"),
                limits=_load_json(root / "portbench" / "limits" / f"{name}.json"),
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: Path = ROOT):
    return _module(root / "portbench" / "drivers" / f"{name}.py")


def metric_reader(name: str, root: Path = ROOT):
    """`read(record) -> float | None` of per-layer metric `name`."""
    return _module(root / "portbench" / "metrics" / f"{name}.py").read
