"""BENCHMARK.json and the files it names: every cell resolves its
configuration, mix, limits, driver and metrics by name; names and units
keep to the benchmark's character rules; a new configuration, mix or
metric is found as a new file and entry, no existing file edited."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import registry

ROOT = registry.ROOT
BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = registry.cell(cell)
    assert c.traffic["driver"] in ("serve", "train")
    assert hasattr(registry.driver(c.traffic["driver"]), "run")
    assert c.limits and all(v.get("limit") is not None for v in c.limits.values())
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(registry.metric_reader(m["name"]))
        assert m["moves"] in names


def test_names_units_and_entries():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert set(c["reduced"]) == set(json.loads((ROOT / c["file"]).read_text())["reduced"])


def test_roofline_and_mfu_metrics_are_shares():
    for m in BENCH["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"


def test_new_files_are_found_without_editing(tmp_path):
    """A later change adds a configuration, a mix, limits, a metric and a
    cell as new files and entries: the harness finds them by name."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    conf = json.loads((ROOT / "portbench/configs/f_lite_7b.json").read_text())
    conf.update(name="f_lite_7b_wide", hidden_size=3072, num_heads=12)
    (root / "portbench/configs/f_lite_7b_wide.json").write_text(json.dumps(conf))
    mix = json.loads((ROOT / "portbench/traffic/t2i_1024.json").read_text())
    (root / "portbench/traffic/t2i_768.json").write_text(json.dumps(dict(mix, height=768,
                                                                          width=768)))
    (root / "portbench/limits/f_lite_7b_wide.t2i_768.json").write_text(
        (ROOT / "portbench/limits/f_lite_7b.t2i_1024.json").read_text())
    (root / "portbench/metrics/steps_served.py").write_text(
        "def read(record):\n    return float(record['model']['traffic']['steps'])\n")
    bench["configs"].append({"name": "f_lite_7b_wide", "source": "https://example.org/x",
                             "file": "portbench/configs/f_lite_7b_wide.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "f_lite_7b_wide.t2i_768", "config": "f_lite_7b_wide",
                               "traffic": "t2i_768", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "steps_served", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "a test",
                               "moves": "image_s", "workloads": ["f_lite_7b_wide.t2i_768"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = registry.cell("f_lite_7b_wide.t2i_768", root=root)
    assert cell.config["hidden_size"] == 3072 and cell.traffic["height"] == 768
    assert [m["name"] for m in cell.per_layer][-1] == "steps_served"
    reader = registry.metric_reader("steps_served", root=root)
    assert reader({"model": {"traffic": cell.traffic}}) == 30.0
    assert all(p.read_bytes() == b for p, b in before.items())


def test_run_seconds_fits_a_full_check():
    """2 + 14 runs a cell, each run_seconds + 60 s, 180 s a cell to
    compile and 1200 s spare, for 24 cells, within 43200 s."""
    cells = 24
    total = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 180 + 1200
    assert total <= 43200, total
