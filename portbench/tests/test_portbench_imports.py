"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name (`f_lite_tpu_torch` begins with `f_lite_tpu`),
and the reference loads nothing of the measured program."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from portbench import registry
from portbench.run import FORBIDDEN

ROOT = registry.ROOT
REFERENCE = ROOT / "portbench" / "reference"


def _modules_after(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport json, sys\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """A tiny cell's whole run (set-up, window, check, metrics) in a fresh
    process, as `portbench.run` drives it."""
    mods = _modules_after(
        "import torch\n"
        "from portbench import run\n"
        "from portbench.tests.conftest import tiny_cell, tiny_run\n"
        "for name in ('f_lite_7b.t2i_1024', 'f_lite_7b.train_512'):\n"
        "    cell = tiny_cell(name)\n"
        "    run.result(cell, tiny_run(cell, trace=True), True, torch.device('cpu'))\n")
    assert "f_lite_tpu_torch" in mods
    assert not mods & set(FORBIDDEN), mods & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules_after("import portbench.reference.dit, portbench.reference.vae, "
                          "portbench.reference.sampler, portbench.reference.train")
    assert not mods & ({"f_lite_tpu_torch"} | set(FORBIDDEN))
    for path in [*REFERENCE.glob("*.py"), ROOT / "portbench" / "weights.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] in ("torch", "math", "__future__", "portbench"), (path, n)
                assert not n.startswith("portbench.") or n.split(".")[1] in (
                    "reference", "weights"), (path, n)
