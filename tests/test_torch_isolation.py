"""The port stands alone: with `jax`, `flax` and `f_lite_tpu` blocked by an
import hook, every module of `f_lite_tpu_torch` and `chip_smoke.py` import
(and do no work at import time), and the pipeline's default device is the
card: without one, `from_pretrained` raises instead of falling back."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

BLOCKED_IMPORTS = textwrap.dedent("""
    import importlib, importlib.abc, importlib.util, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "f_lite_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import f_lite_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        f_lite_tpu_torch.__path__, "f_lite_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    built = list(__import__("pathlib").Path("f_lite_tpu_torch/csrc").glob("build/*.so"))
    print(len(names), "modules", "built-at-import:", len(built) - BUILT_BEFORE)
""")


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )


def test_port_imports_without_jax_or_reference_package():
    before = len(list((ROOT / "f_lite_tpu_torch/csrc").glob("build/*.so")))
    out = _run(BLOCKED_IMPORTS.replace("BUILT_BEFORE", str(before)))
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 15, out.stdout
    assert out.stdout.strip().endswith("built-at-import: 0"), out.stdout


def _skip_on_a_cuda_host():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")


def test_default_device_is_cuda_and_raises_without_a_card():
    _skip_on_a_cuda_host()
    code = textwrap.dedent("""
        from f_lite_tpu_torch.pipeline import FLitePipeline
        try:
            FLitePipeline.from_pretrained("artifacts/fixture_run/pipeline")
        except RuntimeError as e:
            print("raised:", e)
        else:
            raise SystemExit("loaded on a host without CUDA")
    """)
    out = _run(code)
    assert out.returncode == 0, out.stderr + out.stdout
    assert "no CUDA device" in out.stdout


def test_chip_smoke_refuses_to_run_without_a_card():
    _skip_on_a_cuda_host()
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
