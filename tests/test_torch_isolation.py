"""The port stands alone: with `jax`, `flax`, `optax` and `f_lite_tpu`
blocked by an import hook, every module of `f_lite_tpu_torch` (the training
path's included) and `chip_smoke.py` import (and do no work at import
time), and the entry points' default device is the card: without one,
`from_pretrained` and the trainer raise instead of falling back."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

BLOCKED_IMPORTS = textwrap.dedent("""
    import importlib, importlib.abc, importlib.util, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "f_lite_tpu")

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
    print(" ".join(names))
    print(len(names), "modules", "built-at-import:", len(built) - BUILT_BEFORE)
""")

TRAINING_MODULES = (
    "f_lite_tpu_torch.train.trainer", "f_lite_tpu_torch.train.__main__",
    "f_lite_tpu_torch.train.loss", "f_lite_tpu_torch.train.optim",
    "f_lite_tpu_torch.train.step", "f_lite_tpu_torch.data.precomputed",
    "f_lite_tpu_torch.data.samplers", "f_lite_tpu_torch.convert.to_jax",
)
LAB_MODULES = ("f_lite_tpu_torch.ops.cuda.flash_variants",
               "f_lite_tpu_torch.tools.flash_variants",
               "f_lite_tpu_torch.tools.forward_tiles",
               "f_lite_tpu_torch.tools.backward_tiles",
               "f_lite_tpu_torch.tools.int8_tiles")


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )


def test_port_imports_without_jax_or_reference_package():
    before = len(list((ROOT / "f_lite_tpu_torch/csrc").glob("build/*.so")))
    out = _run(BLOCKED_IMPORTS.replace("BUILT_BEFORE", str(before)))
    assert out.returncode == 0, out.stderr
    names, summary = out.stdout.strip().splitlines()[-2:]
    assert set(TRAINING_MODULES + LAB_MODULES) <= set(names.split()), names
    n_modules = int(summary.split()[0])
    assert n_modules >= 26, out.stdout
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


def test_trainer_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    _skip_on_a_cuda_host()
    out = subprocess.run(
        [sys.executable, "-m", "f_lite_tpu_torch.train",
         "--use_precomputed_data", "--precomputed_data_dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr, out.stderr


def test_lab_raises_without_a_card():
    _skip_on_a_cuda_host()
    out = subprocess.run([sys.executable, "-m", "f_lite_tpu_torch.tools.flash_variants"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr, out.stderr


@pytest.mark.parametrize("tool", ["forward_tiles", "backward_tiles", "int8_tiles"])
def test_tile_trials_raise_without_a_card(tool):
    _skip_on_a_cuda_host()
    out = subprocess.run([sys.executable, "-m", f"f_lite_tpu_torch.tools.{tool}"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "needs an NVIDIA GPU" in out.stderr, out.stderr
    assert '"tiles"' not in out.stdout


def test_chip_smoke_refuses_to_run_without_a_card():
    _skip_on_a_cuda_host()
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
