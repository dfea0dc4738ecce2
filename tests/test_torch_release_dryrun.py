"""The port's fabricated-release dry run
(`f_lite_tpu_torch.tools.fabricated_release_dryrun`) against the JAX tool
(`tools/fabricated_release_dryrun.py`), on the CPU, at a tiny manifest
(hidden 512, depth 3, 2 heads of 256, residual_v; its keys from the JAX
package's `convert/manifest.py`) beside the full-size Flux VAE both tools
fabricate. The released layout has no `dit_model/config.json`, so ingest
reads the head count as width / 256, the releases' head dim.

- Fabricate: the port's CPU draws are the JAX tool's bit for bit, in each
  file with the same keys, and `model_index.json` and `vae/config.json`
  are equal; the shipped manifests (7B, 10B, texture) are the key sets of
  the port's meta-device DiT, found without a draw; a manifest with a key
  too many or too few stops both tools with the same message.
- Ingest: an extra key fails strict ingest in both packages; both
  packages' strict conversions of the snapshot are bit-equal, and the
  converted release renders in fp32 through each package's pipeline
  within MSE 1e-9.
- `main` end to end on the CPU: the JAX tool's report keys, the reuse of
  the snapshot and its cache, `--convert_only`, the int8 load equal to
  `quantize_dit` of the bf16 one bit for bit, `F_LITE_STRICT_INGEST`
  given back, and the JAX package's committed report left alone.
"""

import hashlib
import json
import os
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import fabricated_release_dryrun as jtool  # noqa: E402

from f_lite_tpu.convert import ingest as jingest  # noqa: E402
from f_lite_tpu.convert import manifest as jmanifest  # noqa: E402
from f_lite_tpu.models.dit import DiTConfig as JaxDiTConfig  # noqa: E402
from f_lite_tpu.pipeline import FLitePipeline as JaxPipeline  # noqa: E402
from f_lite_tpu_torch.convert import ingest, manifest  # noqa: E402
from f_lite_tpu_torch.models.dit import DiT  # noqa: E402
from f_lite_tpu_torch.pipeline import FLitePipeline  # noqa: E402
from f_lite_tpu_torch.quant import quantize_dit  # noqa: E402
from f_lite_tpu_torch.tools import fabricated_release_dryrun as tool  # noqa: E402
from f_lite_tpu_torch.utils.image import read_png  # noqa: E402
from f_lite_tpu_torch.utils.safetensors import load_file, read_header, save_file  # noqa: E402

TINY = dict(hidden_size=512, depth=3, num_heads=2, cross_attn_input_size=64,
            residual_v=True, train_bias_and_rms=False)
SEED = 3
FILES = ("dit_model/diffusion_pytorch_model.safetensors",
         "vae/diffusion_pytorch_model.safetensors")


def tiny_manifest() -> dict:
    return {"repo_id": "tiny/F-Lite-tiny", "config": dict(TINY),
            "keys": sorted(jmanifest.expected_torch_keys(JaxDiTConfig(**TINY)))}


def _sha(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_main_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    mdir = tmp_path / "manifests"
    mdir.mkdir()
    (mdir / "tiny.json").write_text(json.dumps(tiny_manifest()))
    monkeypatch.setattr(tool, "MANIFEST_DIR", mdir)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("F_LITE_STRICT_INGEST", "warn")
    committed = ROOT / "FABRICATED_RELEASE_DRYRUN.json"
    committed_sha = _sha(committed)
    assert tool.DEFAULT_OUT != committed.name
    assert tool.SAMPLE_PNG != "fabricated_release_sample.png"
    work = tmp_path / "work"
    argv = ["--manifest", "tiny", "--workdir", str(work), "--device", "cpu",
            "--size", "64", "--steps", "2", "--repeats", "2"]

    def no_load(*a, **k):
        raise AssertionError("--convert_only loaded the pipeline")

    with monkeypatch.context() as m:
        m.setattr(FLitePipeline, "from_pretrained", no_load)
        partial = tool.main(argv + ["--convert_only"])
    assert {"manifest", "repo_id", "config", "strict_ingest", "dit_params", "dit_keys",
            "fabricate_seconds", "convert_seconds", "status"} <= set(partial)
    assert partial["status"].startswith("converted")
    assert json.loads((tmp_path / tool.DEFAULT_OUT).read_text()) == partial
    native = work / "snapshot" / "f_lite_tpu_converted"
    stamp = (native / "dit" / "flax_params.safetensors").stat().st_mtime_ns
    assert os.environ["F_LITE_STRICT_INGEST"] == "warn"

    report = tool.main(argv + ["--keep"])
    assert "fabricate_seconds" not in report  # the snapshot was reused
    assert (native / "dit" / "flax_params.safetensors").stat().st_mtime_ns == stamp
    assert {"manifest", "repo_id", "config", "strict_ingest", "convert_seconds",
            "load_seconds", "compile_plus_first_s", "p50_seconds_per_image",
            "sample_png", "hbm", "status"} <= set(report)
    assert report["status"] == "ok" and report["finite"]
    assert len(report["seconds_per_image"]) == 2
    assert report["p50_seconds_per_image"] == report["seconds_per_image"][1]
    png = Path(report["sample_png"])
    assert png == tmp_path / tool.SAMPLE_PNG
    assert read_png(png.read_bytes()).shape == (64, 64, 3)
    assert os.environ["F_LITE_STRICT_INGEST"] == "warn"

    int8 = FLitePipeline.from_pretrained(native, dtype=torch.bfloat16, quantize=True,
                                         device="cpu", load_text_encoder=False).dit
    bf16 = quantize_dit(FLitePipeline.from_pretrained(
        native, dtype=torch.bfloat16, device="cpu", load_text_encoder=False).dit)
    a, b = int8.state_dict(), bf16.state_dict()
    assert set(a) == set(b) and any(v.dtype == torch.int8 for v in a.values())
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert _sha(committed) == committed_sha
    shutil.rmtree(work)


def test_the_tool_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--manifest", "freepik-f-lite-7b", "--workdir", str(tmp_path / "w")])
    assert not (tmp_path / "w").exists()


# each fabricated snapshot holds the Flux VAE at full size (336 MB), so the
# tests remove their files when done


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """The tiny manifest fabricated by each tool on the CPU, seed 3."""
    tmp = tmp_path_factory.mktemp("release")
    jtool.fabricate_snapshot(tiny_manifest(), tmp / "jax", SEED)
    report = tool.fabricate_snapshot(tiny_manifest(), tmp / "port", SEED, "cpu")
    yield {"jax": tmp / "jax", "port": tmp / "port", "report": report}
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture(scope="module")
def converted(snapshots, tmp_path_factory):
    """The port's snapshot converted strictly by each package: the port's
    through the tool (`resolve_pretrained`, its cache beside the
    snapshot), the JAX package's by the conversion its `resolve_pretrained`
    runs, in error mode, to a dir of its own (the packages share the
    cache's place and format, so JAX's resolve would take the port's)."""
    tmp = tmp_path_factory.mktemp("converted")
    port, _ = tool.convert(snapshots["port"])
    jax_dir = jingest.convert_reference_checkpoint(tmp / "jax", hf_dir=snapshots["port"],
                                                   strict="error")
    yield {"port": port, "jax": jax_dir}
    shutil.rmtree(tmp, ignore_errors=True)


def test_fabricated_snapshot_is_the_jax_tools_bit_for_bit(snapshots):
    for f in FILES:
        want = load_file(snapshots["jax"] / f)
        got = load_file(snapshots["port"] / f)
        assert list(read_header(snapshots["port"] / f)[0]) == sorted(want)
        assert set(got) == set(want), f
        for k in want:
            assert got[k].dtype == want[k].dtype == np.float32, k
            assert got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k
    for f in ("model_index.json", "vae/config.json"):
        assert json.loads((snapshots["port"] / f).read_text()) == \
            json.loads((snapshots["jax"] / f).read_text()), f
    report = snapshots["report"]
    assert report["dit_keys"] == len(tiny_manifest()["keys"])
    assert report["dit_params"] == sum(
        v.size for v in load_file(snapshots["port"] / FILES[0]).values())


@pytest.mark.parametrize("name", sorted(manifest.REPO_MANIFESTS.values()))
def test_shipped_manifests_are_the_meta_models_keys_without_a_draw(name, monkeypatch):
    m = json.loads((tool.MANIFEST_DIR / name).read_text())

    def no_draw(*a, **k):
        raise AssertionError("a draw")

    monkeypatch.setattr(torch, "randn", no_draw)
    monkeypatch.setattr(torch, "rand", no_draw)
    dit_shapes, vae_shapes = tool.snapshot_shapes(m)
    with torch.device("meta"):
        meta = DiT(tool.dit_config(m)).state_dict()
    assert set(dit_shapes) == set(meta) == set(m["keys"])
    assert len(dit_shapes) == 399 and len(vae_shapes) == 244
    assert all(tuple(meta[k].shape) == s for k, s in dit_shapes.items())
    if name == "freepik-f-lite-7b.json":
        assert sum(int(np.prod(s)) for s in dit_shapes.values()) == 4_749_401_703


@pytest.mark.parametrize("case", ["key_too_many", "key_too_few"])
def test_an_off_manifest_stops_both_tools_alike(case, tmp_path):
    m = tiny_manifest()
    if case == "key_too_many":
        m["keys"] = sorted(m["keys"] + ["blocks.0.self_attn.extra.weight"])
    else:
        m["keys"] = m["keys"][1:]
    with pytest.raises(SystemExit) as want:
        jtool.fabricate_snapshot(m, tmp_path / "jax", SEED)
    with pytest.raises(SystemExit) as got:
        tool.fabricate_snapshot(m, tmp_path / "port", SEED, "cpu")
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("fabricated key set diverges from manifest")
    assert not (tmp_path / "port").exists()


def test_an_extra_key_fails_strict_ingest_in_both_packages(snapshots, tmp_path, monkeypatch):
    # the DiT is converted, and fails, before the VAE: copies without vae/
    sd = load_file(snapshots["port"] / FILES[0])
    sd["blocks.0.self_attn.stray.weight"] = np.ones((4, 4), np.float32)
    for name in ("port", "jax", "tool"):
        (tmp_path / name / "dit_model").mkdir(parents=True)
        shutil.copy(snapshots["port"] / "model_index.json", tmp_path / name)
        save_file(sd, tmp_path / name / FILES[0])
    with pytest.raises(manifest.KeyCoverageError, match="stray"):
        tool.convert(tmp_path / "tool")
    monkeypatch.setenv("F_LITE_STRICT_INGEST", "error")
    with pytest.raises(manifest.KeyCoverageError, match="stray"):
        ingest.resolve_pretrained(tmp_path / "port")
    with pytest.raises(jmanifest.KeyCoverageError, match="stray"):
        jingest.resolve_pretrained(tmp_path / "jax")
    shutil.rmtree(tmp_path)


def test_strict_ingests_of_both_packages_are_bit_equal(converted):
    for sub in ("dit", "vae"):
        want = load_file(converted["jax"] / sub / "flax_params.safetensors")
        got = load_file(converted["port"] / sub / "flax_params.safetensors")
        assert set(got) == set(want), sub
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k
    for f in ("dit/config.json", "vae/config.json", "model_index.json"):
        assert json.loads((converted["port"] / f).read_text()) == \
            json.loads((converted["jax"] / f).read_text()), f


def test_the_converted_release_renders_as_the_jax_pipeline(converted):
    embeds = tool.release_embeds(SEED, TINY["cross_attn_input_size"])
    latents = np.random.RandomState(4).randn(1, 8, 8, 16).astype(np.float32)
    kw = dict(prompt_embeds=embeds, num_inference_steps=2, guidance_scale=6.0,
              height=64, width=64, output_type="np")
    want = np.asarray(JaxPipeline.from_pretrained(
        converted["jax"], dtype=jnp.float32, load_text_encoder=False)(
        **kw, latents=jnp.asarray(latents)).images)
    got = FLitePipeline.from_pretrained(
        converted["port"], dtype=torch.float32, device="cpu",
        load_text_encoder=False)(**kw, latents=latents).images
    assert got.shape == want.shape == (1, 64, 64, 3) and np.isfinite(got).all()
    mse = float(((got - want) ** 2).mean())
    assert mse < 1e-9, mse
