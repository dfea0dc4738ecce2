"""Local checkpoint ingest in the port against the JAX package, on the CPU:
`convert/manifest.py`, `convert/ingest.py` and `from_pretrained` of a
diffusers-layout snapshot.

The snapshot is the one of `tests/test_ingest.py`: a reference state dict
(`torch_oracle.make_random_state_dict`) converted and exported back to the
reference's layout by the JAX package's own tool
(`tools/convert_checkpoint.py --export_torch`), here with a tiny VAE, a
`text_encoder/` and a `tokenizer/` as well.

- Manifests: the port's copies are byte-equal to the JAX package's, and
  `expected_torch_keys(cfg)` is the key set of the port's `DiT(cfg)`.
- Conversion: from the same `.pt` and the same snapshot the port writes the
  JAX package's native directory, tensor for tensor bit for bit, with equal
  `config.json`s and `model_index.json`.
- Cache: the cases of `tests/test_ingest.py`'s `TestDetection` and
  `TestDiffusersDirLoading` on the port, and a cache either package wrote
  is taken by the other.
- Strict ingest: the cases of `tests/test_manifest.py`'s
  `TestStrictIngestEnd2End`.
"""

import json
import logging
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load_file

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

from f_lite_tpu.convert import ingest as jingest
from f_lite_tpu.convert import manifest as jmanifest
from f_lite_tpu.models import vae as jvae
from f_lite_tpu.models.dit import DiTConfig as JaxDiTConfig
from f_lite_tpu.pipeline import save_params_safetensors
from f_lite_tpu_torch.convert import ingest, manifest
from f_lite_tpu_torch.models.dit import DiT, DiTConfig
from f_lite_tpu_torch.pipeline import FLitePipeline
from torch_oracle import make_random_state_dict

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(in_channels=16, patch_size=2, hidden_size=64, depth=3, num_heads=4,
           mlp_ratio=2.0, cross_attn_input_size=48, residual_v=True)
ARCH = dict(width=64, head_dim=16, mlp_ratio=2.0, cross_attn_input_size=48)


# ---------------------------------------------------------------------------
# manifests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(p.name for p in jmanifest.MANIFEST_DIR.glob("*.json")))
def test_manifests_are_byte_equal_copies(name):
    assert (manifest.MANIFEST_DIR / name).read_bytes() == \
        (jmanifest.MANIFEST_DIR / name).read_bytes()


MANIFEST_TINY = dict(in_channels=16, patch_size=2, hidden_size=64, depth=9,
                     num_heads=4, mlp_ratio=2.0, cross_attn_input_size=48)
KEY_CONFIGS = {
    "plain": dict(),
    "bias_rms": dict(train_bias_and_rms=True),
    "no_rope": dict(use_rope=False),
    "bias_rms_no_rope": dict(train_bias_and_rms=True, use_rope=False),
    "residual_v": dict(residual_v=True),
    "v2_per_block": dict(adaln_mode="per_block", cross_attn_all=True),
    **{f"released_{r.split('/')[1]}": dict(depth=40, residual_v=True)
       for r in sorted(manifest.REPO_MANIFESTS)},
}


@pytest.mark.parametrize("name", list(KEY_CONFIGS))
def test_expected_keys_are_the_dit_state_dict(name):
    kw = {**MANIFEST_TINY, **KEY_CONFIGS[name]}
    cfg = DiTConfig(**kw)
    with torch.device("meta"):
        keys = set(DiT(cfg).state_dict())
    assert manifest.expected_torch_keys(cfg) == keys
    assert jmanifest.expected_torch_keys(JaxDiTConfig(**kw)) == keys
    if name.startswith("released_"):
        repo = next(r for r in manifest.REPO_MANIFESTS if r.endswith(name[9:]))
        assert keys == set(manifest.manifest_for_repo(repo)["keys"])


def test_manifest_functions_agree_with_the_jax_package(monkeypatch, caplog):
    for repo in manifest.REPO_MANIFESTS:
        assert manifest.manifest_for_repo(repo) == jmanifest.build_manifest(repo)
    keys = manifest.manifest_for_repo("Freepik/F-Lite-7B")["keys"]
    assert manifest.match_manifest(keys)[0] == jmanifest.match_manifest(keys)[0]
    assert manifest.match_manifest(["x.weight"]) is None
    present = (set(keys) - {"blocks.3.norm1.weight"}) | {"blocks.3.unexpected"}
    m = manifest.manifest_for_repo("Freepik/F-Lite")
    assert manifest.validate_against_manifest(present, m) == \
        jmanifest.validate_against_manifest(present, m) == \
        (["blocks.3.norm1.weight"], ["blocks.3.unexpected"])

    cfg = DiTConfig(**CFG)
    sd = set(manifest.expected_torch_keys(cfg))
    report = manifest.coverage_report(sd | {"extra.weight"}, sd, cfg)
    assert report.unconsumed == ["extra.weight"] and not report.missing
    assert report.render("src") == jmanifest.coverage_report(
        sd | {"extra.weight"}, sd, JaxDiTConfig(**CFG)).render("src")
    with pytest.raises(manifest.KeyCoverageError, match="extra.weight"):
        manifest.check_coverage(sd | {"extra.weight"}, sd, cfg, mode="error")
    with caplog.at_level(logging.WARNING):
        manifest.check_coverage(sd | {"extra.weight"}, sd, cfg, mode="warn",
                                logger=logging.getLogger("test_torch_ingest"))
    assert "extra.weight" in caplog.text
    assert manifest.check_coverage(sd, sd, cfg, mode="error").clean
    monkeypatch.setenv("F_LITE_STRICT_INGEST", "off")
    assert manifest.strict_mode() == jmanifest.strict_mode() == "off"
    assert manifest.strict_mode("error") == "error"
    monkeypatch.setenv("F_LITE_STRICT_INGEST", "loud")
    for module in (manifest, jmanifest):
        with pytest.raises(ValueError, match="off|warn|error"):
            module.strict_mode()


# ---------------------------------------------------------------------------
# the golden snapshot
# ---------------------------------------------------------------------------

def _reference_sd(seed=5):
    return {k: v.numpy() for k, v in
            make_random_state_dict(JaxDiTConfig(**CFG), seed=seed).items()}


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """{"pt": the reference `.pt`, "hf": a diffusers-layout snapshot with
    dit_model/, vae/, text_encoder/ and tokenizer/}."""
    from convert_checkpoint import main as convert_main

    tmp = tmp_path_factory.mktemp("golden")
    torch.save({k: torch.from_numpy(v) for k, v in _reference_sd().items()},
               tmp / "model.pt")
    native = convert_main(["--pt", str(tmp / "model.pt"), "--head_dim", "16",
                           "--output_dir", str(tmp / "native")])
    vcfg = jvae.VAEConfig.tiny(latent_channels=16)
    vparams = jvae.AutoencoderKL(vcfg).init(jax.random.key(4), jnp.zeros((1, 8, 8, 3)))
    (native / "vae").mkdir()
    (native / "vae" / "config.json").write_text(json.dumps(
        {**{k: v for k, v in vcfg.__dict__.items() if k not in ("dtype", "param_dtype")},
         "block_out_channels": list(vcfg.block_out_channels)}))
    save_params_safetensors(vparams["params"], native / "vae" / "flax_params.safetensors")
    for sub, cfg in (("text_encoder", {"model_type": "t5"}),
                     ("tokenizer", {"tokenizer_class": "T5Tokenizer"})):
        (native / sub).mkdir()
        (native / sub / ("config.json" if sub == "text_encoder"
                         else "tokenizer_config.json")).write_text(json.dumps(cfg))
    hf = convert_main(["--export_torch", str(native), "--output_dir",
                       str(tmp / "hf_snapshot")])
    assert (hf / "vae" / "diffusion_pytorch_model.safetensors").exists()
    return {"pt": tmp / "model.pt", "hf": hf}


@pytest.fixture
def hf_dir(golden, tmp_path):
    """A per-test mutable copy of the snapshot."""
    dst = tmp_path / "snapshot"
    shutil.copytree(golden["hf"], dst)
    return dst


def _native_files(path: Path) -> tuple[dict, dict]:
    tensors, jsons = {}, {}
    for f in sorted(path.rglob("*")):
        rel = str(f.relative_to(path))
        if f.suffix == ".safetensors":
            tensors.update({f"{rel}:{k}": v for k, v in st_load_file(str(f)).items()})
        elif f.suffix == ".json":
            jsons[rel] = json.loads(f.read_text())
    return tensors, jsons


def _assert_same_native(a: Path, b: Path):
    (ta, ja), (tb, jb) = _native_files(a), _native_files(b)
    assert ja == jb
    assert set(ta) == set(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and ta[k].shape == tb[k].shape, k
        assert ta[k].tobytes() == tb[k].tobytes(), k


@pytest.mark.parametrize("source", ["pt", "hf"])
def test_conversion_writes_the_jax_packages_native_dir(golden, tmp_path, source):
    kw = dict(pt=golden["pt"], **ARCH) if source == "pt" else dict(hf_dir=golden["hf"])
    port = ingest.convert_reference_checkpoint(tmp_path / "port", **kw)
    want = jingest.convert_reference_checkpoint(tmp_path / "jax", **kw)
    _assert_same_native(port, want)
    assert (port / "vae").exists() == (source == "hf")
    if source == "hf":
        index = json.loads((port / "model_index.json").read_text())
        assert index["text_encoder_type"] == "t5"
        assert (port / "tokenizer" / "tokenizer_config.json").exists()


def test_snapshot_loads_as_the_native_dir_it_converts_to(hf_dir, tmp_path):
    native = jingest.convert_reference_checkpoint(tmp_path / "native", hf_dir=hf_dir)
    latents = np.random.RandomState(3).randn(1, 8, 8, 16).astype(np.float32)
    kw = dict(prompt_embeds=np.random.RandomState(4).randn(1, 6, 48).astype(np.float32),
              latents=latents, num_inference_steps=2, output_type="np")

    def images(path):
        return FLitePipeline.from_pretrained(path, dtype=torch.float32, device="cpu",
                                             load_text_encoder=False)(**kw).images

    want = images(native)
    np.testing.assert_array_equal(images(hf_dir), want)
    np.testing.assert_array_equal(images(hf_dir), want)  # from the cache
    assert want.shape == (1, 16, 16, 3) and np.isfinite(want).all()

    # a snapshot whose DiT is a reference `.pt` file loads too
    pt_snap = tmp_path / "pt_snapshot"
    (pt_snap / "dit_model").mkdir(parents=True)
    shutil.copy(hf_dir / "dit_model" / "config.json", pt_snap / "dit_model")
    shutil.copytree(hf_dir / "vae", pt_snap / "vae")
    torch.save({k: torch.from_numpy(v) for k, v in _reference_sd().items()},
               pt_snap / "dit_model" / "model.pt")
    np.testing.assert_array_equal(images(pt_snap), want)


# ---------------------------------------------------------------------------
# tests/test_ingest.py TestDetection and TestDiffusersDirLoading, on the port
# ---------------------------------------------------------------------------

def test_detect_layout(hf_dir, tmp_path):
    assert ingest.detect_layout(hf_dir) == "diffusers"
    native = ingest.resolve_pretrained(hf_dir)
    assert ingest.detect_layout(native) == "native"
    empty = tmp_path / "empty"
    empty.mkdir()
    assert ingest.detect_layout(empty) is None
    assert ingest.detect_layout(tmp_path / "missing") is None


def test_looks_like_repo_id(tmp_path):
    for model in ("Freepik/F-Lite", "Freepik/F-Lite-Texture", "./rel/path",
                  "no-slash", str(tmp_path), "/nonexistent/dir"):
        assert ingest.looks_like_repo_id(model) == jingest.looks_like_repo_id(model)
    assert ingest.looks_like_repo_id("Freepik/F-Lite")
    assert not ingest.looks_like_repo_id(str(tmp_path))


def test_from_pretrained_diffusers_dir(hf_dir):
    pipe = FLitePipeline.from_pretrained(hf_dir, dtype=torch.float32, device="cpu",
                                         load_text_encoder=False)
    lat = pipe(prompt_embeds=np.zeros((1, 8, 48), np.float32), height=16, width=16,
               num_inference_steps=2, return_latents=True).images
    assert tuple(lat.shape) == (1, 8, 8, 16) and torch.isfinite(lat).all()
    cache = hf_dir / "f_lite_tpu_converted"
    assert (cache / "dit" / "flax_params.safetensors").exists()
    assert (cache / "source_fingerprint.json").exists()


def _stamp(path: Path) -> int:
    return (path / "dit" / "flax_params.safetensors").stat().st_mtime_ns


def test_cache_reuse(hf_dir):
    first = ingest.resolve_pretrained(hf_dir)
    stamp = _stamp(first)
    assert ingest.resolve_pretrained(hf_dir) == first and _stamp(first) == stamp


def test_cache_invalidation_on_source_change(hf_dir):
    first = ingest.resolve_pretrained(hf_dir)
    stamp = _stamp(first)
    w = hf_dir / "dit_model" / "diffusion_pytorch_model.safetensors"
    st = w.stat()
    os.utime(w, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    second = ingest.resolve_pretrained(hf_dir)
    assert second == first and _stamp(second) != stamp


def test_native_dir_passthrough(hf_dir):
    native = ingest.resolve_pretrained(hf_dir)
    assert ingest.resolve_pretrained(native) == native


@pytest.mark.parametrize("first", ["jax", "port"])
def test_a_cache_either_package_wrote_is_valid_for_the_other(hf_dir, first):
    a, b = (jingest, ingest) if first == "jax" else (ingest, jingest)
    cache = a.resolve_pretrained(hf_dir)
    stamp = _stamp(cache)
    assert b.resolve_pretrained(hf_dir) == cache and _stamp(cache) == stamp


def test_concurrent_first_use_converters_converge(hf_dir):
    code = ("import sys; from f_lite_tpu_torch.convert.ingest import "
            "resolve_pretrained, detect_layout; p = resolve_pretrained(sys.argv[1]); "
            "print(p, detect_layout(p))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(hf_dir)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    results = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), results
    lines = {out.strip() for out, _ in results}
    assert len(lines) == 1 and next(iter(lines)).endswith(" native"), results
    cache = Path(next(iter(lines)).rsplit(" ", 1)[0])
    debris = [d.name for d in cache.parent.iterdir()
              if ".tmp-" in d.name or ".stale-" in d.name]
    assert not debris, debris


def test_readonly_snapshot_falls_back_to_user_cache(hf_dir, tmp_path, monkeypatch):
    cache_root = tmp_path / "usercache"
    monkeypatch.setenv("F_LITE_TPU_CACHE", str(cache_root))
    # the tests may run as root, for whom os.access(W_OK) is always true
    monkeypatch.setattr(ingest.os, "access", lambda *a, **k: False)
    out = ingest.resolve_pretrained(hf_dir)
    assert cache_root in out.parents
    assert ingest.detect_layout(out) == "native"
    assert out == jingest._cache_dir_for(hf_dir)


def test_unrecognizable_dir_raises(tmp_path):
    bogus = tmp_path / "bogus"
    bogus.mkdir()
    (bogus / "README.md").write_text("not a checkpoint")
    with pytest.raises(FileNotFoundError, match="neither"):
        ingest.resolve_pretrained(bogus)


def test_missing_path_raises():
    with pytest.raises(FileNotFoundError, match="repo id"):
        ingest.resolve_pretrained("/nonexistent/checkpoint/dir")


def test_hub_id_raises_with_the_local_snapshot_advice():
    with pytest.raises(FileNotFoundError, match="local directory"):
        ingest.resolve_pretrained("Freepik/F-Lite")
    with pytest.raises(FileNotFoundError, match="local directory"):
        FLitePipeline.from_pretrained("Freepik/F-Lite", device="cpu")


# ---------------------------------------------------------------------------
# tests/test_manifest.py TestStrictIngestEnd2End (and the missing key), on
# the port
# ---------------------------------------------------------------------------

def _stray_pt(tmp_path, drop=None):
    sd = {k: torch.from_numpy(v) for k, v in _reference_sd(seed=3).items()}
    sd["stray.weight"] = torch.zeros(4)
    if drop:
        del sd[drop], sd["stray.weight"]
    torch.save(sd, tmp_path / "model.pt")
    return tmp_path / "model.pt"


def test_warn_by_default_still_converts(tmp_path, caplog, monkeypatch):
    monkeypatch.delenv("F_LITE_STRICT_INGEST", raising=False)
    with caplog.at_level(logging.WARNING):
        out = ingest.convert_reference_checkpoint(tmp_path / "out", pt=_stray_pt(tmp_path),
                                                  **ARCH)
    assert (out / "dit" / "flax_params.safetensors").exists()
    assert "stray.weight" in caplog.text


def test_error_mode_rejects_stray_key(tmp_path):
    with pytest.raises(manifest.KeyCoverageError, match="stray.weight"):
        ingest.convert_reference_checkpoint(tmp_path / "out", pt=_stray_pt(tmp_path),
                                            strict="error", **ARCH)


def test_missing_key_fails_legibly(tmp_path):
    pt = _stray_pt(tmp_path, drop="blocks.1.mlp.gate_proj.weight")
    with pytest.raises(manifest.KeyCoverageError, match=r"blocks\.1\.mlp\.gate_proj\.weight"):
        ingest.convert_reference_checkpoint(tmp_path / "out", pt=pt, **ARCH)
