"""The port's repo tools against the JAX package's, run in the same test on
the CPU: `f_lite_tpu_torch.tools.precompute_embeddings` against
`tools/precompute_embeddings.py`, and `f_lite_tpu_torch.tools.
convert_checkpoint` against `tools/convert_checkpoint.py`.

- The cache builder, on one 10-row PNG table (the port's writer; some
  captions repeated) in batches of 4 (a partial last batch), with one
  shared `--vae_path` dir: JAX's per-batch posterior draws
  (`jax.random.split` of `key(--seed)` a batch) are injected into the port
  through `posterior_noise`, since a seed does not carry across packages.
  Latents within 1e-5 x max |ref|, zero-encoder embeddings exact, T5's (fp32
  in both packages, a tiny HF T5 with a word-level tokenizer) within 1e-5 x
  max |ref|; the index and the embedding files equal; each package's
  `PrecomputedDataset` reads the other's cache; the port's trainer takes 2
  steps from the port's cache.
- The converter: `--export_torch` on native dirs the JAX package wrote
  (unrolled, scan-stacked, pipeline-parallel, head-padded; with and
  without `vae/`, `text_encoder/` and `tokenizer/`), `--pt` / `--hf_dir`
  through the architecture flags, and `--export_lora`: every tensor
  bit-equal to the JAX tool's, the JSONs equal; an int8 dir refused by
  both; the port's export re-ingested by the port renders the source's
  fp32 images bit for bit, and by the JAX tool at MSE < 1e-9;
  `--test_image --device cpu` writes its PNG.
"""

import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

from convert_checkpoint import main as jax_convert  # noqa: E402
from precompute_embeddings import main as jax_precompute  # noqa: E402

from f_lite_tpu.data import precomputed as jprecomputed  # noqa: E402
from f_lite_tpu.models.dit import DiT as JaxDiT  # noqa: E402
from f_lite_tpu.models.dit import DiTConfig as JaxDiTConfig  # noqa: E402
from f_lite_tpu.models.vae import VAEConfig as JaxVAEConfig  # noqa: E402
from f_lite_tpu.parallel.pipeline import scan_to_pipeline_params  # noqa: E402
from f_lite_tpu.pipeline import FLitePipeline as JaxPipeline  # noqa: E402
from f_lite_tpu.text import encoder as jenc  # noqa: E402
from f_lite_tpu_torch.convert import from_jax  # noqa: E402
from f_lite_tpu_torch.convert.to_jax import vae_state_dict_to_jax  # noqa: E402
from f_lite_tpu_torch.data import precomputed  # noqa: E402
from f_lite_tpu_torch.models.dit import DiTConfig  # noqa: E402
from f_lite_tpu_torch.models.vae import AutoencoderKL, VAEConfig  # noqa: E402
from f_lite_tpu_torch.pipeline import FLitePipeline  # noqa: E402
from f_lite_tpu_torch.text import encoder as penc  # noqa: E402
from f_lite_tpu_torch.tools import convert_checkpoint as ptool_convert  # noqa: E402
from f_lite_tpu_torch.tools import precompute_embeddings as ptool  # noqa: E402
from f_lite_tpu_torch.train.lora import save_lora_weights  # noqa: E402
from f_lite_tpu_torch.utils.image import png_bytes_with_metadata  # noqa: E402
from f_lite_tpu_torch.utils.safetensors import load_file, save_file  # noqa: E402
from test_torch_dit import random_jax_params, unflatten  # noqa: E402
from torch_oracle import make_random_state_dict  # noqa: E402

CAPTIONS = ["a red circle", "a blue square", "a red circle", "a green triangle",
            "a blue square", "a red circle on the left", "a big green triangle",
            "a red circle", "a small blue square", "a photo of a circle"]
WORDS = sorted({w for c in CAPTIONS for w in c.split()})


def _max_err_bar(got, want, rel=1e-5):
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# the cache builder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """{"table": a JSON table of 10 PNGs (40x32 px), "vae": a seeded tiny
    native `vae/` dir (16 latent channels), "t5": a tiny HF T5 folder (8
    blocks, for `return_index` -8) with a word-level tokenizer}."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast, T5Config, T5EncoderModel

    tmp = tmp_path_factory.mktemp("tool_sources")
    rs = np.random.RandomState(0)
    rows = []
    for i, caption in enumerate(CAPTIONS):
        f = tmp / f"{i}.png"
        f.write_bytes(png_bytes_with_metadata(
            rs.randint(0, 256, (32, 40, 3)).astype(np.uint8)))
        rows.append({"media_path": str(f), "captions": [caption], "width": 40,
                     "height": 32})
    (tmp / "table.json").write_text(json.dumps(rows))

    vae_dir = tmp / "vae"
    vae_dir.mkdir()
    vae = AutoencoderKL(VAEConfig.tiny(latent_channels=16))
    vae.init_weights(torch.Generator().manual_seed(7))
    (vae_dir / "config.json").write_text(json.dumps(vae.config.to_json_dict()))
    save_file(vae_state_dict_to_jax(vae.state_dict(), vae.config),
              vae_dir / "flax_params.safetensors")

    t5_dir = tmp / "t5"
    torch.manual_seed(5)
    T5EncoderModel(T5Config(
        vocab_size=len(WORDS) + 2, d_model=32, d_kv=8, d_ff=64, num_layers=8,
        num_heads=4, relative_attention_num_buckets=8,
        relative_attention_max_distance=20, feed_forward_proj="gated-gelu",
        dropout_rate=0.0)).eval().save_pretrained(t5_dir, safe_serialization=True)
    vocab = {w: i for i, w in enumerate(WORDS)}
    vocab["[UNK]"] = len(vocab)
    vocab["[PAD]"] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]",
                            pad_token="[PAD]").save_pretrained(t5_dir)
    return {"table": tmp / "table.json", "vae": vae_dir, "t5": t5_dir}


def jax_posterior_noise(seed, index, shape):
    """The JAX tool's draws for batch `index`: `rng, k = split(rng)` from
    `key(seed)` once a batch, then `normal(k, shape)`."""
    rng = jax.random.key(seed)
    for _ in range(index + 1):
        rng, k = jax.random.split(rng)
    return torch.from_numpy(np.array(jax.random.normal(k, tuple(shape), jnp.float32)))


CACHE_CASES = {
    "center_crop": ["--center_crop"],
    "no_center_crop": [],
    "limit_mid_batch": ["--center_crop", "--limit", "6"],
    "t5": ["--center_crop", "--text_encoder_type", "t5"],
}


def _build_caches(sources, out: Path, case: str) -> tuple[Path, Path, int]:
    """(the JAX tool's cache, the port's, the count written) for `case`."""
    argv = ["--train_data_path", str(sources["table"]), "--root_dir_type", "json",
            "--base_url", "file://", "--resolution", "32", "--batch_size", "4",
            "--vae_path", str(sources["vae"]), "--cross_attn_input_size", "24",
            "--seed", "3", *CACHE_CASES[case]]
    if case == "t5":
        argv += ["--text_encoder_path", str(sources["t5"])]
    with pytest.MonkeyPatch.context() as mp:
        # the text bar holds in fp32 (both packages' default is bf16)
        mp.setattr(jenc, "T5TextEncoder",
                   functools.partial(jenc.T5TextEncoder, dtype=jnp.float32))
        mp.setattr(penc, "T5TextEncoder",
                   functools.partial(penc.T5TextEncoder, dtype=torch.float32))
        mp.setattr(ptool, "posterior_noise", jax_posterior_noise)
        n = jax_precompute(argv + ["--output_dir", str(out / "jax")])
        assert ptool.main(argv + ["--output_dir", str(out / "port"),
                                  "--device", "cpu"]) == n
    return out / "jax", out / "port", n


@pytest.fixture(scope="module")
def caches(sources, tmp_path_factory):
    return _build_caches(sources, tmp_path_factory.mktemp("caches"), "center_crop")


@pytest.mark.parametrize("case", list(CACHE_CASES))
def test_cache_builder_matches_the_jax_tool(sources, caches, tmp_path, case):
    want_root, got_root, n = (caches if case == "center_crop"
                              else _build_caches(sources, tmp_path, case))
    assert n == (6 if case == "limit_mid_batch" else len(CAPTIONS))
    want = json.loads((want_root / "precomputed_mapping.json").read_text())
    got = json.loads((got_root / "precomputed_mapping.json").read_text())
    assert got == want and len(got["entries"]) == n
    assert [e["caption"] for e in got["entries"]] == CAPTIONS[:n]
    shapes = {tuple(e["latent_shape"]) for e in got["entries"]}
    if "--center_crop" in CACHE_CASES[case]:
        assert shapes == {(16, 16, 16)}, shapes
    else:  # the bucket nearest the 40x32 images' aspect
        assert len(shapes) == 1 and shapes != {(16, 16, 16)}, shapes
    for e in got["entries"]:
        _max_err_bar(np.load(got_root / "vae_latents" / e["latent_file"]),
                     np.load(want_root / "vae_latents" / e["latent_file"]))
    files = sorted(p.name for p in (want_root / "text_embeddings").iterdir())
    assert sorted(p.name for p in (got_root / "text_embeddings").iterdir()) == files
    assert len(files) == len(set(CAPTIONS[:n]))
    for name in files:
        a = np.load(got_root / "text_embeddings" / name)
        b = np.load(want_root / "text_embeddings" / name)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        if case == "t5":
            # only the real rows: one a word, no padding
            assert a.shape[0] < 8
            _max_err_bar(a, b)
        else:
            np.testing.assert_array_equal(a, b)


def test_each_package_reads_the_others_cache(caches):
    want_root, got_root, n = caches
    for ds_cls in (precomputed.PrecomputedDataset, jprecomputed.PrecomputedDataset):
        own, other = ds_cls(got_root), ds_cls(want_root)
        assert len(own) == len(other) == n
        for i in range(n):
            a, b = own[i], other[i]
            assert a.keys() == b.keys() and a["caption"] == b["caption"]
            np.testing.assert_array_equal(a["text_embedding"], b["text_embedding"])
            _max_err_bar(a["vae_latent"], b["vae_latent"])
    batch = precomputed.PrecomputedDataset(want_root).collate_fn(
        [precomputed.PrecomputedDataset(want_root)[i] for i in range(4)])
    assert batch["vae_latent"].shape == (4, 16, 16, 16)
    assert batch["text_embedding"].shape == (4, 32, 24) and batch["text_mask"].all()


def test_port_trainer_takes_two_steps_from_the_ports_cache(caches, tmp_path):
    from f_lite_tpu_torch.train.trainer import parse_args, train

    result = train(parse_args([
        "--device", "cpu", "--use_precomputed_data", "--precomputed_data_dir",
        str(caches[1]), "--in_channels", "16", "--model_width", "32",
        "--model_depth", "2", "--model_head_dim", "16", "--cross_attn_input_size",
        "24", "--train_batch_size", "4", "--max_steps", "2", "--log_every", "1",
        "--seed", "0", "--sample_every", "0", "--checkpointing_steps", "100",
        "--output_dir", str(tmp_path / "out")]))
    assert result["global_step"] == 2 and np.isfinite(result["train/loss"])


def test_cache_builder_without_a_vae_path_and_the_serve_message(sources, tmp_path):
    """Without `--vae_path` the tool builds the trainer's seeded tiny VAE;
    `serve --precomputed_dir` names the port's tool for a caption the cache
    lacks."""
    from f_lite_tpu_torch import serve

    n = ptool.main(["--train_data_path", str(sources["table"]), "--root_dir_type",
                    "json", "--base_url", "file://", "--resolution", "32",
                    "--center_crop", "--batch_size", "4", "--limit", "3",
                    "--output_dir", str(tmp_path / "cache"), "--device", "cpu"])
    assert n == 3
    latent = np.load(next((tmp_path / "cache" / "vae_latents").iterdir()))
    assert latent.shape == (16, 16, 16) and np.isfinite(latent).all()
    prompts = tmp_path / "p.txt"
    prompts.write_text("never cached\n")
    with pytest.raises(SystemExit, match="python -m f_lite_tpu_torch.tools."
                                         "precompute_embeddings"):
        serve.main(["--model", str(tmp_path / "no_model"), "--device", "cpu",
                    "--prompts", str(prompts), "--precomputed_dir",
                    str(tmp_path / "cache"), "--width", "16", "--height", "16"])


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------

TINY = dict(in_channels=4, patch_size=2, hidden_size=64, depth=5, num_heads=4,
            mlp_ratio=2.0, cross_attn_input_size=32, residual_v=True,
            cross_attn_first_n=1, cross_attn_period=2)


def _jax_vae_dir(root: Path, levels=2) -> Path:
    """A seeded tiny native `vae/` dir (4 latent channels, scale 2 or 4)."""
    root.mkdir(parents=True)
    vae = AutoencoderKL(VAEConfig.tiny(block_out_channels=(8, 16, 16)[:levels]))
    vae.init_weights(torch.Generator().manual_seed(levels))
    (root / "config.json").write_text(json.dumps(vae.config.to_json_dict()))
    save_file(vae_state_dict_to_jax(vae.state_dict(), vae.config),
              root / "flax_params.safetensors")
    return root


def _jax_native_dir(root: Path, layout: str) -> Path:
    """A native dir the JAX package saved (seeded non-zero DiT weights) in
    `layout`; "unrolled" with `vae/`, `text_encoder/` and `tokenizer/`."""
    cfg_kw = dict(adaln_mode="per_block", cross_attn_all=True) if layout == "v2" else {}
    cfg = JaxDiTConfig(**TINY, **cfg_kw, use_pallas_attention=False)
    params = {"params": unflatten(random_jax_params(cfg, seed=len(layout)))}
    out = root / layout
    if layout in ("unrolled", "v2"):
        JaxPipeline(JaxDiT(cfg), params).save_pretrained(out)
    else:
        JaxPipeline(JaxDiT(cfg), params).save_pretrained(root / "src")
        load_kw = {"scan": dict(scan_layers=True),
                   "pipeline_2": dict(scan_layers=True),
                   "padded_heads": dict(scan_layers=False, pad_heads_to=8)}[layout]
        jp = JaxPipeline.from_pretrained(root / "src", dtype=jnp.float32,
                                         load_text_encoder=False, **load_kw)
        jcfg, jparams = jp.dit_model.config, jp.dit_params
        if layout == "pipeline_2":
            import dataclasses

            jcfg = dataclasses.replace(jcfg, pipeline_stages=2)
            jparams = scan_to_pipeline_params(jparams, 2)
        JaxPipeline(JaxDiT(jcfg), jparams).save_pretrained(out)
    if layout == "unrolled":
        _jax_vae_dir(out / "vae")
        for sub, name, cfg_d in (
                ("text_encoder", "config.json", {"model_type": "t5",
                                                 "architectures": ["T5EncoderModel"]}),
                ("tokenizer", "tokenizer_config.json", {"tokenizer_class": "T5Tokenizer"})):
            (out / sub).mkdir()
            (out / sub / name).write_text(json.dumps(cfg_d))
    return out


def _tree(path: Path) -> tuple[dict, dict]:
    """({relative file: tensor} of every safetensors and .pt file, {relative
    file: dict} of every JSON file) under `path`."""
    tensors, jsons = {}, {}
    for f in sorted(path.rglob("*")):
        rel = str(f.relative_to(path))
        if f.suffix == ".safetensors":
            tensors.update({f"{rel}:{k}": v for k, v in load_file(f).items()})
        elif f.suffix == ".pt":
            tensors.update({f"{rel}:{k}": v.numpy() for k, v in torch.load(
                f, map_location="cpu", weights_only=True).items()})
        elif f.suffix == ".json":
            jsons[rel] = json.loads(f.read_text())
    return tensors, jsons


def _assert_same_tree(a: Path, b: Path):
    (ta, ja), (tb, jb) = _tree(a), _tree(b)
    assert ja == jb
    assert ta.keys() == tb.keys() and ta
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and ta[k].shape == tb[k].shape, k
        assert ta[k].tobytes() == tb[k].tobytes(), k


@pytest.fixture(scope="module")
def unrolled_dir(tmp_path_factory):
    return _jax_native_dir(tmp_path_factory.mktemp("native"), "unrolled")


@pytest.mark.parametrize("layout", ["unrolled", "v2", "scan", "pipeline_2",
                                    "padded_heads"])
def test_export_torch_matches_the_jax_tool(tmp_path, unrolled_dir, layout):
    src = unrolled_dir if layout == "unrolled" else _jax_native_dir(tmp_path, layout)
    for name, convert in (("jax", jax_convert), ("port", ptool_convert.main)):
        (tmp_path / name).mkdir()
        convert(["--export_torch", str(src), "--output_dir", str(tmp_path / name / "hf"),
                 "--pt_file", str(tmp_path / name / "dit.pt"),
                 *(["--device", "cpu"] if name == "port" else [])])
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    port = tmp_path / "port" / "hf"
    index = json.loads((port / "model_index.json").read_text())
    assert ("vae" in index) == (port / "vae").exists() == (layout == "unrolled")
    if layout == "unrolled":
        assert index["text_encoder"] == ["transformers", "T5EncoderModel"]
        assert index["tokenizer"] == ["transformers", "T5Tokenizer"]
    sd = load_file(port / "dit_model" / "diffusion_pytorch_model.safetensors")
    assert all(v.dtype == np.float32 for v in sd.values())
    assert sd["blocks.0.self_attn.qkv.weight"].shape == (3 * 64, 64)


def test_int8_export_is_refused_by_both_tools(tmp_path, unrolled_dir):
    FLitePipeline.from_pretrained(unrolled_dir, dtype=torch.float32, device="cpu", quantize=True,
                                  load_text_encoder=False).save_pretrained(tmp_path / "int8")
    for convert, extra in ((jax_convert, []), (ptool_convert.main, ["--device", "cpu"])):
        with pytest.raises(ValueError, match="cannot export int8-quantized"):
            convert(["--export_torch", str(tmp_path / "int8"), "--output_dir",
                     str(tmp_path / "out"), *extra])
    assert not (tmp_path / "out" / "dit_model").exists()


REF = dict(in_channels=16, patch_size=2, hidden_size=64, depth=3, num_heads=4,
           mlp_ratio=2.0, cross_attn_input_size=48)
INGEST_CASES = {
    "pt": (dict(residual_v=True), ["--width", "64", "--head_dim", "16",
                                   "--mlp_ratio", "2.0", "--cross_attn_input_size", "48"]),
    "pt_no_residual_v": (dict(residual_v=False),
                         ["--width", "64", "--head_dim", "16", "--no_residual_v"]),
    "pt_train_bias_and_rms": (dict(residual_v=True, train_bias_and_rms=True),
                              ["--head_dim", "16", "--train_bias_and_rms", "--strict"]),
    "hf_dir_strict_with_dirs": (dict(residual_v=True), ["--strict"]),
}


@pytest.mark.parametrize("case", list(INGEST_CASES))
def test_ingest_flags_match_the_jax_tool(tmp_path, unrolled_dir, case):
    cfg_kw, flags = INGEST_CASES[case]
    sd = make_random_state_dict(JaxDiTConfig(**REF, **cfg_kw), seed=len(case))
    if case.startswith("pt"):
        torch.save({f"module.{k}": v for k, v in sd.items()}, tmp_path / "m.pt")
        source = ["--pt", str(tmp_path / "m.pt")]
    else:
        hf = tmp_path / "hf"
        (hf / "dit_model").mkdir(parents=True)
        save_file({k: v.numpy() for k, v in sd.items()},
                  hf / "dit_model" / "diffusion_pytorch_model.safetensors")
        (hf / "dit_model" / "config.json").write_text(json.dumps(
            from_jax.reference_dit_config(DiTConfig(**REF, **cfg_kw))))
        vae_hf = tmp_path / "vae_hf"
        ptool_convert.main(["--export_torch", str(unrolled_dir),
                            "--output_dir", str(vae_hf), "--device", "cpu"])
        source = ["--hf_dir", str(hf), "--vae_dir", str(vae_hf / "vae"),
                  "--text_encoder_dir", str(vae_hf / "text_encoder"),
                  "--tokenizer_dir", str(vae_hf / "tokenizer")]
    jax_convert([*source, *flags, "--output_dir", str(tmp_path / "jax")])
    ptool_convert.main([*source, *flags, "--output_dir", str(tmp_path / "port"),
                        "--device", "cpu"])
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    cfg = json.loads((tmp_path / "port" / "dit" / "config.json").read_text())
    assert cfg["residual_v"] == cfg_kw["residual_v"]
    assert cfg["train_bias_and_rms"] == cfg_kw.get("train_bias_and_rms", False)
    assert (tmp_path / "port" / "vae").exists() == (case == "hf_dir_strict_with_dirs")


@pytest.mark.parametrize("form", ["dir", "safetensors_file"])
def test_export_lora_matches_the_jax_tool(tmp_path, form):
    rs = np.random.RandomState(4)
    tree = {f"blocks_{i}": {
        attn: {t: {"lora_a": rs.randn(64, 4).astype(np.float32),
                   "lora_b": rs.randn(4, n).astype(np.float32)} for t, n in targets}
        for attn, targets in (("self_attn", (("qkv", 192), ("proj", 64))),
                              ("cross_attn", (("q", 64), ("context_kv", 128))))}
        for i in range(2)}
    (tmp_path / "lora").mkdir()
    save_lora_weights(tree, tmp_path / "lora")
    path = tmp_path / "lora" / ("lora_weights.safetensors" if form != "dir" else "")
    jax_convert(["--export_lora", str(path), "--output_dir", str(tmp_path / "jax")])
    got = ptool_convert.main(["--export_lora", str(path), "--output_dir",
                              str(tmp_path / "port"), "--device", "cpu"])
    assert got == tmp_path / "port" / "lora_weights.pt"
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    sd = torch.load(got, weights_only=True)
    assert len(sd) == 2 * 4 * 2
    assert sd["blocks.1.self_attn.qkv.lora_A.weight"].shape == (4, 64)


def test_round_trip_renders_the_source_images(tmp_path):
    """The port's export, then the port's `--pt` (with the export's `vae/`)
    and `from_pretrained`: the source's fp32 images bit for bit. The JAX
    tool's `--pt` of the same file gives the JAX DiT the port's output at
    MSE < 1e-9. `--test_image --device cpu` writes its PNG."""
    # a raw `.pt` carries no cross-attention pattern: v1's
    cfg = JaxDiTConfig(**{**TINY, "cross_attn_first_n": 8, "cross_attn_period": 4},
                       use_pallas_attention=False)
    params = {"params": unflatten(random_jax_params(cfg, seed=9))}
    JaxPipeline(JaxDiT(cfg), params).save_pretrained(tmp_path / "src")
    _jax_vae_dir(tmp_path / "src" / "vae", levels=3)
    ptool_convert.main(["--export_torch", str(tmp_path / "src"), "--output_dir",
                        str(tmp_path / "hf"), "--pt_file", str(tmp_path / "dit.pt"),
                        "--device", "cpu"])
    arch = ["--width", "64", "--head_dim", "16", "--mlp_ratio", "2.0",
            "--cross_attn_input_size", "32"]
    back = ptool_convert.main(["--pt", str(tmp_path / "dit.pt"), *arch,
                               "--vae_dir", str(tmp_path / "hf" / "vae"), "--output_dir",
                               str(tmp_path / "back"), "--test_image", "--device", "cpu"])

    rs = np.random.RandomState(3)
    kw = dict(prompt_embeds=rs.randn(2, 8, 32).astype(np.float32),
              latents=rs.randn(2, 8, 8, 4).astype(np.float32),
              num_inference_steps=3, output_type="np")

    def images(path):
        return FLitePipeline.from_pretrained(path, dtype=torch.float32, device="cpu",
                                             load_text_encoder=False)(**kw).images

    want = images(tmp_path / "src")
    assert want.shape == (2, 32, 32, 3) and np.isfinite(want).all()
    np.testing.assert_array_equal(images(back), want)
    png = (back / "test_image.png").read_bytes()
    from f_lite_tpu_torch.utils.image import read_png

    assert read_png(png).shape == (256, 256, 3)

    jax_back = jax_convert(["--pt", str(tmp_path / "dit.pt"), *arch, "--output_dir",
                            str(tmp_path / "jax_back")])
    jp = JaxPipeline.from_pretrained(jax_back, dtype=jnp.float32, load_text_encoder=False)
    x = rs.randn(2, 16, 16, 4).astype(np.float32)
    ctx = rs.randn(2, 8, 32).astype(np.float32)
    mask = np.arange(8)[None, :] < np.array([8, 5])[:, None]
    t = rs.rand(2).astype(np.float32)
    got = np.asarray(jp.dit_model.apply(jp.dit_params, jnp.asarray(x), jnp.asarray(ctx),
                                        jnp.asarray(mask), jnp.asarray(t)))
    port = FLitePipeline.from_pretrained(tmp_path / "src", dtype=torch.float32,
                                         device="cpu", load_text_encoder=False)
    with torch.no_grad():
        want_dit = port.dit(*map(torch.from_numpy, (x, ctx, mask, t))).numpy()
    assert np.abs(want_dit).max() > 1e-2
    assert float(((got - want_dit) ** 2).mean()) < 1e-9


@pytest.mark.parametrize("name", ["plain", "bias_rms", "no_rope", "v2_per_block",
                                  "cross_every_2", "fixture"])
def test_reference_configs_equal_the_jax_packages(name):
    kw = {"plain": dict(), "bias_rms": dict(train_bias_and_rms=True),
          "no_rope": dict(use_rope=False),
          "v2_per_block": dict(adaln_mode="per_block", cross_attn_all=True),
          "cross_every_2": dict(cross_attn_first_n=1, cross_attn_period=2),
          "fixture": json.loads((ROOT / "artifacts/fixture_run/pipeline/dit/config.json")
                                .read_text())}[name]
    from f_lite_tpu.convert.jax_to_torch import reference_dit_config, reference_vae_config

    if name == "fixture":
        cfg, jcfg = DiTConfig.from_json_dict(kw), None
        from f_lite_tpu.pipeline import _config_kwargs

        jcfg = JaxDiTConfig(**_config_kwargs(JaxDiTConfig, kw))
    else:
        base = dict(REF, depth=9, residual_v=True)
        cfg, jcfg = DiTConfig(**base, **kw), JaxDiTConfig(**base, **kw)
    assert from_jax.reference_dit_config(cfg) == reference_dit_config(jcfg)
    for vkw in (dict(), dict(block_out_channels=(8, 16), layers_per_block=1,
                             norm_num_groups=4, latent_channels=4,
                             mid_block_add_attention=False)):
        assert from_jax.reference_vae_config(VAEConfig(**vkw)) == \
            reference_vae_config(JaxVAEConfig(**vkw))
