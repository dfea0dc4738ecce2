"""The port stands alone: with `jax`, `flax`, `optax` and `f_lite_tpu`
blocked by an import hook, every module of `f_lite_tpu_torch` (the training
path's, the text encoders' and the front-ends' included) and
`chip_smoke.py` import (and do no work at import time; the multi-GPU
`parallel` package among them); with
`transformers`, `tokenizers` and `safetensors` blocked too, every text
module imports and the text stacks build, load an HF folder and run; with
PIL blocked too, the front-ends import and the PNG codec writes and reads.
The entry points' default device is the card: without one,
`from_pretrained`, the text encoders, the trainer, `generate`, `serve` and
the ComfyUI node raise instead of falling back."""

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
    "f_lite_tpu_torch.train.checkpoint",
)
TEXT_MODULES = ("f_lite_tpu_torch.text.encoder", "f_lite_tpu_torch.text.t5",
                "f_lite_tpu_torch.text.qwen2", "f_lite_tpu_torch.text.templates",
                "f_lite_tpu_torch.convert.hf_weights",
                "f_lite_tpu_torch.text.layers", "f_lite_tpu_torch.utils.device",
                "f_lite_tpu_torch.tools.text_precision")
EXTRAS_MODULES = ("f_lite_tpu_torch.convert.ingest",
                  "f_lite_tpu_torch.convert.manifest",
                  "f_lite_tpu_torch.convert.lora_torch",
                  "f_lite_tpu_torch.train.lora")
FRONTEND_MODULES = ("f_lite_tpu_torch.generate", "f_lite_tpu_torch.serve",
                    "f_lite_tpu_torch.comfyui", "f_lite_tpu_torch.gui",
                    "f_lite_tpu_torch.utils.image")
ONLINE_MODULES = ("f_lite_tpu_torch.data.dataset", "f_lite_tpu_torch.data.loader",
                  "f_lite_tpu_torch.data.image_ops", "f_lite_tpu_torch.utils.env")
PARALLEL_MODULES = ("f_lite_tpu_torch.parallel", "f_lite_tpu_torch.parallel.mesh",
                    "f_lite_tpu_torch.parallel.sharding",
                    "f_lite_tpu_torch.parallel.tensor", "f_lite_tpu_torch.parallel.pipeline",
                    "f_lite_tpu_torch.convert.heads")
TOOL_MODULES = ("f_lite_tpu_torch.tools.precompute_embeddings",
                "f_lite_tpu_torch.tools.convert_checkpoint",
                "f_lite_tpu_torch.tools.fabricated_release_dryrun")
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
    assert set(TRAINING_MODULES + LAB_MODULES + TEXT_MODULES + EXTRAS_MODULES
               + FRONTEND_MODULES + ONLINE_MODULES + PARALLEL_MODULES
               + TOOL_MODULES) <= set(names.split()), names
    n_modules = int(summary.split()[0])
    assert n_modules >= 51, out.stdout
    assert out.stdout.strip().endswith("built-at-import: 0"), out.stdout


TEXT_WITHOUT_HF = textwrap.dedent("""
    import importlib, importlib.abc, sys, tempfile
    from pathlib import Path

    BLOCKED = ("jax", "flax", "f_lite_tpu", "transformers", "tokenizers",
               "safetensors")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import torch
    for name in TEXT_MODULES + ("f_lite_tpu_torch.text", "f_lite_tpu_torch.pipeline"):
        importlib.import_module(name)
    from f_lite_tpu_torch.text import qwen2, t5
    from f_lite_tpu_torch.text.encoder import T5TextEncoder
    from f_lite_tpu_torch.utils.random_weights import randomize_
    from f_lite_tpu_torch.utils.safetensors import save_file

    class Words:
        def __call__(self, texts, **kw):
            from f_lite_tpu_torch.text.encoder import _pad_to_multiple
            ids, mask = _pad_to_multiple([[len(w) for w in t.split()] for t in texts],
                                         0, kw["pad_to_multiple_of"], kw["max_length"])
            return {"input_ids": ids, "attention_mask": mask.astype("int64")}

    cfg = t5.T5Config(vocab_size=32, d_model=16, d_kv=8, d_ff=32, num_layers=2,
                      num_heads=2)
    stack = randomize_(t5.T5EncoderStack(cfg), seed=0)
    with tempfile.TemporaryDirectory() as d:
        save_file({k: v.numpy() for k, v in stack.state_dict().items()},
                  Path(d) / "model.safetensors")
        (Path(d) / "config.json").write_text(__import__("json").dumps(
            {**cfg.__dict__}))
        loaded = t5.load_t5_encoder(d, dtype=torch.float32, device="cpu")
    emb, mask = T5TextEncoder.from_stack(loaded, Words(), return_index=-1).encode(
        ["a red circle", "blue"])
    assert emb.shape == (2, 8, 16) and mask.sum() == 4, (emb.shape, mask)
    q = randomize_(qwen2.Qwen2Encoder(qwen2.Qwen2Config(
        vocab_size=32, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1)), seed=1)
    assert q(torch.zeros(1, 5, dtype=torch.long), return_index=-1).shape == (1, 5, 16)
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("ok")
""")


def test_text_modules_import_and_run_without_hf_packages():
    out = _run(TEXT_WITHOUT_HF.replace("TEXT_MODULES", repr(TEXT_MODULES)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok"), out.stdout


EXTRAS_WITHOUT_JAX_OR_SAFETENSORS = textwrap.dedent("""
    import importlib, importlib.abc, json, sys, tempfile
    from pathlib import Path

    BLOCKED = ("jax", "flax", "f_lite_tpu", "transformers", "safetensors")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import torch
    from f_lite_tpu_torch.convert.lora_torch import lora_to_peft_state_dict
    from f_lite_tpu_torch.models.dit import DiT, DiTConfig
    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.utils.random_weights import randomize_
    from f_lite_tpu_torch.utils.safetensors import save_file

    cfg = DiTConfig(in_channels=4, patch_size=2, hidden_size=32, depth=2,
                    num_heads=2, mlp_ratio=2.0, cross_attn_input_size=16)
    dit = randomize_(DiT(cfg), seed=0)
    g = torch.Generator().manual_seed(1)
    lora = {"blocks_0": {"self_attn": {"qkv": {
        "lora_a": torch.randn(32, 2, generator=g).numpy(),
        "lora_b": torch.randn(2, 96, generator=g).numpy()}}}}
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        (d / "snap" / "dit_model").mkdir(parents=True)
        save_file(dit.state_dict(), d / "snap/dit_model/diffusion_pytorch_model.safetensors")
        (d / "snap/dit_model/config.json").write_text(json.dumps(dict(
            hidden_size=32, depth=2, num_heads=2, in_channels=4, mlp_ratio=2.0,
            cross_attn_input_size=16, residual_v=False)))
        (d / "st").mkdir()
        save_file({"blocks_0.self_attn.qkv." + k: v for k, v in
                   lora["blocks_0"]["self_attn"]["qkv"].items()},
                  d / "st" / "lora_weights.safetensors")
        torch.save({k: torch.from_numpy(v) for k, v in
                    lora_to_peft_state_dict(lora).items()}, d / "lora_weights.pt")
        kw = dict(prompt_embeds=torch.zeros(1, 4, 16).numpy(), height=8, width=8,
                  num_inference_steps=2, output_type="np")
        images = []
        for lora_path in (d / "st", d / "lora_weights.pt"):
            pipe = FLitePipeline.from_pretrained(d / "snap", dtype=torch.float32,
                                                 device="cpu", lora_path=lora_path)
            images.append(pipe(**kw).images)
        pipe.save_pretrained(d / "saved")
        again = FLitePipeline.from_pretrained(d / "saved", dtype=torch.float32,
                                              device="cpu")(**kw).images
    assert (images[0] == images[1]).all() and (again == images[1]).all()
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("ok")
""")


def test_pipeline_extras_run_without_jax_or_safetensors():
    """Ingest of a diffusers snapshot, LoRA at load in both forms and
    save_pretrained, as on the card's machine (no JAX, no safetensors)."""
    out = _run(EXTRAS_WITHOUT_JAX_OR_SAFETENSORS)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok"), out.stdout


TRAIN_STATE_WITHOUT_JAX_OR_SAFETENSORS = textwrap.dedent("""
    import importlib, importlib.abc, json, sys, tempfile
    from pathlib import Path

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "f_lite_tpu",
               "safetensors")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    import torch
    from f_lite_tpu_torch.data.precomputed import PrecomputedCacheWriter
    from f_lite_tpu_torch.train.trainer import parse_args, train

    torch.set_num_threads(1)  # a tiny model beside parallel test workers

    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        w = PrecomputedCacheWriter(d / "cache")
        rs = np.random.RandomState(0)
        for i in range(12):
            w.add(str(i), f"c{i % 3}", rs.randn(8 if i % 2 else 12, 8, 3).astype(np.float32),
                  rs.randn(4, 16).astype(np.float32))
        w.finalize()
        argv = ["--device", "cpu", "--use_precomputed_data", "--precomputed_data_dir",
                str(d / "cache"), "--pixel_space", "--model_width", "32",
                "--model_depth", "2", "--model_head_dim", "16",
                "--cross_attn_input_size", "16", "--train_batch_size", "2",
                "--use_resolution_buckets", "--num_epochs", "3", "--seed", "0",
                "--gradient_checkpointing", "--log_every", "1"]
        train(parse_args(argv + ["--output_dir", str(d / "base"), "--max_steps", "2",
                                 "--export_pipeline"]))
        recipe = ["--pretrained_model_path", str(d / "base" / "pipeline"), "--use_lora",
                  "--lora_rank", "2", "--ema_decay", "0.9", "--ema_dtype", "bf16",
                  "--gradient_accumulation_steps", "2", "--bs_rampup", "2",
                  "--sequence_dropout", "0.5", "--remat_policy", "dots",
                  "--batch_multiplicity", "2", "--checkpointing_steps", "2",
                  "--async_checkpoint", "--output_dir", str(d / "ft")]
        train(parse_args(argv + recipe + ["--max_steps", "2"]))
        result = train(parse_args(argv + recipe + ["--max_steps", "4",
                                                   "--resume_from_checkpoint", "latest",
                                                   "--export_pipeline"]))
        assert result["global_step"] == 4, result
        assert (d / "ft" / "checkpoints" / "4" / "lora_weights.safetensors").exists()
        assert json.loads((d / "ft" / "checkpoints" / "4" / "sampler_state.json")
                          .read_text())["start_batch_index"] == 4
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("ok")
""")


def test_train_state_and_recipe_options_run_without_jax_or_safetensors():
    """Fine-tune, LoRA, EMA, accumulation, rampup, sequence dropout, "dots",
    buckets, an async checkpoint and a resume, as on the card's machine
    (no JAX, no safetensors), on the CPU."""
    out = _run(TRAIN_STATE_WITHOUT_JAX_OR_SAFETENSORS)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok"), out.stdout


ONLINE_WITHOUT_PIL_PANDAS_OR_METRICS = textwrap.dedent("""
    import importlib, importlib.abc, json, logging, sys, tempfile
    from pathlib import Path

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "f_lite_tpu", "PIL", "pandas",
               "tensorboardX", "wandb", "safetensors")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    import torch
    from f_lite_tpu_torch.data.dataset import ImageDataset
    from f_lite_tpu_torch.train.trainer import parse_args, train
    from f_lite_tpu_torch.utils.image import png_bytes_with_metadata

    torch.set_num_threads(1)
    errors = []

    class Errors(logging.Handler):
        def emit(self, record):
            if record.levelno >= logging.ERROR:
                errors.append(record.getMessage())

    logging.getLogger("f_lite_tpu_torch.train").addHandler(Errors())
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        rs = np.random.RandomState(0)
        rows = []
        for i, (w, h) in enumerate([(48, 48), (32, 64), (64, 32), (48, 48)] * 2):
            f = d / f"{i}.png"
            f.write_bytes(png_bytes_with_metadata(rs.randint(0, 256, (h, w, 3))
                                                  .astype(np.uint8)))
            rows.append({"media_path": str(f), "captions": [f"c{i}", "x"],
                         "width": w, "height": h})
        (d / "t.json").write_text(json.dumps(rows))
        for url in ("file://", "dummy://"):
            ds = ImageDataset(str(d / "t.json"), root_dir_type="json", base_url=url,
                              resolution=32, center_crop=False, random_flip=True)
            items = [ds[i] for i in range(len(ds))]
            assert all(it["_id"] != "-1" for it in items), url
            assert {it["image"].shape for it in items} == {(48, 48, 3), (64, 32, 3),
                                                           (32, 64, 3)}
        try:
            ImageDataset("coll", base_image_dir=str(d), root_dir_type="parquet")
        except ImportError as e:
            assert "pandas" in str(e), e
        else:
            raise SystemExit("read a parquet table without pandas")
        argv = ["--device", "cpu", "--train_data_path", str(d / "t.json"),
                "--root_dir_type", "json", "--base_url", "file://",
                "--resolution", "32", "--use_resolution_buckets", "--pixel_space",
                "--model_width", "32", "--model_depth", "2", "--model_head_dim", "16",
                "--cross_attn_input_size", "16", "--train_batch_size", "2",
                "--max_steps", "2", "--num_epochs", "2", "--log_every", "1",
                "--seed", "0", "--num_workers", "2", "--output_dir", str(d / "out"),
                "--val_data_path", str(d / "t.json"), "--eval_every", "2",
                "--sample_every", "2", "--debug"]
        result = train(parse_args(argv))
        assert result["global_step"] == 2 and "val/loss" in result, result
        assert (d / "out" / "samples" / "step_2.png").exists()
    assert any("NO metrics backend is active" in e for e in errors), errors
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("ok")
""")


def test_online_path_runs_without_pil_pandas_or_metrics_packages():
    """What the card's machine has: no JAX, PIL, pandas, tensorboardX,
    wandb or safetensors. A JSON table of PNG files at their buckets' sizes
    (file backend) and the dummy backend yield items; a 2-step online run
    with buckets, validation and sampling finishes, and the missing
    metrics backend is logged as an error, as the JAX trainer logs it."""
    out = _run(ONLINE_WITHOUT_PIL_PANDAS_OR_METRICS)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok"), out.stdout


def test_dataset_module_imports_no_torch():
    """The loader's forkserver preloads `f_lite_tpu_torch.data.dataset`; it
    imports no torch (nor JAX), so the server never initializes CUDA."""
    out = _run("import sys; import f_lite_tpu_torch.data.dataset, "
               "f_lite_tpu_torch.data.loader; "
               "print([m for m in sys.modules if m.split('.')[0] in "
               "('torch', 'jax', 'f_lite_tpu')])")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


FRONTENDS_WITHOUT_PIL = textwrap.dedent("""
    import importlib, importlib.abc, sys

    BLOCKED = ("jax", "flax", "f_lite_tpu", "PIL", "gradio")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    for name in FRONTEND_MODULES:
        importlib.import_module(name)
    from f_lite_tpu_torch.utils import image

    x = np.random.RandomState(0).randint(0, 256, (24, 40, 3)).astype(np.uint8)
    data = image.png_bytes_with_metadata(x, {"prompt": "a cat", "seed": 3})
    assert (image.read_png(data) == x).all()
    assert image.read_metadata(data) == {"prompt": "a cat", "seed": 3}
    assert (image.load_image(data) == x).all()
    for bad, what in ((b"GIF89a", "needs PIL"),):
        try:
            image.load_image(bad)
        except ValueError as e:
            assert what in str(e), e
        else:
            raise SystemExit("decoded a GIF without PIL")
    try:
        image.load_image(data, size=(16, 16))
    except image.NeedsResize as e:
        assert "needs PIL" in str(e), e
    else:
        raise SystemExit("resized without PIL")
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("ok")
""")


def test_frontends_and_png_codec_without_pil():
    out = _run(FRONTENDS_WITHOUT_PIL.replace("FRONTEND_MODULES", repr(FRONTEND_MODULES)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok"), out.stdout


TOOLS_WITHOUT_JAX_SAFETENSORS_OR_TRANSFORMERS = textwrap.dedent("""
    import importlib, importlib.abc, json, sys, tempfile
    from pathlib import Path

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "f_lite_tpu",
               "safetensors", "transformers", "tokenizers")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    import torch
    from f_lite_tpu_torch.models.dit import DiT, DiTConfig
    from f_lite_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.tools import convert_checkpoint, precompute_embeddings
    from f_lite_tpu_torch.utils.image import png_bytes_with_metadata
    from f_lite_tpu_torch.utils.random_weights import randomize_
    from f_lite_tpu_torch.utils.safetensors import load_file

    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        rs = np.random.RandomState(0)
        rows = []
        for i in range(6):
            f = d / f"{i}.png"
            f.write_bytes(png_bytes_with_metadata(rs.randint(0, 256, (16, 16, 3))
                                                  .astype(np.uint8)))
            rows.append({"media_path": str(f), "captions": [f"c{i % 4}"],
                         "width": 16, "height": 16})
        (d / "t.json").write_text(json.dumps(rows))
        n = precompute_embeddings.main([
            "--train_data_path", str(d / "t.json"), "--root_dir_type", "json",
            "--base_url", "file://", "--resolution", "16", "--center_crop",
            "--cross_attn_input_size", "16", "--batch_size", "4",
            "--output_dir", str(d / "cache"), "--device", "cpu"])
        entries = json.loads((d / "cache" / "precomputed_mapping.json").read_text())
        assert n == 6 == len(entries["entries"]), entries
        assert len(list((d / "cache" / "text_embeddings").iterdir())) == 4

        cfg = DiTConfig(in_channels=4, patch_size=2, hidden_size=32, depth=2,
                        num_heads=2, mlp_ratio=2.0, cross_attn_input_size=16,
                        residual_v=True)
        vae = AutoencoderKL(VAEConfig.tiny()).init_weights(torch.Generator().manual_seed(1))
        FLitePipeline(randomize_(DiT(cfg), seed=0), vae).save_pretrained(d / "src")
        convert_checkpoint.main(["--export_torch", str(d / "src"), "--output_dir",
                                 str(d / "hf"), "--pt_file", str(d / "dit.pt"),
                                 "--device", "cpu"])
        back = convert_checkpoint.main([
            "--pt", str(d / "dit.pt"), "--width", "32", "--head_dim", "16",
            "--mlp_ratio", "2.0", "--cross_attn_input_size", "16",
            "--vae_dir", str(d / "hf" / "vae"), "--output_dir", str(d / "back"),
            "--device", "cpu"])
        for sub in ("dit", "vae"):
            a = load_file(d / "src" / sub / "flax_params.safetensors")
            b = load_file(back / sub / "flax_params.safetensors")
            assert a.keys() == b.keys() and all(
                a[k].tobytes() == b[k].tobytes() for k in a), sub
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("ok")
""")


def test_repo_tools_run_without_jax_safetensors_or_transformers():
    """The cache builder (zero encoder) and the converter's export and
    re-ingest on the CPU, as on the card's machine (no JAX, safetensors or
    transformers): the re-ingested DiT and VAE bit-equal to the source."""
    out = _run(TOOLS_WITHOUT_JAX_SAFETENSORS_OR_TRANSFORMERS)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok"), out.stdout


RELEASE_DRYRUN_WITHOUT_JAX_SAFETENSORS_OR_PIL = textwrap.dedent("""
    import importlib, importlib.abc, json, os, sys, tempfile
    from pathlib import Path

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "f_lite_tpu",
               "safetensors", "PIL")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import torch
    from f_lite_tpu_torch.convert.manifest import expected_torch_keys
    from f_lite_tpu_torch.tools import fabricated_release_dryrun as tool

    torch.set_num_threads(1)
    cfg = dict(hidden_size=512, depth=2, num_heads=2, cross_attn_input_size=64,
               residual_v=True, train_bias_and_rms=False)
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        (d / "tiny.json").write_text(json.dumps({
            "repo_id": "tiny/F-Lite-tiny", "config": cfg,
            "keys": sorted(expected_torch_keys(tool.dit_config({"config": cfg})))}))
        tool.MANIFEST_DIR = d
        argv = ["--manifest", "tiny", "--workdir", str(d / "work"), "--device", "cpu",
                "--out", str(d / "report.json"), "--size", "32", "--steps", "1",
                "--repeats", "1"]
        partial = tool.main(argv + ["--convert_only"])
        assert partial["status"].startswith("converted"), partial
        report = tool.main(argv)
        assert report["status"] == "ok" and report["finite"], report
        assert "fabricate_seconds" not in report, report
        assert Path(report["sample_png"]).exists() and not (d / "work").exists()
        assert "F_LITE_STRICT_INGEST" not in os.environ
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("ok")
""")


def test_release_dryrun_runs_without_jax_safetensors_or_pil():
    """The fabricated-release dry run's `--convert_only` and its serve on a
    tiny manifest, as on the card's machine (no JAX, safetensors or PIL)."""
    out = _run(RELEASE_DRYRUN_WITHOUT_JAX_SAFETENSORS_OR_PIL)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok"), out.stdout


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


def test_text_encoders_default_to_cuda_and_raise_without_a_card(tmp_path):
    _skip_on_a_cuda_host()
    from f_lite_tpu_torch.text.encoder import T5TextEncoder, TorchTextEncoder
    from f_lite_tpu_torch.text.qwen2 import Qwen2TextEncoder, load_qwen2_encoder
    from f_lite_tpu_torch.text.t5 import load_t5_encoder

    for build in (T5TextEncoder, Qwen2TextEncoder, TorchTextEncoder,
                  load_t5_encoder, load_qwen2_encoder):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(str(tmp_path))


def test_trainer_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    _skip_on_a_cuda_host()
    out = subprocess.run(
        [sys.executable, "-m", "f_lite_tpu_torch.train",
         "--use_precomputed_data", "--precomputed_data_dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr, out.stderr


@pytest.mark.parametrize("module", ["generate", "serve"])
def test_frontends_default_to_cuda_and_raise_without_a_card(module, tmp_path):
    _skip_on_a_cuda_host()
    pf = tmp_path / "p.txt"
    pf.write_text("a cat\n")
    argv = {"generate": ["--prompt", "a cat", "--no_text_encoder"],
            "serve": ["--prompts", str(pf), "--no_text_encoder"]}[module]
    out = subprocess.run(
        [sys.executable, "-m", f"f_lite_tpu_torch.{module}", "--model",
         "artifacts/fixture_run/pipeline", "--output_file" if module == "generate"
         else "--output_dir", str(tmp_path / "out"), *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr, out.stderr
    assert not (tmp_path / "out").exists()


def test_comfy_node_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    _skip_on_a_cuda_host()
    from f_lite_tpu_torch import comfyui

    monkeypatch.setattr(comfyui, "_PIPELINE_CACHE", {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        comfyui.FLiteNode().generate("artifacts/fixture_run/pipeline", "x", "", 64, 64,
                                     1, 6.0, 0, False, False)


def test_lab_raises_without_a_card():
    _skip_on_a_cuda_host()
    out = subprocess.run([sys.executable, "-m", "f_lite_tpu_torch.tools.flash_variants"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr, out.stderr


@pytest.mark.parametrize("tool", ["forward_tiles", "backward_tiles", "int8_tiles",
                                  "text_precision"])
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


@pytest.mark.parametrize("tool", ["precompute_embeddings", "convert_checkpoint"])
def test_repo_tools_raise_without_a_card(tool, tmp_path):
    _skip_on_a_cuda_host()
    argv = {"precompute_embeddings": ["--train_data_path", str(tmp_path / "t.json")],
            "convert_checkpoint": ["--export_torch", str(tmp_path / "ckpt")]}[tool]
    out = subprocess.run([sys.executable, "-m", f"f_lite_tpu_torch.tools.{tool}", *argv,
                          "--output_dir", str(tmp_path / "out")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "needs an NVIDIA GPU" in out.stderr, out.stderr
    assert not (tmp_path / "out").exists()
