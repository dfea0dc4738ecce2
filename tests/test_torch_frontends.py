"""The port's front-ends on the CPU against the JAX package's: `generate`'s
parser and its `_N` files with `--from_png`, the GUI's helpers (wildcards,
compose, dated paths, the controller, presets) and the ComfyUI node, the
cases of `tests/test_frontends.py` rerun on the port. One tiny pipeline
(DiT hidden 64, depth 2, `VAEConfig.tiny()`, seeded weights) is saved once
for the module."""

import argparse
import random
import re

import numpy as np
import pytest
import torch

from f_lite_tpu import comfyui as jcomfy
from f_lite_tpu import generate as jgenerate
from f_lite_tpu import gui as jgui
from f_lite_tpu import serve as jserve
from f_lite_tpu_torch import comfyui as tcomfy
from f_lite_tpu_torch import generate as tgenerate
from f_lite_tpu_torch import gui as tgui
from f_lite_tpu_torch import serve as tserve
from f_lite_tpu_torch.models.dit import DiT, DiTConfig
from f_lite_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from f_lite_tpu_torch.pipeline import FLitePipeline
from f_lite_tpu_torch.text.encoder import PSEUDO_TEXT_LEN, ZeroTextEncoder
from f_lite_tpu_torch.utils.image import read_metadata, read_png
from f_lite_tpu_torch.utils.random_weights import randomize_

TINY = dict(in_channels=4, patch_size=2, hidden_size=64, depth=2, num_heads=4,
            mlp_ratio=2.0, cross_attn_input_size=32)


def tiny_pipeline() -> FLitePipeline:
    """The tiny pipeline with seeded weights (fp32, CPU)."""
    return FLitePipeline(randomize_(DiT(DiTConfig(**TINY)), seed=0).eval(),
                         randomize_(AutoencoderKL(VAEConfig.tiny()), seed=1).eval())


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_model")
    tiny_pipeline().save_pretrained(d)
    return d


def _options(parser: argparse.ArgumentParser) -> dict:
    return {a.option_strings[0]: (tuple(a.option_strings), a.default, a.nargs,
                                  a.type, tuple(a.choices or ()), a.required,
                                  type(a).__name__)
            for a in parser._actions if a.option_strings != ["-h", "--help"]}


def _serve_parser(mod):
    """serve's parser, read back from `parse_args`."""
    parsers = []

    def parse(self, argv=None, namespace=None):
        parsers.append(self)
        return argparse.Namespace()

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = parse
    try:
        mod.parse_args([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return parsers[0]


@pytest.mark.parametrize("which", ["generate", "serve"])
def test_parsers_have_jax_options_and_defaults_plus_device(which):
    if which == "generate":
        jp, tp = jgenerate.build_parser(), tgenerate.build_parser()
    else:
        jp, tp = _serve_parser(jserve), _serve_parser(tserve)
    want, got = _options(jp), _options(tp)
    device = got.pop("--device")
    assert device[1] == "cuda"
    assert got == want


def test_generate_writes_numbered_files_and_from_png_restores_them(model_dir, tmp_path):
    out = tmp_path / "out.png"
    argv = ["--model", str(model_dir), "--prompt", "a cat", "--negative_prompt", "dull",
            "--width", "16", "--height", "16", "--num_inference_steps", "2",
            "--num_images", "2", "--seed", "5", "--no_text_encoder",
            "--output_file", str(out), "--device", "cpu", "--sampler", "ab2"]
    paths = tgenerate.main(argv)
    assert [p.name for p in paths] == ["out_1.png", "out_2.png"]
    images = [read_png(p.read_bytes()) for p in paths]
    assert images[0].shape == (16, 16, 3) and not np.array_equal(*images)
    meta = read_metadata(paths[1])
    assert meta["image_index"] == 2 and meta["num_images"] == 2
    assert meta["seed"] == 5 and meta["sampler"] == "ab2"

    # the direct pipeline call the flags stand for
    pipe = FLitePipeline.from_pretrained(model_dir, device="cpu")
    pipe.text_encoder = ZeroTextEncoder(32, seq_len=PSEUDO_TEXT_LEN)
    direct = pipe(prompt="a cat", negative_prompt="dull", height=16, width=16,
                  num_inference_steps=2, num_images_per_prompt=2, sampler="ab2",
                  generator=torch.Generator("cpu").manual_seed(5)).images
    for got, want in zip(images, direct):
        np.testing.assert_array_equal(got, want)

    again = tgenerate.main(["--from_png", str(paths[0]), "--device", "cpu",
                            "--no_text_encoder", "--output_file", str(tmp_path / "re.png")])
    assert [p.name for p in again] == ["re_1.png", "re_2.png"]
    for p, want in zip(again, images):
        np.testing.assert_array_equal(read_png(p.read_bytes()), want)
    with pytest.raises(SystemExit):
        tgenerate.main(["--model", str(model_dir), "--device", "cpu"])  # no prompt


def test_generate_image_to_image_and_mask(model_dir, tmp_path):
    """--image and --mask as PNG files written by the port."""
    from f_lite_tpu_torch.utils.image import png_bytes_with_metadata

    rs = np.random.RandomState(0)
    img = tmp_path / "in.png"
    img.write_bytes(png_bytes_with_metadata(rs.randint(0, 256, (16, 16, 3)).astype(np.uint8)))
    mask = tmp_path / "mask.png"
    m = np.zeros((8, 8, 3), np.uint8)
    m[:, 4:] = 255
    mask.write_bytes(png_bytes_with_metadata(m))
    base = ["--model", str(model_dir), "--prompt", "x", "--width", "16", "--height", "16",
            "--num_inference_steps", "4", "--no_text_encoder", "--device", "cpu",
            "--image", str(img), "--strength", "0.5"]
    (p1,) = tgenerate.main(base + ["--output_file", str(tmp_path / "i2i.png")])
    (p2,) = tgenerate.main(base + ["--mask", str(mask),
                                   "--output_file", str(tmp_path / "inpaint.png")])
    assert read_metadata(p1)["strength"] == 0.5
    assert read_metadata(p2)["mask"] == str(mask)
    assert not np.array_equal(read_png(p1.read_bytes()), read_png(p2.read_bytes()))
    with pytest.raises(SystemExit, match="requires --image"):
        tgenerate.main(["--model", str(model_dir), "--prompt", "x", "--device", "cpu",
                        "--mask", str(mask)])


WILDCARD_PROMPTS = ["a {red|green|blue} car", "{a {b|c}|d}", "a __animals__ sleeping",
                    "a __nope__ x", "plain prompt", "{__animals__|{x|y}} and __empty__"]


@pytest.mark.parametrize("seed", [0, 1, 2, 7])
def test_wildcards_equal_jax(tmp_path, seed):
    (tmp_path / "animals.txt").write_text("cat\ndog\n\n")
    (tmp_path / "empty.txt").write_text("\n")
    for prompt in WILDCARD_PROMPTS:
        assert tgui.expand_wildcards(prompt, random.Random(seed), wildcard_dir=tmp_path) == \
            jgui.expand_wildcards(prompt, random.Random(seed), wildcard_dir=tmp_path)


def test_compose_dated_path_controller_presets(tmp_path):
    for parts in (("cat", "photo of", "4k"), ("cat",), ("cat", "", "  ")):
        assert tgui.compose_prompt(*parts) == jgui.compose_prompt(*parts)
    p = tgui.dated_output_path(tmp_path)
    assert p.parent.parent == tmp_path
    assert re.match(r"\d{4}-\d{2}-\d{2}", p.parent.name) and p.suffix == ".png"
    c = tgui.GenerationController()
    assert not c.should_stop
    c.request_stop()
    assert c.should_stop
    c.reset()
    assert not c.should_stop
    assert tgui.PRESET_RESOLUTIONS == jgui.PRESET_RESOLUTIONS


def test_gui_imports_without_gradio():
    """`gradio` is on neither machine: the module imports, `main` exits
    with the install advice and `build_app` raises at its import."""
    with pytest.raises(SystemExit, match="gradio"):
        tgui.main(["--model", "x", "--device", "cpu"])
    with pytest.raises(ImportError):
        tgui.build_app("x")


def test_comfy_node_registration_and_inputs_equal_jax():
    assert tcomfy.NODE_CLASS_MAPPINGS["FLiteTPU"] is tcomfy.FLiteNode
    assert tcomfy.FLiteNode.INPUT_TYPES() == jcomfy.FLiteNode.INPUT_TYPES()
    assert tcomfy.MODEL_CHOICES == jcomfy.MODEL_CHOICES
    assert tcomfy.FLiteNode.RETURN_TYPES == ("IMAGE",)
    assert (tcomfy.FLiteNode.CATEGORY, tcomfy.FLiteNode.FUNCTION) == \
        (jcomfy.FLiteNode.CATEGORY, jcomfy.FLiteNode.FUNCTION)


def test_comfy_node_on_a_cached_pipeline(monkeypatch):
    pipe = tiny_pipeline()
    pipe.text_encoder = ZeroTextEncoder(32, 8)
    monkeypatch.setitem(tcomfy._PIPELINE_CACHE, ("fake", False), pipe)
    node = tcomfy.FLiteNode(device="cpu")
    (img,) = node.generate("fake", "a cat", "", 32, 32, 1, 6.0, 0, False, False)
    assert isinstance(img, torch.Tensor) and img.dtype == torch.float32
    arr = img.numpy()
    assert arr.shape == (1, 32, 32, 3) and arr.min() >= 0.0 and arr.max() <= 1.0
    # the same seed through the pipeline itself
    want = pipe(prompt="a cat", height=32, width=32, num_inference_steps=1,
                generator=torch.Generator("cpu").manual_seed(0), output_type="np").images
    np.testing.assert_array_equal(arr, np.clip(want / 2.0 + 0.5, 0.0, 1.0))

    # image to image with the node's own output, resized 32 -> 16
    (img2,) = node.generate("fake", "a dog", "", 16, 16, 2, 6.0, 1, False, False,
                            image=arr, strength=0.5)
    arr2 = img2.numpy()
    assert arr2.shape == (1, 16, 16, 3) and arr2.min() >= 0.0 and arr2.max() <= 1.0
    # B IMAGE frames: one variation a frame
    batch_in = np.concatenate([arr2, 1.0 - arr2])
    (img3,) = node.generate("fake", "a bird", "", 16, 16, 2, 6.0, 2, False, False,
                            image=torch.from_numpy(batch_in), strength=0.5)
    assert img3.shape == (2, 16, 16, 3)
    # a MASK (1 = repaint) for every frame, then one a frame
    m = np.zeros((16, 16), np.float32)
    m[:, 8:] = 1.0
    (img4,) = node.generate("fake", "a boat", "", 16, 16, 2, 6.0, 3, False, False,
                            image=batch_in, mask=m, strength=1.0)
    (img5,) = node.generate("fake", "a boat", "", 16, 16, 2, 6.0, 3, False, False,
                            image=batch_in, mask=np.stack([m, 1.0 - m]), strength=1.0)
    assert img4.shape == img5.shape == (2, 16, 16, 3)
    assert not torch.equal(img4, img5)


def test_comfy_node_mask_without_image_raises():
    with pytest.raises(ValueError, match="mask requires an image"):
        tcomfy.FLiteNode(device="cpu").generate(
            "fake", "x", "", 16, 16, 1, 6.0, 0, False, False,
            mask=np.ones((16, 16), np.float32))
