"""The port's pipeline against the JAX pipeline, end to end on the CPU.

- The committed trained fixture (pixel space, no VAE), loaded by both
  `from_pretrained` in fp32: 4 captions through `ZeroTextEncoder(64, 32)`,
  30 Euler steps at g=6 from the same numpy latents. Bar: image MSE < 1e-6.
  (60-80 s on an 8-core CPU, about 35-45 s of it the JAX trajectory and
  25-33 s the port's.)
- A tiny latent-space pipeline (DiT + VAE) written by the JAX
  `save_pretrained`: the port's uint8 images equal the JAX pipeline's PIL
  images, or differ by at most 1 where fp32 summation order moves a value
  across a rounding boundary.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f_lite_tpu.models import vae as jvae
from f_lite_tpu.models.dit import DiT as JaxDiT
from f_lite_tpu.models.dit import DiTConfig as JaxDiTConfig
from f_lite_tpu.ops.guidance import APGConfig as JaxAPG
from f_lite_tpu.pipeline import FLitePipeline as JaxPipeline
from f_lite_tpu.text.encoder import ZeroTextEncoder as JaxZeroTextEncoder
from f_lite_tpu_torch.ops.guidance import APGConfig
from f_lite_tpu_torch.pipeline import FLitePipeline, to_uint8
from f_lite_tpu_torch.text.encoder import ZeroTextEncoder
from test_torch_dit import random_jax_params, unflatten

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = str(ROOT / "artifacts" / "fixture_run" / "pipeline")


def test_zero_text_encoder_is_bit_identical():
    prompts = ["a red circle", "a white triangle", ""]
    want = JaxZeroTextEncoder(64, seq_len=32).encode(prompts)
    got = ZeroTextEncoder(64, seq_len=32).encode(prompts)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_fixture_30_steps_matches_jax():
    captions = ["a red circle", "a blue square", "a yellow triangle",
                "a white circle"]
    embeds, mask = ZeroTextEncoder(64, seq_len=32).encode(captions)
    latents = np.random.RandomState(0).randn(4, 64, 64, 3).astype(np.float32)

    jpipe = JaxPipeline.from_pretrained(FIXTURE, dtype=jnp.float32,
                                        load_text_encoder=False)
    want = np.asarray(jpipe(prompt_embeds=embeds, context_mask=mask,
                            latents=jnp.asarray(latents),
                            num_inference_steps=30,
                            guidance_scale=6.0).images)
    pipe = FLitePipeline.from_pretrained(FIXTURE, dtype=torch.float32,
                                         device="cpu")
    got = pipe(prompt_embeds=embeds, context_mask=mask, latents=latents,
               num_inference_steps=30, guidance_scale=6.0,
               output_type="np").images
    assert got.shape == want.shape == (4, 64, 64, 3)
    mse = float(((got - want) ** 2).mean())
    assert mse < 1e-6, mse


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    """A latent-space pipeline (tiny DiT + tiny VAE) saved by the JAX
    package, with seeded non-zero weights."""
    path = tmp_path_factory.mktemp("tiny_pipe")
    cfg = JaxDiTConfig(in_channels=4, patch_size=2, hidden_size=64, depth=3,
                       num_heads=4, mlp_ratio=2.0, cross_attn_input_size=32,
                       residual_v=True, cross_attn_first_n=1,
                       cross_attn_period=2)
    params = {"params": unflatten(random_jax_params(cfg, seed=11))}
    vcfg = jvae.VAEConfig.tiny()
    vae = jvae.AutoencoderKL(vcfg)
    vparams = vae.init(jax.random.key(1), jnp.zeros((1, 8, 8, 3)))
    JaxPipeline(JaxDiT(cfg), params, vae, vparams).save_pretrained(path)
    return path


CASES = {
    "cfg": dict(),
    "apg": dict(apg=True),
    "short_negative": dict(neg_len=4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tiny_latent_pipeline_uint8_matches_jax(tiny_dir, case):
    opts = CASES[case]
    rs = np.random.RandomState(5)
    embeds = rs.randn(2, 8, 32).astype(np.float32)
    mask = np.arange(8)[None, :] < np.array([8, 5])[:, None]
    neg = None
    if "neg_len" in opts:
        neg = rs.randn(2, opts["neg_len"], 32).astype(np.float32)
    latents = rs.randn(2, 8, 8, 4).astype(np.float32)
    kw = dict(prompt_embeds=embeds, context_mask=mask, negative_embeds=neg,
              latents=latents, num_inference_steps=6, guidance_scale=4.0)

    jpipe = JaxPipeline.from_pretrained(tiny_dir, dtype=jnp.float32,
                                        load_text_encoder=False)
    want = np.stack([np.asarray(im) for im in jpipe(
        **{**kw, "latents": jnp.asarray(latents)}, apg_config=JaxAPG() if opts.get("apg") else None,
        output_type="pil").images])
    pipe = FLitePipeline.from_pretrained(tiny_dir, dtype=torch.float32,
                                         device="cpu")
    got = pipe(**kw, apg_config=APGConfig() if opts.get("apg") else None,
               output_type="uint8").images
    assert got.dtype == np.uint8 and got.shape == want.shape == (2, 16, 16, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() > 0.99


def test_pad_context_and_images_per_prompt(tiny_dir):
    pipe = FLitePipeline.from_pretrained(tiny_dir, dtype=torch.float32,
                                         device="cpu")
    rs = np.random.RandomState(6)
    embeds = rs.randn(1, 5, 32).astype(np.float32)
    latents = rs.randn(2, 8, 8, 4).astype(np.float32)
    kw = dict(prompt_embeds=embeds, latents=latents, num_inference_steps=3,
              num_images_per_prompt=2, output_type="latent")
    base = pipe(**kw).images
    padded = pipe(**kw, pad_context_to=16).images
    torch.testing.assert_close(padded, base, atol=1e-6, rtol=0)
    assert base.shape == (2, 8, 8, 4)


def test_uint8_rounds_half_to_even():
    # (x*0.5+0.5)*255 lands exactly on k + 0.5 for these x in fp32
    k = np.arange(0, 255, dtype=np.float32)
    x = ((k + 0.5) / 255.0 - 0.5) / 0.5
    want = np.round(np.clip(x * 0.5 + 0.5, 0, 1) * 255.0).astype(np.uint8)
    got = to_uint8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)



def test_safetensors_reader_matches_the_library(tmp_path):
    from safetensors.numpy import load_file as lib_load
    from safetensors.torch import save_file

    from f_lite_tpu_torch.utils.safetensors import load_file

    fixture = f"{FIXTURE}/dit/flax_params.safetensors"
    ours, ref = load_file(fixture), lib_load(fixture)
    assert set(ours) == set(ref) and len(ours) == 87
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)

    g = torch.Generator().manual_seed(0)
    tensors = {
        "bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
        "f16": torch.randn(7, generator=g).to(torch.float16),
        "f32": torch.randn(2, 2, 2, generator=g),
    }
    save_file(tensors, tmp_path / "mixed.safetensors", metadata={"a": "b"})
    got = load_file(tmp_path / "mixed.safetensors")
    for k, t in tensors.items():
        np.testing.assert_array_equal(got[k].astype(np.float32), t.float().numpy())
    assert got["f16"].dtype == np.float16 and got["bf16"].dtype == np.float32


def test_chip_smoke_classifier_is_the_fixture_audits():
    import importlib.util

    import chip_smoke

    spec = importlib.util.spec_from_file_location(
        "fixture_quality_audit", ROOT / "tools" / "fixture_quality_audit.py")
    audit = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(audit)
    assert chip_smoke.COLORS == audit.COLORS
    assert chip_smoke.SHAPES == audit.SHAPES
    assert chip_smoke.BACKGROUND == audit.BACKGROUND
    rs = np.random.RandomState(0)
    for i in range(40):
        img = np.full((32, 32, 3), 110 / 127.5 - 1.0, np.float32)
        y0, x0 = rs.randint(0, 12, size=2)
        size = rs.randint(6, 20)
        img[y0:y0 + size, x0:x0 + size] = rs.uniform(-1, 1, size=3)
        if i % 3 == 0:
            img[y0:y0 + size, x0:x0 + size // 2] = 110 / 127.5 - 1.0
        img += 0.05 * rs.randn(*img.shape).astype(np.float32)
        assert chip_smoke.classify(img) == audit.classify(img)
