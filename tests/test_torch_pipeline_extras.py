"""The port's pipeline extras against the JAX pipeline, on the CPU in fp32:
checkpoint layouts at load, image and mask preprocessing, image to image,
inpainting, guidance interval and sampler on `__call__`, and the decode by
VAE memory mode.

Random draws differ between the packages (`torch.Generator` against
`jax.random`), so the end-to-end comparisons either give both the same
`latents` or compare what the noise cannot reach (the kept region of an
inpainting run ends on the encoded image exactly).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from f_lite_tpu import pipeline as jpipeline
from f_lite_tpu.models import vae as jvae
from f_lite_tpu.models.dit import DiT as JaxDiT
from f_lite_tpu.models.dit import DiTConfig as JaxDiTConfig
from f_lite_tpu.parallel.pipeline import scan_to_pipeline_params
from f_lite_tpu.pipeline import FLitePipeline as JaxPipeline
from f_lite_tpu_torch import pipeline as tpipeline
from f_lite_tpu_torch.models import vae as tvae
from f_lite_tpu_torch.pipeline import FLitePipeline
from f_lite_tpu_torch.sampling import euler as tsampling
from test_torch_dit import random_jax_params, unflatten

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "artifacts" / "fixture_run" / "pipeline"

TINY = dict(in_channels=4, patch_size=2, hidden_size=64, depth=3, num_heads=4,
            mlp_ratio=2.0, cross_attn_input_size=32, residual_v=True,
            cross_attn_first_n=1, cross_attn_period=2)


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    """A latent-space pipeline (tiny DiT + tiny VAE, scale /2) saved by the
    JAX package, with seeded non-zero weights."""
    path = tmp_path_factory.mktemp("tiny_pipe")
    cfg = JaxDiTConfig(**TINY)
    params = {"params": unflatten(random_jax_params(cfg, seed=11))}
    vae = jvae.AutoencoderKL(jvae.VAEConfig.tiny())
    vparams = vae.init(jax.random.key(1), jnp.zeros((1, 8, 8, 3)))
    JaxPipeline(JaxDiT(cfg), params, vae, vparams).save_pretrained(path)
    return path


@pytest.fixture(scope="module")
def pipes(tiny_dir):
    return (JaxPipeline.from_pretrained(tiny_dir, dtype=jnp.float32,
                                        load_text_encoder=False),
            FLitePipeline.from_pretrained(tiny_dir, dtype=torch.float32, device="cpu"))


def _embeds(seed=5, batch=1):
    rs = np.random.RandomState(seed)
    return rs.randn(batch, 8, 32).astype(np.float32)


# ---------------------------------------------------------------------------
# checkpoint layouts
# ---------------------------------------------------------------------------

LAYOUTS = {
    "scan": (dict(), dict(scan_layers=True)),
    "scan_padded_heads": (dict(), dict(scan_layers=True, pad_heads_to=6)),
    "pipeline_2_padded_heads": (dict(), dict(scan_layers=True, pad_heads_to=8, pp=2)),
    "unrolled_padded_heads": (dict(), dict(scan_layers=False, pad_heads_to=8)),
    "v2_pipeline_2": (dict(adaln_mode="per_block", cross_attn_all=True, depth=4),
                      dict(scan_layers=True, pp=2)),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_saved_layouts_load_in_the_port(tmp_path, layout):
    """A pipeline the JAX package saves in the scan layout, folded to 2
    pipeline stages, or with padded heads loads in the port, whose DiT
    then gives the JAX `DiT.apply` output (unrolled, unpadded) within MSE
    1e-9."""
    cfg_kw, load_kw = LAYOUTS[layout]
    pp = load_kw.pop("pp", 1)
    cfg = JaxDiTConfig(**{**TINY, "depth": 5, **cfg_kw}, use_pallas_attention=False)
    flat = random_jax_params(cfg, seed=len(layout))
    JaxPipeline(JaxDiT(cfg), {"params": unflatten(flat)}).save_pretrained(tmp_path / "u")
    jp = JaxPipeline.from_pretrained(tmp_path / "u", dtype=jnp.float32,
                                     load_text_encoder=False, **load_kw)
    jcfg, jparams = jp.dit_model.config, jp.dit_params
    assert jcfg.scan_layers == load_kw["scan_layers"]
    if pp > 1:
        jcfg = dataclasses.replace(jcfg, pipeline_stages=pp)
        jparams = scan_to_pipeline_params(jparams, pp)
    JaxPipeline(JaxDiT(jcfg), jparams).save_pretrained(tmp_path / "saved")

    pipe = FLitePipeline.from_pretrained(tmp_path / "saved", dtype=torch.float32,
                                         device="cpu")
    rs = np.random.RandomState(2)
    x = rs.randn(2, 16, 16, 4).astype(np.float32)
    ctx = rs.randn(2, 8, 32).astype(np.float32)
    mask = np.arange(8)[None, :] < np.array([8, 5])[:, None]
    t = rs.rand(2).astype(np.float32)
    want = np.asarray(JaxDiT(cfg).apply({"params": unflatten(flat)}, jnp.asarray(x),
                                        jnp.asarray(ctx), jnp.asarray(mask),
                                        jnp.asarray(t)))
    with torch.no_grad():
        got = pipe.dit(*map(torch.from_numpy, (x, ctx, mask, t))).numpy()
    assert np.abs(want).max() > 1e-2
    assert float(((got - want) ** 2).mean()) < 1e-9


# ---------------------------------------------------------------------------
# image and mask preprocessing
# ---------------------------------------------------------------------------

def _image_cases():
    rs = np.random.RandomState(0)
    u8 = rs.randint(0, 256, (16, 24, 3)).astype(np.uint8)
    unit = rs.rand(16, 24, 3).astype(np.float32)
    signed = (rs.rand(16, 24, 3) * 2.2 - 1.1).astype(np.float32)
    return {
        "uint8": u8,
        "unit_float": unit,
        "signed_float_clipped": signed,
        "batch_uint8": u8[None].repeat(2, 0),
        "list_signed_classifies_the_batch": [signed, unit],
        "pil_resized": Image.fromarray(rs.randint(0, 256, (30, 20, 3)).astype(np.uint8)),
    }


@pytest.mark.parametrize("case", list(_image_cases()))
def test_preprocess_image_matches_jax(case):
    image = _image_cases()[case]
    want = jpipeline._preprocess_image(image, 16, 24)
    got = tpipeline._preprocess_image(image, 16, 24)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _mask_cases():
    rs = np.random.RandomState(1)
    grid = np.zeros((8, 12), np.uint8)
    grid[:, :6] = 255
    return {
        "uint8_at_latent_grid": grid,
        "unit_float_truncated": rs.rand(8, 12).astype(np.float32),
        "float_with_ringing": np.clip(rs.rand(8, 12), 0, 1).astype(np.float32)
        * np.where(rs.rand(8, 12) > 0.9, 1.0 + 1e-6, 1.0).astype(np.float32),
        "hwc_resized": (rs.rand(16, 24, 1) * 255).astype(np.uint8),
        "pil_resized": Image.fromarray(rs.randint(0, 256, (16, 24)).astype(np.uint8), "L"),
        "list": [grid, rs.rand(8, 12).astype(np.float32)],
    }


@pytest.mark.parametrize("case", list(_mask_cases()))
def test_preprocess_mask_matches_jax(case):
    mask = _mask_cases()[case]
    batch = 2
    want = jpipeline._preprocess_mask(mask, 8, 12, batch)
    got = tpipeline._preprocess_mask(mask, 8, 12, batch)
    assert got.dtype == np.float32 and got.shape == want.shape == (batch, 8, 12, 1)
    np.testing.assert_array_equal(got, want)


def test_preprocess_refuses_what_jax_refuses():
    for fn in (jpipeline._preprocess_image, tpipeline._preprocess_image):
        with pytest.raises(ValueError, match="float image values"):
            fn(np.full((16, 16, 3), 3.7, np.float32), 16, 16)
        with pytest.raises(ValueError, match="requested"):
            fn(np.zeros((8, 16, 3), np.uint8), 16, 16)
    for fn in (jpipeline._preprocess_mask, tpipeline._preprocess_mask):
        with pytest.raises(ValueError, match="mask values"):
            fn(np.full((8, 8), 128.0, np.float32), 8, 8, 1)
        with pytest.raises(ValueError, match="masks for batch"):
            fn([np.zeros((8, 8), np.uint8)] * 3, 8, 8, 2)


# ---------------------------------------------------------------------------
# __call__: image to image, inpainting, guidance interval, sampler, memory modes
# ---------------------------------------------------------------------------

def test_strength_one_is_text_to_image_bitwise(pipes):
    _, pipe = pipes
    kw = dict(prompt_embeds=_embeds(), height=16, width=16, num_inference_steps=3,
              output_type="np")
    a = pipe(**kw, image=np.full((16, 16, 3), 90, np.uint8), strength=1.0,
             generator=torch.Generator().manual_seed(9)).images
    b = pipe(**kw, generator=torch.Generator().manual_seed(9)).images
    np.testing.assert_array_equal(a, b)
    c = pipe(**kw, image=np.full((16, 16, 3), 90, np.uint8), strength=0.5,
             generator=torch.Generator().manual_seed(9)).images
    assert not np.array_equal(a, c)


def test_inpaint_kept_region_matches_jax(pipes):
    """The kept region of the final latents is the encoded image in both
    packages (noise cannot reach it at t_next = 0): port against JAX, with
    the mask given at the latent grid and as a resized PIL image."""
    jpipe, pipe = pipes
    rs = np.random.RandomState(3)
    img = rs.randint(0, 256, (16, 16, 3)).astype(np.uint8)
    grid = np.zeros((8, 8), np.uint8)
    grid[:, :4] = 255  # repaint the left half
    kw = dict(prompt_embeds=_embeds(), height=16, width=16, num_inference_steps=4,
              image=img, mask_image=grid)
    for strength in (1.0, 0.5):
        want = np.asarray(jpipe(**kw, strength=strength, seed=1,
                                return_latents=True).images)
        got = pipe(**kw, strength=strength, output_type="latent").images.numpy()
        np.testing.assert_allclose(got[:, :, 4:], want[:, :, 4:], atol=1e-5, rtol=0)
        x = torch.from_numpy(tpipeline._preprocess_image(img, 16, 16))
        with torch.no_grad():
            enc = tvae.normalize_latents(pipe.vae.encode(x).float(), pipe.vae.config)
        np.testing.assert_array_equal(got[:, :, 4:], enc.numpy()[:, :, 4:])
        assert not np.allclose(got[:, :, :4], enc.numpy()[:, :, :4])


@pytest.mark.parametrize("opts", [dict(guidance_interval=(0.3, 0.8)),
                                  dict(sampler="ab2"),
                                  dict(sampler="ab2", guidance_interval=(0.2, 0.9))])
def test_interval_and_sampler_match_jax(pipes, opts):
    jpipe, pipe = pipes
    latents = np.random.RandomState(4).randn(1, 8, 8, 4).astype(np.float32)
    kw = dict(prompt_embeds=_embeds(), num_inference_steps=6, guidance_scale=4.0,
              **opts)
    want = np.asarray(jpipe(**kw, latents=jnp.asarray(latents),
                            return_latents=True).images)
    got = pipe(**kw, latents=latents, output_type="latent").images.numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("sampler", ["euler", "ab2"])
def test_steps_per_dispatch_and_callback_match_jax(pipes, sampler):
    """`steps_per_dispatch=3` with a callback under a guidance interval:
    images within 1e-5 of JAX's, the same (done, total) calls, bit-equal to
    one window (0) and to the automatic size (None); a callback that
    cancels after the first window decodes the latents reached, as JAX's
    does."""
    jpipe, pipe = pipes
    latents = np.random.RandomState(6).randn(1, 8, 8, 4).astype(np.float32)
    kw = dict(prompt_embeds=_embeds(), height=16, width=16, num_inference_steps=7,
              guidance_scale=4.0, guidance_interval=(0.2, 0.9), sampler=sampler,
              output_type="np")

    def both(callback_result, steps_per_dispatch=3):
        jcalls, tcalls = [], []
        want = np.asarray(jpipe(**kw, latents=jnp.asarray(latents),
                                steps_per_dispatch=steps_per_dispatch,
                                callback=lambda d, t: jcalls.append((d, t)) or callback_result
                                ).images)
        got = pipe(**kw, latents=latents, steps_per_dispatch=steps_per_dispatch,
                   callback=lambda d, t: tcalls.append((d, t)) or callback_result).images
        assert tcalls == jcalls
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        return got, tcalls

    got, calls = both(False)
    assert len(calls) > 2 and calls[-1] == (7, 7)
    np.testing.assert_array_equal(got, pipe(**kw, latents=latents, steps_per_dispatch=0).images)
    np.testing.assert_array_equal(got, pipe(**kw, latents=latents).images)
    cancelled, calls = both(True)
    assert len(calls) == 1
    assert not np.allclose(cancelled, got, atol=1e-3)
    _, calls = both(False, steps_per_dispatch=None)  # one window a segment
    assert [d for d, _ in calls] == [e for _, e, _ in tsampling.interval_segments(
        tsampling.DenoiseSettings(num_inference_steps=7, guidance_interval=(0.2, 0.9)),
        tsampling.full_schedule(tsampling.DenoiseSettings(num_inference_steps=7), 8, 8))]


@pytest.mark.parametrize("mode", ["tiled", "sliced", "direct"])
def test_decode_by_memory_mode_matches_jax(pipes, mode, monkeypatch):
    """72 px (36 latents with the tiny VAE) in each memory mode; tiled with
    16-latent tiles is 3x3 tiles, blended."""
    jpipe, pipe = pipes
    for p in (jpipe, pipe):
        monkeypatch.setattr(p, "_decode_mode", mode)
        monkeypatch.setattr(p, "_tile_latent_size", 16)
    latents = np.random.RandomState(6).randn(2, 36, 36, 4).astype(np.float32)
    kw = dict(prompt_embeds=_embeds(batch=2), height=72, width=72,
              num_inference_steps=1)
    want = np.asarray(jpipe(**kw, latents=jnp.asarray(latents), output_type="np").images)
    got = pipe(**kw, latents=latents, output_type="np").images
    assert got.shape == want.shape == (2, 72, 72, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_auto_mode_tiles_encode_and_decode_past_the_threshold(pipes, monkeypatch):
    _, pipe = pipes
    calls = []
    for name in ("encode_tiled", "decode_tiled"):
        real = getattr(tpipeline, name)
        monkeypatch.setattr(tpipeline, name,
                            lambda *a, _r=real, _n=name, **k:
                            calls.append((_n, k["tile_latent_size"])) or _r(*a, **k))
    monkeypatch.setattr(tvae, "AUTO_TILE_LATENTS", 16)
    monkeypatch.setattr(pipe, "_tile_latent_size", 8)  # one tile size for both
    img = np.random.RandomState(7).randint(0, 256, (40, 40, 3)).astype(np.uint8)
    out = pipe(prompt_embeds=_embeds(), height=40, width=40, num_inference_steps=2,
               image=img, strength=0.5, output_type="np").images
    assert out.shape == (1, 40, 40, 3) and np.isfinite(out).all()
    assert calls == [("encode_tiled", 8), ("decode_tiled", 8)]


def test_image_arguments_are_checked(pipes):
    _, pipe = pipes
    img = np.full((16, 16, 3), 60, np.uint8)
    kw = dict(prompt_embeds=_embeds(), height=16, width=16, num_inference_steps=2)
    with pytest.raises(ValueError, match="requires image"):
        pipe(**kw, mask_image=np.zeros((8, 8), np.uint8))
    with pytest.raises(ValueError, match="not both"):
        pipe(**kw, image=img, latents=np.zeros((1, 8, 8, 4), np.float32))
    with pytest.raises(ValueError, match="strength"):
        pipe(**kw, image=img, strength=0.0)
    with pytest.raises(ValueError, match="got 3 images"):
        pipe(**kw, image=[img] * 3, strength=0.5)
    with pytest.raises(ValueError, match="method"):
        pipe(**kw, sampler="heun")
    pixel = FLitePipeline.from_pretrained(FIXTURE, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="requires a VAE"):
        pixel(prompt_embeds=np.zeros((1, 4, 64), np.float32), height=16, width=16,
              image=img)
