"""FLitePipeline in PyTorch (counterpart of `f_lite_tpu/pipeline.py`).

Serving path: load a native pipeline directory, take text embeddings, run
the CFG-batched trajectory (Euler or ab2, optionally with limited-interval
guidance) through the DiT, decode with the VAE and return images; with an
input image, encode it and start part-way (image to image), optionally
repainting only a masked region (inpainting).

Directory layout (as written by the JAX package's `save_pretrained`):
  {root}/model_index.json
  {root}/dit/config.json + flax_params.safetensors  (unrolled, scan-stacked
      or pipeline-parallel layout, heads padded or not)
  {root}/vae/config.json + flax_params.safetensors  (optional)
With no `vae/` the pipeline runs in pixel space (`IdentityVAE`), and
height/width are the DiT's own input size.

Images and masks given as arrays go through numpy; PIL is imported only for
a PIL input, a mask that needs resizing, or `output_type="pil"`.

The pipeline runs on `device="cuda"` unless the caller asks for the CPU;
without a card it raises instead of falling back.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from f_lite_tpu_torch.convert.from_jax import (
    state_dict_from_jax,
    vae_state_dict_from_jax,
)
from f_lite_tpu_torch.models.dit import DiT, DiTConfig
from f_lite_tpu_torch.models.vae import (
    AutoencoderKL,
    IdentityVAE,
    VAEConfig,
    decode_sliced,
    decode_tiled,
    denormalize_latents,
    encode_sliced,
    encode_tiled,
    normalize_latents,
    resolve_memory_mode,
)
from f_lite_tpu_torch.ops.guidance import APGConfig
from f_lite_tpu_torch.quant import quantize_dit
from f_lite_tpu_torch.sampling.euler import (
    DenoiseSettings,
    denoise,
    schedule_start_time,
)
from f_lite_tpu_torch.utils.safetensors import load_file

OUTPUT_TYPES = ("latent", "np", "uint8", "pil")


@dataclasses.dataclass
class FLitePipelineOutput:
    images: Any


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


def _pad_seq(emb: np.ndarray, mask: np.ndarray, target: int):
    if emb.shape[1] == target:
        return emb, mask
    pad = target - emb.shape[1]
    return (np.pad(emb, ((0, 0), (0, pad), (0, 0))),
            np.pad(mask, ((0, 0), (0, pad))))


def _is_pil(x) -> bool:
    return type(x).__module__.split(".")[0] == "PIL"


def _preprocess_image(image, height: int, width: int, _signed=None) -> np.ndarray:
    """PIL image / (H, W, 3) array / list of either -> (B0, H, W, 3) fp32 in
    [-1, 1], as `f_lite_tpu.pipeline._preprocess_image` does.

    uint8 arrays are [0, 255]. A float array with a negative value is taken
    as [-1, 1] (clipped; values past 2.5 raise), otherwise as [0, 1]
    (values past 1.001 raise); a list is classified as a whole. Arrays must
    have the requested size; a PIL image is resized (bilinear)."""
    if isinstance(image, (list, tuple)):
        float_mins = [float(np.asarray(i).min()) for i in image
                      if isinstance(i, np.ndarray) and i.dtype.kind == "f"]
        signed_all = bool(float_mins) and min(float_mins) < 0.0
        arrs = [_preprocess_image(
            i, height, width,
            _signed=signed_all if isinstance(i, np.ndarray) and i.dtype.kind == "f"
            else None)[0] for i in image]
        return np.ascontiguousarray(np.stack(arrs), np.float32)
    signed = False
    if _is_pil(image):
        image = image.convert("RGB")
        if image.size != (width, height):
            image = image.resize((width, height), 2)  # bilinear
        x = np.asarray(image, np.float32)[None] / 255.0
    else:
        x = np.asarray(image)
        if x.ndim == 3:
            x = x[None]
        if x.shape[1] != height or x.shape[2] != width:
            raise ValueError(f"array image {x.shape[1:3]} != requested "
                             f"({height}, {width}): resize it or pass a PIL image")
        if x.dtype == np.uint8:
            x = x.astype(np.float32) / 255.0
        else:
            x = x.astype(np.float32)
            mn, mx = float(x.min()), float(x.max())
            if _signed and mn >= 0.0:
                if mx > 1.001:
                    raise ValueError(f"float image values in [{mn:.3g}, {mx:.3g}] "
                                     "in a [-1, 1]-classified batch")
                signed = True
            elif mn < 0.0:
                if mn < -2.5 or mx > 2.5:
                    raise ValueError(f"float image values in [{mn:.3g}, {mx:.3g}]: "
                                     "expected [0, 1] or [-1, 1]")
                x = np.clip(x, -1.0, 1.0)
                signed = True
            elif mx > 1.001:
                raise ValueError(f"float image values in [0, {mx:.3g}]: expected "
                                 "[0, 1]; pass uint8 (or divide by 255) for [0, 255]")
    if not signed:
        x = x * 2.0 - 1.0
    return np.ascontiguousarray(x, np.float32)


def _preprocess_mask(mask, lh: int, lw: int, batch: int) -> np.ndarray:
    """Inpaint mask -> (B, lh, lw, 1) fp32 in [0, 1] at the latent grid, as
    `f_lite_tpu.pipeline._preprocess_mask` does. White (1) = repaint, black
    (0) = keep; soft values blend. A PIL image, an (H, W[, 1]) uint8 or
    [0, 1] float array, or a list of either; a float mask is quantised to
    uint8 by truncation; a mask off the latent grid is resized (bilinear,
    through PIL)."""
    if isinstance(mask, (list, tuple)):
        x = np.stack([_preprocess_mask(i, lh, lw, 1)[0] for i in mask])
    else:
        if _is_pil(mask):
            a = np.asarray(mask.convert("L"))
        else:
            a = np.asarray(mask)
            if a.ndim == 3:
                a = a[..., 0]
            if a.dtype != np.uint8:
                af = a.astype(np.float32)
                mn, mx = float(af.min()), float(af.max())
                if mn < -0.001 or mx > 1.001:
                    raise ValueError(f"mask values in [{mn:.3g}, {mx:.3g}]: expected "
                                     "[0, 1] for float/int masks; pass uint8 (or "
                                     "divide by 255) for [0, 255]")
                a = np.clip(af * 255.0, 0, 255).astype(np.uint8)
        if a.shape != (lh, lw):
            from PIL import Image as PILImage

            a = np.asarray(PILImage.fromarray(a, "L").resize((lw, lh), 2))
        x = a.astype(np.float32)[None, :, :, None] / 255.0
    if x.shape[0] == 1 and batch > 1:
        x = np.broadcast_to(x, (batch, *x.shape[1:]))
    if x.shape[0] != batch:
        raise ValueError(f"got {x.shape[0]} masks for batch {batch}")
    return np.ascontiguousarray(x, np.float32)


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] images -> uint8: round(clip(x*0.5+0.5, 0, 1)*255), rounding
    half to even (torch.round), as the JAX pipeline does."""
    x = torch.clamp(images.float() * 0.5 + 0.5, 0.0, 1.0) * 255.0
    return torch.round(x).to(torch.uint8)


class FLitePipeline:
    def __init__(self, dit: DiT, vae: AutoencoderKL | None = None):
        self.dit = dit
        self.vae = vae if vae is not None else IdentityVAE()
        self.vae_scale_factor = self.vae.config.spatial_scale
        # VAE memory mode (models.vae.MEMORY_MODES): "auto" encodes and
        # decodes whole up to AUTO_TILE_LATENTS latents and tiled past them
        self._decode_mode = "auto"
        self._tile_latent_size = 64  # encode and decode tile edge, in latents

    def enable_vae_slicing(self):
        self._decode_mode = "sliced"

    def enable_vae_tiling(self):
        self._decode_mode = "tiled"

    def _encode_image_latents(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) [-1, 1] pixels -> raw posterior means, in the memory
        mode (tiled past AUTO_TILE_LATENTS under "auto")."""
        mode = resolve_memory_mode(
            self._decode_mode, max(x.shape[1], x.shape[2]) // self.vae_scale_factor)
        if mode == "tiled":
            return encode_tiled(self.vae, x, tile_latent_size=self._tile_latent_size)
        if mode == "sliced":
            return encode_sliced(self.vae, x)
        return self.vae.encode(x)

    def _decode(self, final: torch.Tensor) -> torch.Tensor:
        """Final latents -> [-1, 1] images (B, H, W, 3), in the memory mode."""
        z = denormalize_latents(final.float(), self.vae.config)
        if isinstance(self.vae, IdentityVAE):
            return z
        mode = resolve_memory_mode(self._decode_mode, max(z.shape[1:3]))
        if mode == "tiled":
            return decode_tiled(self.vae, z, tile_latent_size=self._tile_latent_size)
        if mode == "sliced":
            return decode_sliced(self.vae, z)
        return self.vae.decode(z)

    @property
    def device(self) -> torch.device:
        return self.dit.context_proj.weight.device

    @classmethod
    def from_pretrained(cls, path: str | Path, *, dtype=torch.bfloat16,
                        device="cuda", quantize: bool = False) -> "FLitePipeline":
        """Load a native pipeline directory. The DiT runs in `dtype`; the
        VAE, as in the JAX package, in fp32.

        `quantize=True`: int8 W8A8 projections (`quant.quantize_dit`),
        quantized from the weights after their cast to `dtype`, as the JAX
        package does; the argument decides, whatever the saved config says.
        A checkpoint saved with int8 weights loads only with it."""
        device = resolve_device(device)
        path = Path(path)
        json.loads((path / "model_index.json").read_text())
        flat = load_file(path / "dit" / "flax_params.safetensors")
        saved_int8 = any(k.endswith(".w8") for k in flat)
        if saved_int8 and not quantize:
            raise ValueError(f"{path}: the DiT's weights are int8; load it "
                             "with quantize=True")
        cfg = dataclasses.replace(DiTConfig.from_json_dict(
            json.loads((path / "dit" / "config.json").read_text())
        ), quantized=saved_int8)
        dit = DiT(cfg)
        dit.load_state_dict(state_dict_from_jax(flat, cfg))
        del flat
        dit = dit.to(device=device, dtype=dtype).eval()
        if quantize:
            quantize_dit(dit)
        vae = None
        if (path / "vae" / "config.json").exists():
            vcfg = VAEConfig.from_json_dict(
                json.loads((path / "vae" / "config.json").read_text())
            )
            vae = AutoencoderKL(vcfg)
            vae.load_state_dict(vae_state_dict_from_jax(
                load_file(path / "vae" / "flax_params.safetensors"), vcfg
            ))
            vae = vae.to(device).eval()
        return cls(dit, vae)

    @staticmethod
    def _context(prompt_embeds, negative_embeds, context_mask,
                 negative_context_mask):
        """(embeds, neg, mask, neg_mask) as numpy: a zero negative when none
        is given, and the negative aligned to the prompt's length (a
        zero-padded key carries mask 0)."""
        embeds = np.asarray(prompt_embeds, np.float32)
        neg = (np.asarray(negative_embeds, np.float32)
               if negative_embeds is not None else np.zeros_like(embeds))
        mask = (np.asarray(context_mask, bool) if context_mask is not None
                else np.ones(embeds.shape[:2], bool))
        if negative_context_mask is not None:
            neg_mask = np.asarray(negative_context_mask, bool)
        elif neg.shape[1] == embeds.shape[1]:
            neg_mask = mask
        else:
            neg_mask = np.ones(neg.shape[:2], bool)
        if neg.shape[1] != embeds.shape[1]:
            s = max(embeds.shape[1], neg.shape[1])
            embeds, mask = _pad_seq(embeds, mask, s)
            neg, neg_mask = _pad_seq(neg, neg_mask, s)
        return embeds, neg, mask, neg_mask

    @torch.no_grad()
    def __call__(
        self,
        prompt_embeds,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 30,
        guidance_scale: float = 6.0,
        num_images_per_prompt: int = 1,
        generator: torch.Generator | None = None,
        alpha: float | None = None,
        apg_config: APGConfig | None = None,
        negative_embeds=None,
        context_mask=None,
        negative_context_mask=None,
        latents=None,
        output_type: str = "uint8",
        pad_context_to: int | None = None,
        image=None,
        strength: float = 0.8,
        mask_image=None,
        guidance_interval: tuple | None = None,
        sampler: str = "euler",
    ) -> FLitePipelineOutput:
        """Generate images (B, height, width, 3) from text embeddings
        `prompt_embeds` (B, S, C), with `context_mask` (B, S) bool (True =
        real token; default all real).

        `latents` (B, h, w, C) NHWC replaces the starting noise; otherwise
        it is drawn from `generator` (a seed-0 generator when None) in the
        DiT's dtype. `output_type`: "latent" (the final latents, a tensor on
        the device), "np" (float32 in [-1, 1]), "uint8", or "pil" (needs
        PIL). `pad_context_to` zero-pads the text context up to the next
        multiple of this length; padded keys carry mask 0, so it is exact.

        - `image` + `strength`: image to image. `image` (see
          `_preprocess_image`) is encoded to its posterior mean and noised
          to the schedule's t at row N - max(1, min(N, round(strength N))),
          z = (1 - t) x + t eps, and the remaining rows run. strength 1.0
          without a mask skips the encode and is text to image, bitwise.
        - `mask_image` (with `image`): inpainting; white = repaint, black =
          keep (`_preprocess_mask`). After every step the kept region is
          put back at the step's marginal with fresh noise, so it ends on
          the encoded latents exactly.
        - `guidance_interval=(lo, hi)`: CFG only while t is in [lo, hi],
          the conditional forward alone elsewhere.
        - `sampler`: "euler" or "ab2" (`sampling.euler.SAMPLERS`).
        The noise of image to image and inpainting comes from `generator`
        after the start noise.
        """
        if output_type not in OUTPUT_TYPES:
            raise ValueError(f"output_type must be one of {OUTPUT_TYPES}")
        device = self.device
        dtype = self.dit.dtype
        apg = apg_config if (apg_config and apg_config.enabled) else None

        embeds, neg, mask, neg_mask = self._context(
            prompt_embeds, negative_embeds, context_mask,
            negative_context_mask,
        )
        if pad_context_to:
            t = -(-embeds.shape[1] // pad_context_to) * pad_context_to
            embeds, mask = _pad_seq(embeds, mask, t)
            neg, neg_mask = _pad_seq(neg, neg_mask, t)
        if num_images_per_prompt > 1:
            embeds, neg, mask, neg_mask = (
                np.repeat(a, num_images_per_prompt, axis=0)
                for a in (embeds, neg, mask, neg_mask)
            )

        batch = embeds.shape[0]
        lh, lw = height // self.vae_scale_factor, width // self.vae_scale_factor
        lat_shape = (batch, lh, lw, self.dit.config.in_channels)
        settings = DenoiseSettings(
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, apg=apg, alpha=alpha,
            guidance_interval=tuple(guidance_interval) if guidance_interval else None,
            method=sampler,
        )
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        start_step, inpaint = 0, None
        if mask_image is not None and image is None:
            raise ValueError("mask_image requires image")
        if image is not None:
            if latents is not None:
                raise ValueError("pass image or latents, not both")
            if isinstance(self.vae, IdentityVAE):
                raise ValueError("image-to-image requires a VAE")
            if not 0.0 < strength <= 1.0:
                raise ValueError(f"strength must be in (0, 1], got {strength}")
            n = num_inference_steps
            start_step = n - max(1, min(n, int(round(strength * n))))
            t0 = schedule_start_time(settings, lh, lw, start_step)
            # checked on every path, whether or not the encode runs
            x = _preprocess_image(image, height, width)
            if x.shape[0] not in (1, batch):
                raise ValueError(f"got {x.shape[0]} images for batch {batch}")
            if t0 >= 1.0 and mask_image is None:
                # the image would be multiplied by exactly zero
                latents = torch.randn(lat_shape, generator=generator,
                                      device=device, dtype=dtype)
            else:
                lat = normalize_latents(
                    self._encode_image_latents(torch.from_numpy(x).to(device)).float(),
                    self.vae.config)
                lat = lat.expand(batch, *lat.shape[1:])  # one image for all
                if tuple(lat.shape) != lat_shape:
                    raise ValueError(f"encoded image latents {tuple(lat.shape)} "
                                     f"!= {lat_shape}")
                noise = torch.randn(lat_shape, generator=generator, device=device)
                latents = ((1.0 - t0) * lat + t0 * noise).to(dtype)
                if mask_image is not None:
                    m = torch.from_numpy(_preprocess_mask(mask_image, lh, lw, batch))
                    step_noise = torch.randn((n - start_step, *lat_shape),
                                             generator=generator, device=device)
                    inpaint = (lat, m.to(device), step_noise)
        elif latents is None:
            latents = torch.randn(lat_shape, generator=generator, device=device,
                                  dtype=dtype)
        else:
            latents = torch.as_tensor(latents, device=device)

        final = denoise(
            self.dit, latents,
            torch.from_numpy(embeds).to(device=device, dtype=dtype),
            torch.from_numpy(neg).to(device=device, dtype=dtype),
            torch.from_numpy(mask).to(device),
            settings,
            negative_mask=torch.from_numpy(neg_mask).to(device),
            start_step=start_step, inpaint=inpaint,
        )
        if output_type == "latent":
            return FLitePipelineOutput(images=final)

        decoded = self._decode(final)
        if output_type == "np":
            return FLitePipelineOutput(images=decoded.float().cpu().numpy())
        u8 = to_uint8(decoded).cpu().numpy()
        if output_type == "uint8":
            return FLitePipelineOutput(images=u8)
        from PIL import Image as PILImage

        return FLitePipelineOutput(images=[PILImage.fromarray(a) for a in u8])
