"""FLitePipeline in PyTorch (counterpart of `f_lite_tpu/pipeline.py`).

Serving path: load a native pipeline directory, take text embeddings, run
the CFG-batched Euler trajectory through the DiT, decode with the VAE and
return images.

Directory layout (as written by the JAX package's `save_pretrained`):
  {root}/model_index.json
  {root}/dit/config.json + flax_params.safetensors  (unrolled layout)
  {root}/vae/config.json + flax_params.safetensors  (optional)
With no `vae/` the pipeline runs in pixel space (`IdentityVAE`), and
height/width are the DiT's own input size.

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
    denormalize_latents,
    resolve_memory_mode,
)
from f_lite_tpu_torch.ops.guidance import APGConfig
from f_lite_tpu_torch.sampling.euler import DenoiseSettings, denoise
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

    @property
    def device(self) -> torch.device:
        return self.dit.context_proj.weight.device

    @classmethod
    def from_pretrained(cls, path: str | Path, *, dtype=torch.bfloat16,
                        device="cuda") -> "FLitePipeline":
        """Load a native pipeline directory. The DiT runs in `dtype`; the
        VAE, as in the JAX package, in fp32."""
        device = resolve_device(device)
        path = Path(path)
        json.loads((path / "model_index.json").read_text())
        cfg = DiTConfig.from_json_dict(
            json.loads((path / "dit" / "config.json").read_text())
        )
        dit = DiT(cfg)
        dit.load_state_dict(state_dict_from_jax(
            load_file(path / "dit" / "flax_params.safetensors"), cfg
        ))
        dit = dit.to(device=device, dtype=dtype).eval()
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
        if latents is None:
            lh, lw = height // self.vae_scale_factor, width // self.vae_scale_factor
            if generator is None:
                generator = torch.Generator(device).manual_seed(0)
            latents = torch.randn(
                (batch, lh, lw, self.dit.config.in_channels),
                generator=generator, device=device, dtype=dtype,
            )
        else:
            latents = torch.as_tensor(latents, device=device)

        settings = DenoiseSettings(
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, apg=apg, alpha=alpha,
        )
        final = denoise(
            self.dit, latents,
            torch.from_numpy(embeds).to(device=device, dtype=dtype),
            torch.from_numpy(neg).to(device=device, dtype=dtype),
            torch.from_numpy(mask).to(device),
            settings,
            negative_mask=torch.from_numpy(neg_mask).to(device),
        )
        if output_type == "latent":
            return FLitePipelineOutput(images=final)

        z = denormalize_latents(final.float(), self.vae.config)
        if isinstance(self.vae, AutoencoderKL):
            resolve_memory_mode("auto", max(z.shape[1:3]))
        decoded = self.vae.decode(z)
        if output_type == "np":
            return FLitePipelineOutput(images=decoded.float().cpu().numpy())
        u8 = to_uint8(decoded).cpu().numpy()
        if output_type == "uint8":
            return FLitePipelineOutput(images=u8)
        from PIL import Image as PILImage

        return FLitePipelineOutput(images=[PILImage.fromarray(a) for a in u8])
