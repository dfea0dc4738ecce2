"""FLitePipeline in PyTorch (counterpart of `f_lite_tpu/pipeline.py`).

Serving path: load a native pipeline directory, encode prompts (or take
text embeddings), run the CFG-batched trajectory (Euler or ab2, optionally
with limited-interval guidance) through the DiT, decode with the VAE and
return images; with an input image, encode it and start part-way (image to
image), optionally repainting only a masked region (inpainting).

`from_pretrained` takes a native pipeline directory, or a diffusers-layout
snapshot directory (the reference's layout, `dit_model/` with torch
weights), which is converted once and cached (`convert/ingest.py`); a LoRA
merges at load (`lora_path=`); `save_pretrained` writes the native layout.
Native directory layout (as `save_pretrained` writes it, in either package):
  {root}/model_index.json  (optional `text_encoder_type`: "t5" by default,
      "qwen2", or any other for `TorchTextEncoder`; `return_index`, -8)
  {root}/dit/config.json + flax_params.safetensors  (unrolled, scan-stacked
      or pipeline-parallel layout, heads padded or not)
  {root}/vae/config.json + flax_params.safetensors  (optional)
  {root}/text_encoder/ (HF folder, optional), {root}/tokenizer/ (optional;
      the tokenizer is read from text_encoder/ without it)
With no `vae/` the pipeline runs in pixel space (`IdentityVAE`), and
height/width are the DiT's own input size. Tokenizing runs on the host and
needs `transformers`; the text tower runs on the pipeline's device.

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
from f_lite_tpu_torch.convert.ingest import resolve_pretrained
from f_lite_tpu_torch.convert.to_jax import (
    state_dict_to_jax,
    to_scan_layout,
    vae_state_dict_to_jax,
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
    auto_steps_per_dispatch,
    denoise,
    schedule_start_time,
)
from f_lite_tpu_torch.train.lora import apply_lora, load_lora_weights, lora_rank
from f_lite_tpu_torch.utils.device import resolve_device
from f_lite_tpu_torch.utils.safetensors import load_file, save_file
from f_lite_tpu_torch.utils.trace import span

OUTPUT_TYPES = ("latent", "np", "uint8", "pil")


@dataclasses.dataclass
class FLitePipelineOutput:
    images: Any


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


def text_encoder_from_dir(path: Path, index: dict, device: torch.device):
    """The text encoder of a pipeline directory's `text_encoder/` (bf16 for
    the port's T5 and Qwen2 stacks, fp32 for `TorchTextEncoder`, as the JAX
    package loads them), or None without one."""
    te_dir = path / "text_encoder"
    if not (te_dir / "config.json").exists():
        return None
    te_type = index.get("text_encoder_type", "t5")
    return_index = index.get("return_index", -8)
    tok_dir = path / "tokenizer"
    tokenizer = str(tok_dir if tok_dir.exists() else te_dir)
    if te_type == "t5":
        from f_lite_tpu_torch.text.encoder import T5TextEncoder

        return T5TextEncoder(str(te_dir), tokenizer, return_index=return_index,
                             device=device)
    if te_type == "qwen2":
        from f_lite_tpu_torch.text.qwen2 import Qwen2TextEncoder

        return Qwen2TextEncoder(str(te_dir), tokenizer,
                                return_index=return_index, device=device)
    from f_lite_tpu_torch.text.encoder import TorchTextEncoder

    return TorchTextEncoder(str(te_dir), return_index=return_index, device=device)


class FLitePipeline:
    def __init__(self, dit: DiT, vae: AutoencoderKL | None = None,
                 text_encoder=None):
        self.dit = dit
        self.vae = vae if vae is not None else IdentityVAE()
        self.text_encoder = text_encoder
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
                        device="cuda", quantize: bool = False,
                        text_encoder=None,
                        load_text_encoder: bool = True,
                        lora_path: str | Path | None = None,
                        lora_alpha: float | None = None,
                        lora_scale: float = 1.0,
                        pad_heads_to: int | None = None) -> "FLitePipeline":
        """Load a pipeline: `path` is a native directory or a
        diffusers-layout snapshot directory (`convert.ingest.
        resolve_pretrained`: converted on first use and cached). The DiT
        runs in `dtype`; the VAE, as in the JAX package, in fp32.

        `lora_path`: a LoRA checkpoint (a dir, the framework's
        `lora_weights.safetensors` or a reference peft `lora_weights.pt`)
        merged into the DiT after the cast to `dtype` and before any
        quantization, in `dtype` (`train.lora.apply_lora`), as the JAX
        package merges it. The rank is read from the first `lora_a`;
        `lora_alpha` defaults to the rank. A merge that changes no weight
        raises, as do scan-stacked, pipeline-parallel and head-padded
        checkpoints, whose saved kernels the factors do not fit.

        `pad_heads_to=N`: attention computes with N heads, the extra ones
        zero (`DiTConfig.padded_heads`, `convert.heads`), so that a
        tensor-parallel degree that does not divide `num_heads` (7B: 10,
        10B: 12) splits them evenly. Exact in math; a LoRA merges before
        the padding, and int8 quantization comes after it, as in JAX.

        `quantize=True`: int8 W8A8 projections (`quant.quantize_dit`),
        quantized from the weights after their cast to `dtype`, as the JAX
        package does; the argument decides, whatever the saved config says.
        A checkpoint saved with int8 weights loads only with it.

        `text_encoder`: used as given; otherwise, with `load_text_encoder`,
        the directory's `text_encoder/` is loaded
        (`text_encoder_from_dir`), on `device`."""
        device = resolve_device(device)
        path = resolve_pretrained(path)
        index = json.loads((path / "model_index.json").read_text())
        flat = load_file(path / "dit" / "flax_params.safetensors", bf16_bits=True)
        saved_int8 = any(k.endswith(".w8") for k in flat)
        if saved_int8 and not quantize:
            raise ValueError(f"{path}: the DiT's weights are int8; load it "
                             "with quantize=True")
        cfg_json = json.loads((path / "dit" / "config.json").read_text())
        cfg = dataclasses.replace(DiTConfig.from_json_dict(cfg_json),
                                  quantized=saved_int8)
        with torch.device("meta"):  # no initializer runs: the file sets every tensor
            dit = DiT(cfg)
        dit.load_state_dict(state_dict_from_jax(flat, cfg), assign=True)
        del flat
        dit = dit.to(device=device, dtype=dtype).eval()
        if lora_path:
            lora = load_lora_weights(lora_path)
            rank = lora_rank(lora)
            if not rank:
                raise ValueError(f"no lora_a factors in {lora_path}")
            if cfg_json.get("padded_heads") not in (None, cfg.num_heads):
                raise ValueError("LoRA factors do not fit the head-padded "
                                 "kernels of this checkpoint")
            # the saved scan-stacked and pipeline-parallel trunks hold no
            # per-block kernel the factors attach to
            stacked = (cfg_json.get("scan_layers", False)
                       or (cfg_json.get("pipeline_stages") or 1) > 1)
            alpha = float(lora_alpha) if lora_alpha is not None else rank
            merged = 0 if stacked else apply_lora(dit, lora, alpha=alpha,
                                                  rank=rank, scale=lora_scale)
            if merged == 0:
                raise ValueError(
                    "LoRA factors matched no kernels — the checkpoint "
                    "layout (e.g. scan-stacked blocks) differs from the "
                    "unrolled layout the factors were trained against")
        if pad_heads_to:
            from f_lite_tpu_torch.convert.heads import pad_dit_heads

            dit = pad_dit_heads(dit, pad_heads_to)
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
        if text_encoder is None and load_text_encoder:
            text_encoder = text_encoder_from_dir(path, index, device)
        return cls(dit, vae, text_encoder)

    def save_pretrained(self, path: str | Path, scan_layers: bool = False) -> None:
        """Write the native layout as the JAX package's `save_pretrained`
        does: `model_index.json`, `dit/` (config.json and
        flax_params.safetensors, unrolled, in the DiT's dtype; int8 weights
        and fp32 scales when quantized, which load only with
        `quantize=True`) and, with a VAE, `vae/` (fp32). Padded heads are
        sliced off: the files are those of the unpadded pipeline.
        `scan_layers`: the blocks scan-stacked (`convert.to_jax.
        to_scan_layout`) and `scan_layers: true` in the config, as the JAX
        trainer exports under `--scan_layers` (`pipeline_stages` 1)."""
        path = Path(path)
        (path / "dit").mkdir(parents=True, exist_ok=True)
        (path / "model_index.json").write_text(json.dumps(
            {"_class_name": "FLitePipeline", "framework": "f-lite-tpu"}, indent=2))
        cfg = self.dit.config
        state = self.dit.state_dict()
        if cfg.padded_heads:
            from f_lite_tpu_torch.convert.heads import unpad_head_state

            state = unpad_head_state(state, cfg)
            cfg = dataclasses.replace(cfg, padded_heads=None)
        config = cfg.to_json_dict()
        flat = state_dict_to_jax(state, cfg)
        if scan_layers:
            config["scan_layers"] = True
            flat = to_scan_layout(flat, cfg)
        (path / "dit" / "config.json").write_text(json.dumps(config, indent=2))
        save_file(flat, path / "dit" / "flax_params.safetensors")
        if isinstance(self.vae, IdentityVAE):
            return
        (path / "vae").mkdir(exist_ok=True)
        (path / "vae" / "config.json").write_text(
            json.dumps(self.vae.config.to_json_dict(), indent=2))
        save_file(vae_state_dict_to_jax(self.vae.state_dict(), self.vae.config),
                  path / "vae" / "flax_params.safetensors")

    def encode_prompt(self, prompt, negative_prompt=None):
        """Prompt(s) -> (embeds, neg, mask, neg_mask) as numpy through the
        text encoder. With no negative prompt the negative is zeros with an
        all-ones mask (the reference's unconditional context); with one, the
        two are right-padded to the longer length."""
        if isinstance(prompt, str):
            prompt = [prompt]
        if self.text_encoder is None:
            raise ValueError("pipeline has no text encoder; pass prompt_embeds instead")
        embeds, mask = self.text_encoder.encode(prompt)
        if negative_prompt is None:
            return embeds, np.zeros_like(embeds), mask, np.ones_like(mask)
        if isinstance(negative_prompt, str):
            negative_prompt = [negative_prompt]
        neg, neg_mask = self.text_encoder.encode(negative_prompt)
        s = max(embeds.shape[1], neg.shape[1])
        embeds, mask = _pad_seq(embeds, mask, s)
        neg, neg_mask = _pad_seq(neg, neg_mask, s)
        return embeds, neg, mask, neg_mask

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
        prompt=None,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 30,
        guidance_scale: float = 6.0,
        negative_prompt=None,
        num_images_per_prompt: int = 1,
        generator: torch.Generator | None = None,
        alpha: float | None = None,
        apg_config: APGConfig | None = None,
        prompt_embeds=None,
        negative_embeds=None,
        context_mask=None,
        negative_context_mask=None,
        latents=None,
        output_type: str = "uint8",
        return_latents: bool = False,
        pad_context_to: int | None = None,
        image=None,
        strength: float = 0.8,
        mask_image=None,
        guidance_interval: tuple | None = None,
        sampler: str = "euler",
        steps_per_dispatch: int | None = None,
        callback=None,
    ) -> FLitePipelineOutput:
        """Generate images (B, height, width, 3) from `prompt` (a string or
        a list) and `negative_prompt` through the text encoder
        (`encode_prompt`), or from text embeddings `prompt_embeds` (B, S, C)
        with `context_mask` (B, S) bool (True = real token; default all
        real) and optionally `negative_embeds`.

        `latents` (B, h, w, C) NHWC replaces the starting noise; otherwise
        it is drawn from `generator` (a seed-0 generator when None) in the
        DiT's dtype. `output_type`: "latent" (the final latents, a tensor on
        the device), "np" (float32 in [-1, 1]), "uint8", or "pil" (needs
        PIL). `return_latents=True` skips the decode and returns the final
        latents on the host (a CPU tensor, NHWC, in the DiT's dtype: numpy
        has no bf16), whatever `output_type` says. `pad_context_to`
        zero-pads the text context up to the next multiple of this length;
        padded keys carry mask 0, so it is exact.

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
        - `steps_per_dispatch`: the trajectory runs in windows of this many
          steps, as the JAX pipeline dispatches it; None: JAX's automatic
          size (`sampling.euler.auto_steps_per_dispatch`), 0: one window.
          Every k gives the same latents bit for bit.
        - `callback(done_steps, total_steps) -> bool`: runs after every
          window; a truthy return stops the trajectory there, and the
          latents reached so far are decoded (the GUI's cancel).
        The noise of image to image and inpainting comes from `generator`
        after the start noise.
        """
        with span("pipeline.request"):
            with span("pipeline.prepare"):
                if output_type not in OUTPUT_TYPES:
                    raise ValueError(f"output_type must be one of {OUTPUT_TYPES}")
                device = self.device
                dtype = self.dit.dtype
                apg = apg_config if (apg_config and apg_config.enabled) else None

                if prompt_embeds is not None:
                    embeds, neg, mask, neg_mask = self._context(
                        prompt_embeds, negative_embeds, context_mask,
                        negative_context_mask,
                    )
                elif prompt is not None:
                    embeds, neg, mask, neg_mask = self.encode_prompt(prompt, negative_prompt)
                else:
                    raise ValueError("pass prompt or prompt_embeds")
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
                if steps_per_dispatch is None:
                    steps_per_dispatch = auto_steps_per_dispatch(
                        batch, num_inference_steps, lh * lw)

                embeds = torch.from_numpy(embeds).to(device=device, dtype=dtype)
                neg = torch.from_numpy(neg).to(device=device, dtype=dtype)
                mask = torch.from_numpy(mask).to(device)
                neg_mask = torch.from_numpy(neg_mask).to(device)
            with span("pipeline.denoise"):
                final = denoise(
                    self.dit, latents, embeds, neg, mask, settings,
                    negative_mask=neg_mask, start_step=start_step, inpaint=inpaint,
                    steps_per_dispatch=steps_per_dispatch, callback=callback,
                )
            del embeds, neg, mask, neg_mask  # the context, freed before the decode
            if return_latents:
                with span("pipeline.return"):
                    return FLitePipelineOutput(images=final.cpu())
            if output_type == "latent":
                return FLitePipelineOutput(images=final)

            with span("pipeline.decode"):
                decoded = self._decode(final)
            with span("pipeline.return"):
                if output_type == "np":
                    return FLitePipelineOutput(images=decoded.float().cpu().numpy())
                u8 = to_uint8(decoded).cpu().numpy()
                if output_type == "uint8":
                    return FLitePipelineOutput(images=u8)
                from PIL import Image as PILImage

                return FLitePipelineOutput(images=[PILImage.fromarray(a) for a in u8])
