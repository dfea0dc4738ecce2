"""ComfyUI node for the PyTorch port (counterpart of `f_lite_tpu/comfyui.py`).

`FLiteNode` has the JAX node's inputs, model choices and one-entry
pipeline cache, and returns ComfyUI's IMAGE: a float tensor (B, H, W, 3)
in [0, 1]. IMAGE inputs go to the pipeline as PIL images (ComfyUI installs
PIL), which it resizes to the requested size; MASK inputs as float arrays.
The pipeline runs on `device` ("cuda" unless the node is built for the
CPU), and the seed draws from `torch.Generator(device).manual_seed(seed)`.

Install: put the repo in ComfyUI/custom_nodes with `f_lite_tpu_torch`
importable; ComfyUI finds `NODE_CLASS_MAPPINGS` below. The model choices
are hub repo ids, which the port does not download: pass a local pipeline
or snapshot directory in their place.
"""

from __future__ import annotations

import numpy as np

from f_lite_tpu_torch.sampling.euler import SAMPLERS

_PIPELINE_CACHE: dict = {}

MODEL_CHOICES = [
    "Freepik/F-Lite",
    "Freepik/F-Lite-Texture",
    "Freepik/F-Lite-7B",
]


def _get_pipeline(model_path: str, vae_tiling: bool, device="cuda"):
    key = (model_path, vae_tiling)
    pipe = _PIPELINE_CACHE.get(key)
    if pipe is None:
        from f_lite_tpu_torch.pipeline import FLitePipeline

        pipe = FLitePipeline.from_pretrained(model_path, device=device)
        if vae_tiling:
            pipe.enable_vae_tiling()
        _PIPELINE_CACHE.clear()  # one resident pipeline
        _PIPELINE_CACHE[key] = pipe
    return pipe


class FLiteNode:
    """Text to image (and image to image, inpainting) through the port."""

    CATEGORY = "F-Lite"
    FUNCTION = "generate"
    RETURN_TYPES = ("IMAGE",)

    def __init__(self, device="cuda"):
        self.device = device

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": (MODEL_CHOICES, {"default": MODEL_CHOICES[0]}),
                "prompt": ("STRING", {"multiline": True, "default": ""}),
                "negative_prompt": ("STRING", {"multiline": True,
                                               "default": ""}),
                "width": ("INT", {"default": 1344, "min": 256, "max": 2048,
                                  "step": 16}),
                "height": ("INT", {"default": 896, "min": 256, "max": 2048,
                                   "step": 16}),
                "steps": ("INT", {"default": 30, "min": 1, "max": 100}),
                "guidance_scale": ("FLOAT", {"default": 6.0, "min": 0.0,
                                             "max": 20.0, "step": 0.5}),
                "seed": ("INT", {"default": 0, "min": 0,
                                 "max": 2**31 - 1}),
                "use_apg": ("BOOLEAN", {"default": False}),
                "vae_tiling": ("BOOLEAN", {"default": False}),
            },
            "optional": {
                # image to image: any IMAGE output, with strength < 1.0
                "image": ("IMAGE",),
                # inpainting (with image): MASK, 1 = repaint, 0 = keep
                "mask": ("MASK",),
                "strength": ("FLOAT", {"default": 0.8, "min": 0.05,
                                       "max": 1.0, "step": 0.05}),
                "sampler": (list(SAMPLERS), {"default": "euler"}),
            },
        }

    def generate(self, model, prompt, negative_prompt, width, height,
                 steps, guidance_scale, seed, use_apg, vae_tiling,
                 image=None, mask=None, strength=0.8, sampler="euler"):
        import torch

        from f_lite_tpu_torch.ops.guidance import APGConfig

        init_images = None
        if image is not None:
            # IMAGE: (B, H, W, 3) float in [0, 1]; as PIL images, which the
            # pipeline resizes to (width, height)
            from PIL import Image as PILImage

            arr = np.asarray(image, np.float32)
            if arr.ndim == 3:
                arr = arr[None]
            init_images = [
                PILImage.fromarray(np.clip(a * 255.0, 0, 255).astype(np.uint8))
                for a in arr
            ]
            if len(init_images) == 1:
                init_images = init_images[0]

        mask_images = None
        if mask is not None:
            if image is None:
                raise ValueError(
                    "mask requires an image input (inpainting repaints "
                    "the masked region of the supplied image)"
                )
            # MASK: (H, W) or (B, H, W) float in [0, 1], 1 = repaint, the
            # pipeline's polarity; one (H, W) array a frame (a (B, H, W)
            # array would read as (H, W, C)); one mask serves every frame
            m = np.asarray(mask, np.float32)
            if m.ndim == 2:
                m = m[None]
            mask_images = list(m) if m.shape[0] > 1 else m[0]

        pipe = _get_pipeline(model, vae_tiling, self.device)
        # B IMAGE frames: one variation a frame, the prompt repeated
        n_per_prompt = len(init_images) if isinstance(init_images, list) else 1
        out = pipe(
            prompt=prompt,
            negative_prompt=negative_prompt or None,
            width=width, height=height,
            num_inference_steps=steps,
            guidance_scale=guidance_scale,
            generator=torch.Generator(pipe.device).manual_seed(seed),
            num_images_per_prompt=n_per_prompt,
            apg_config=APGConfig(enabled=True) if use_apg else None,
            output_type="np",
            image=init_images,
            mask_image=mask_images,
            strength=strength,
            sampler=sampler,
        )
        imgs = np.clip(np.asarray(out.images) / 2.0 + 0.5, 0.0, 1.0)
        return (torch.from_numpy(imgs.astype(np.float32)),)


NODE_CLASS_MAPPINGS = {"FLiteTPU": FLiteNode}
NODE_DISPLAY_NAME_MAPPINGS = {"FLiteTPU": "F-Lite (GPU)"}
