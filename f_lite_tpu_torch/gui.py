"""Gradio GUI of the PyTorch port (counterpart of `f_lite_tpu/gui.py`).

Preset resolutions, `{a|b}` and `__file__` wildcards, prompt prefix and
suffix, APG, seed lock or shuffle, "generate forever" (stopped between
dispatch windows through the pipeline's `callback`), SuperPrompt
enhancement, dated output files and one resident pipeline. The expansion
and bookkeeping live here without gradio, so they are testable; `build_app`
needs gradio, which it imports when called.

`python -m f_lite_tpu_torch.gui --model <dir> [--device cuda]` (needs
gradio installed).
"""

from __future__ import annotations

import datetime
import random
import re
import threading
from pathlib import Path

from f_lite_tpu_torch.sampling.euler import SAMPLERS

PRESET_RESOLUTIONS = {
    "1344x896 (landscape)": (1344, 896),
    "896x1344 (portrait)": (896, 1344),
    "1024x1024 (square)": (1024, 1024),
    "1152x864": (1152, 864),
    "1280x720 (16:9)": (1280, 720),
    "512x512 (fast)": (512, 512),
}

_WILDCARD_RE = re.compile(r"\{([^{}]*)\}")
_FILE_RE = re.compile(r"__([A-Za-z0-9_\-/]+)__")


def expand_wildcards(
    prompt: str, rng: random.Random | None = None,
    wildcard_dir: str | Path = "wildcards", max_depth: int = 10,
) -> str:
    """Expand `{a|b|c}` choices and `__name__` wildcard-file references.

    `__name__` becomes a random line of `{wildcard_dir}/name.txt`; nested
    constructs expand over up to `max_depth` passes."""
    rng = rng or random.Random()
    wdir = Path(wildcard_dir)

    for _ in range(max_depth):
        changed = False

        def choice_sub(m):
            nonlocal changed
            changed = True
            return rng.choice(m.group(1).split("|"))

        prompt = _WILDCARD_RE.sub(choice_sub, prompt)

        def file_sub(m):
            nonlocal changed
            f = wdir / f"{m.group(1)}.txt"
            if not f.exists():
                return m.group(0)
            lines = [line.strip() for line in f.read_text().splitlines()
                     if line.strip()]
            if not lines:
                return ""
            changed = True
            return rng.choice(lines)

        prompt = _FILE_RE.sub(file_sub, prompt)
        if not changed:
            break
    return prompt


def compose_prompt(prompt: str, prefix: str = "", suffix: str = "") -> str:
    parts = [p.strip() for p in (prefix, prompt, suffix) if p and p.strip()]
    return ", ".join(parts)


def dated_output_path(output_dir: str | Path, ext: str = "png") -> Path:
    """`outputs/YYYY-MM-DD/HHMMSS_<rand>.png`."""
    now = datetime.datetime.now()
    d = Path(output_dir) / now.strftime("%Y-%m-%d")
    d.mkdir(parents=True, exist_ok=True)
    return d / f"{now.strftime('%H%M%S')}_{random.randrange(16**4):04x}.{ext}"


class SuperPromptEnhancer:
    """T5-based prompt expansion (roborovski/superprompt-v1) on the CPU,
    loaded through `transformers` at first use."""

    def __init__(self, model_path: str = "roborovski/superprompt-v1"):
        self.model_path = model_path
        self._model = None
        self._tok = None

    def enhance(self, prompt: str, max_new_tokens: int = 256) -> str:
        if self._model is None:
            from transformers import AutoTokenizer, T5ForConditionalGeneration

            self._tok = AutoTokenizer.from_pretrained(self.model_path)
            self._model = T5ForConditionalGeneration.from_pretrained(self.model_path)
        inp = self._tok(
            f"Expand the following prompt to add more detail: {prompt}",
            return_tensors="pt",
        )
        out = self._model.generate(**inp, max_new_tokens=max_new_tokens)
        return self._tok.decode(out[0], skip_special_tokens=True)


class GenerationController:
    """Cooperative cancellation of generate-forever."""

    def __init__(self):
        self._stop = threading.Event()

    def request_stop(self):
        self._stop.set()

    def reset(self):
        self._stop.clear()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()


_PIPE = None


def get_pipeline(model_path: str, device="cuda"):
    global _PIPE
    if _PIPE is None:
        from f_lite_tpu_torch.pipeline import FLitePipeline

        _PIPE = FLitePipeline.from_pretrained(model_path, device=device)
    return _PIPE


def build_app(model_path: str, output_dir: str = "outputs",
              wildcard_dir: str = "wildcards", device: str = "cuda"):
    import gradio as gr
    import numpy as np
    import torch

    from f_lite_tpu_torch.ops.guidance import APGConfig
    from f_lite_tpu_torch.utils.image import save_with_metadata

    controller = GenerationController()
    enhancer = SuperPromptEnhancer()

    def generate(prompt, negative, prefix, suffix, preset, steps, guidance,
                 use_apg, apg_threshold, seed, lock_seed, forever,
                 use_superprompt, init_image=None, mask_image=None,
                 strength=0.8, sampler="euler"):
        controller.reset()
        pipe = get_pipeline(model_path, device)
        width, height = PRESET_RESOLUTIONS[preset]
        images = []
        while True:
            actual_seed = seed if lock_seed else random.randrange(2**31)
            p = expand_wildcards(prompt, wildcard_dir=wildcard_dir)
            p = compose_prompt(p, prefix, suffix)
            if use_superprompt:
                p = enhancer.enhance(p)
            out = pipe(
                prompt=p,
                negative_prompt=negative or None,
                width=width, height=height,
                num_inference_steps=int(steps),
                guidance_scale=guidance,
                generator=torch.Generator(pipe.device).manual_seed(int(actual_seed)),
                apg_config=APGConfig(
                    enabled=True, orthogonal_threshold=apg_threshold
                ) if use_apg else None,
                # Stop lands at the next dispatch window's end
                callback=lambda done, total: controller.should_stop,
                image=init_image,
                # a mask without an input image is ignored
                mask_image=mask_image if init_image is not None else None,
                strength=float(strength),
                sampler=sampler,
            )
            img = np.asarray(out.images[0])
            path = dated_output_path(output_dir)
            save_with_metadata(img, path, {
                "prompt": p, "negative_prompt": negative or None,
                "width": width, "height": height, "steps": int(steps),
                "guidance_scale": guidance, "seed": int(actual_seed),
                "apg": bool(use_apg) or None,
                "strength": float(strength) if init_image is not None else None,
                "inpaint": (init_image is not None and mask_image is not None) or None,
                "sampler": sampler,
                "model": model_path,
            })
            images.append(img)
            yield images, str(path), actual_seed
            if not forever or controller.should_stop:
                return

    with gr.Blocks(title="F-Lite GPU") as app:
        gr.Markdown("# F-Lite (GPU)")
        with gr.Row():
            with gr.Column():
                prompt = gr.Textbox(label="Prompt", lines=3)
                negative = gr.Textbox(label="Negative prompt", lines=1)
                prefix = gr.Textbox(label="Prefix", lines=1)
                suffix = gr.Textbox(label="Suffix", lines=1)
                preset = gr.Dropdown(list(PRESET_RESOLUTIONS), label="Resolution",
                                     value="1344x896 (landscape)")
                steps = gr.Slider(1, 100, 30, step=1, label="Steps")
                guidance = gr.Slider(0, 20, 6.0, step=0.5, label="CFG")
                use_apg = gr.Checkbox(label="APG guidance", value=False)
                apg_threshold = gr.Slider(0.0, 0.2, 0.03, step=0.005,
                                          label="APG orthogonal threshold")
                seed = gr.Number(label="Seed", value=0, precision=0)
                lock_seed = gr.Checkbox(label="Lock seed", value=False)
                forever = gr.Checkbox(label="Generate forever", value=False)
                use_superprompt = gr.Checkbox(label="SuperPrompt enhance", value=False)
                sampler = gr.Dropdown(list(SAMPLERS), label="Sampler", value="euler")
                with gr.Accordion("Image to image", open=False):
                    init_image = gr.Image(label="Input image (optional)", type="pil")
                    mask_image = gr.Image(
                        label="Inpaint mask (optional; white = repaint, "
                              "black = keep, gray blends)", type="pil")
                    strength = gr.Slider(0.05, 1.0, 0.8, step=0.05, label="Strength")
                go = gr.Button("Generate", variant="primary")
                stop = gr.Button("Stop")
            with gr.Column():
                gallery = gr.Gallery(label="Results")
                last_path = gr.Textbox(label="Saved to")
                used_seed = gr.Number(label="Used seed", precision=0)
        go.click(
            generate,
            [prompt, negative, prefix, suffix, preset, steps, guidance,
             use_apg, apg_threshold, seed, lock_seed, forever,
             use_superprompt, init_image, mask_image, strength, sampler],
            [gallery, last_path, used_seed],
        )
        stop.click(lambda: controller.request_stop(), [], [])
    return app


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True)
    p.add_argument("--output_dir", default="outputs")
    p.add_argument("--wildcard_dir", default="wildcards")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--share", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    try:
        import gradio  # noqa: F401
    except ImportError:
        raise SystemExit("gradio is not installed; the GUI requires `pip install gradio`")
    from f_lite_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)
    app = build_app(args.model, args.output_dir, args.wildcard_dir, args.device)
    app.queue().launch(server_port=args.port, share=args.share)


if __name__ == "__main__":
    main()
