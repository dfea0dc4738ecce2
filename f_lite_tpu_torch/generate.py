"""Image-generation CLI of the port: `python -m f_lite_tpu_torch.generate`
(counterpart of `f_lite_tpu/generate.py`, the same flags and defaults, plus
`--device`).

Runs on the card (`--device cuda`, the default) and raises without one.
`--seed N` draws the start noise from `torch.Generator(device).
manual_seed(N)`, so a seed gives other images than the JAX package's. The
images are written as parameter-stamped PNGs by the port's own writer
(`utils/image.py`, no PIL); several images take `_N` suffixes, and
`--from_png` regenerates from such a file's stamp. `--image` and `--mask`
take PNG files of the requested size (the mask at the latent grid); other
formats, and resizing, need PIL. `--model` is a local native or
diffusers-layout snapshot directory: the hub id of the default is not
resolved by the port.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

from f_lite_tpu_torch.sampling.euler import SAMPLERS

logger = logging.getLogger("f_lite_tpu_torch.generate")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Generate images with an F-Lite model on an NVIDIA GPU"
    )
    p.add_argument("--prompt", type=str, default=None,
                   help="required unless --from_png supplies one")
    p.add_argument("--from_png", type=str, default=None,
                   help="re-generate from a parameter-stamped output PNG: "
                        "its embedded f-lite:* metadata becomes the "
                        "defaults, and any flag you pass explicitly "
                        "overrides it")
    p.add_argument("--model", type=str, default="Freepik/F-Lite",
                   help="a native pipeline dir or a diffusers-layout "
                        "snapshot dir (converted on first use); hub repo "
                        "ids such as the default are not resolved")
    p.add_argument("--negative_prompt", type=str, default=None)
    p.add_argument("--guidance_scale", type=float, default=6.0)
    p.add_argument("--num_inference_steps", type=int, default=30)
    p.add_argument("--width", type=int, default=1344)
    p.add_argument("--height", type=int, default=896)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the torch.Generator on --device")
    p.add_argument("--num_images", type=int, default=1)
    p.add_argument("--output_file", type=str, default="output.png")
    p.add_argument("--apg", action="store_true",
                   help="use APG guidance instead of plain CFG")
    p.add_argument("--apg_orthogonal_threshold", type=float, default=0.03)
    p.add_argument("--cpu_offload", action="store_true",
                   help="compat flag: enables tiled VAE decode")
    p.add_argument("--vae_tiling", action="store_true")
    p.add_argument("--no_text_encoder", action="store_true",
                   help="use the hermetic pseudo text encoder (debug): "
                        "md5-seeded embeddings of the trainer's 32 tokens")
    p.add_argument("--quantize", action="store_true",
                   help="int8 W8A8 DiT projections (dynamic act quant)")
    p.add_argument("--lora_path", type=str, default=None,
                   help="LoRA checkpoint (dir, .safetensors or peft .pt) "
                        "merged into the DiT at load")
    p.add_argument("--lora_scale", type=float, default=1.0)
    p.add_argument("--image", type=str, default=None,
                   help="input image for image-to-image (a PNG of "
                        "--width x --height; other sizes and formats need "
                        "PIL), VAE-encoded and partially noised per "
                        "--strength")
    p.add_argument("--strength", type=float, default=0.8,
                   help="img2img noising strength in (0, 1]: 1.0 = full "
                        "text-to-image, small values stay close to the "
                        "input image")
    p.add_argument("--mask", type=str, default=None,
                   help="inpainting mask (requires --image): white = "
                        "repaint, black = keep; a PNG at the latent grid "
                        "(other sizes need PIL). Use --strength 1.0 to "
                        "fully regenerate the masked region")
    p.add_argument("--guidance_interval", type=float, nargs=2,
                   default=None, metavar=("LO", "HI"),
                   help="apply CFG only while the schedule t is inside "
                        "[LO, HI]; other steps run conditional-only at "
                        "half the model cost (limited-interval guidance)")
    p.add_argument("--sampler", choices=SAMPLERS, default="euler",
                   help="'ab2' = second-order multistep integration at "
                        "the same per-step cost")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    return p


def generate_images(args) -> list[Path]:
    import torch

    from f_lite_tpu_torch.ops.guidance import APGConfig
    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.utils.device import resolve_device
    from f_lite_tpu_torch.utils.image import load_image, save_with_metadata

    device = resolve_device(args.device)
    if args.mask and not args.image:
        raise SystemExit("--mask requires --image")
    pipe = FLitePipeline.from_pretrained(
        args.model, device=device, load_text_encoder=not args.no_text_encoder,
        quantize=args.quantize,
        lora_path=args.lora_path, lora_scale=args.lora_scale,
    )
    if args.no_text_encoder:
        from f_lite_tpu_torch.text.encoder import PSEUDO_TEXT_LEN, ZeroTextEncoder

        pipe.text_encoder = ZeroTextEncoder(
            embed_dim=pipe.dit.config.cross_attn_input_size, seq_len=PSEUDO_TEXT_LEN
        )
    if args.cpu_offload or args.vae_tiling:
        pipe.enable_vae_tiling()

    apg = (
        APGConfig(enabled=True,
                  orthogonal_threshold=args.apg_orthogonal_threshold)
        if args.apg else None
    )

    init_image = mask_image = None
    try:
        if args.image:
            init_image = load_image(args.image, size=(args.height, args.width),
                                    what="--image")
        if args.mask:
            f = pipe.vae_scale_factor
            mask_image = load_image(args.mask, "L", size=(args.height // f, args.width // f),
                                    what="--mask")
    except ValueError as e:
        raise SystemExit(str(e)) from None

    t0 = time.perf_counter()
    out = pipe(
        prompt=args.prompt,
        negative_prompt=args.negative_prompt,
        height=args.height,
        width=args.width,
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale,
        num_images_per_prompt=args.num_images,
        generator=torch.Generator(device).manual_seed(args.seed),
        apg_config=apg,
        image=init_image,
        strength=args.strength,
        mask_image=mask_image,
        guidance_interval=args.guidance_interval,
        sampler=args.sampler,
    )
    dt = time.perf_counter() - t0

    base = Path(args.output_file)
    meta = {
        "prompt": args.prompt,
        "negative_prompt": args.negative_prompt,
        "width": args.width, "height": args.height,
        "steps": args.num_inference_steps,
        "guidance_scale": args.guidance_scale,
        "guidance_interval": args.guidance_interval,
        "sampler": args.sampler,
        "seed": args.seed, "model": args.model,
        "image": args.image,
        "strength": args.strength if args.image else None,
        "mask": args.mask,
        "apg": args.apg or None,
        "quantize": args.quantize or None,
        "lora_path": args.lora_path,
    }
    paths = []
    for i, img in enumerate(out.images, 1):
        path = (base if len(out.images) == 1
                else base.with_name(f"{base.stem}_{i}{base.suffix}"))
        save_with_metadata(img, path, {**meta, "num_images": args.num_images,
                                       "image_index": i})
        paths.append(path)
    logger.info("generated %d image(s) in %.2fs -> %s",
                len(paths), dt, ", ".join(map(str, paths)))
    print(f"generated {len(paths)} image(s) in {dt:.2f}s")
    for p in paths:
        print(f"  {p}")
    return paths


# --from_png metadata key -> CLI arg name
_PNG_META_ARGS = [
    ("prompt", "prompt"), ("negative_prompt", "negative_prompt"),
    ("width", "width"), ("height", "height"),
    ("steps", "num_inference_steps"),
    ("guidance_scale", "guidance_scale"),
    ("guidance_interval", "guidance_interval"), ("seed", "seed"),
    ("model", "model"), ("image", "image"), ("strength", "strength"),
    ("mask", "mask"), ("apg", "apg"), ("quantize", "quantize"),
    ("lora_path", "lora_path"), ("num_images", "num_images"),
    ("sampler", "sampler"),
]


def _apply_png_metadata(args, parser):
    """Fill the args still at their parser default from the PNG's stamp
    (a flag passed explicitly wins; one passed at its default value counts
    as unset)."""
    from f_lite_tpu_torch.utils.image import read_metadata

    meta = read_metadata(args.from_png)
    if not meta:
        raise SystemExit(f"{args.from_png} has no f-lite metadata")
    defaults = vars(parser.parse_args([]))
    for mk, arg in _PNG_META_ARGS:
        if mk in meta and getattr(args, arg) == defaults[arg]:
            setattr(args, arg, meta[mk])
    # one seed draws the whole batch: image k of N comes back as the k-th
    # output of a run with the same num_images (restored above)
    if meta.get("image_index", 1) > 1:
        logger.warning(
            "--from_png source was image %s of %s: it reproduces as the "
            "%s-th output of this run, not the first",
            meta["image_index"], meta.get("num_images"), meta["image_index"],
        )
    if meta.get("batch_index", 0) > 0:
        logger.warning(
            "--from_png source was batch position %s of a serve batch "
            "(batch_size=%s): exact reproduction needs the same batch "
            "composition; this run will differ",
            meta["batch_index"], meta.get("batch_size"),
        )
    return args


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.from_png:
        args = _apply_png_metadata(args, parser)
    if args.prompt is None:
        parser.error("--prompt is required (or --from_png with metadata)")
    return generate_images(args)


if __name__ == "__main__":
    main()
