"""Convert between the reference's torch checkpoints and the native layout
(counterpart of the repo tool `tools/convert_checkpoint.py`).

Sources (exactly one):
- `--pt model.pt`            the reference's raw torch DiT state dict;
- `--hf_dir <dir>`           the reference's diffusers layout (DiT under
                             `dit_model/` or `transformer/`, `vae/`, HF
                             `text_encoder/` and `tokenizer/`);
- `--export_torch CKPT_DIR`  the reverse: a native dir (`dit/config.json` +
                             `flax_params.safetensors`, unrolled,
                             scan-stacked, pipeline-parallel or head-padded;
                             optional `vae/`, `text_encoder/`, `tokenizer/`)
                             -> the reference's diffusers layout
                             (`dit_model/`, `vae/`, `model_index.json`,
                             every tensor fp32) and, with `--pt_file`, a raw
                             torch `.pt` of the DiT's fp32 state dict;
- `--export_lora PATH`       the reverse for LoRA factors (a trainer
                             `--use_lora` dir or `.safetensors`) -> the
                             reference's peft `lora_weights.pt`.
`--pt` and `--hf_dir` write the native layout to `--output_dir`
(`convert/ingest.py`); `--test_image` then renders one 256 px, 4-step
image through the result (`ZeroTextEncoder`, bf16) and writes
`test_image.png` (the port's PNG writer), or, in pixel space, returns the
latents unwritten, as the JAX tool does. An int8 checkpoint is refused for
export: quantization is lossy.

The options and defaults are the JAX tool's, plus `--device`, where
`--test_image` renders. The tool runs on the card unless `--device cpu` is
given, and raises without one. Nothing here needs JAX, `safetensors` or
`transformers`: tensors go through the port's own reader and writer
(`utils/safetensors.py`), the maps through `convert/from_jax.py` and
`convert/lora_torch.py`.

    python -m f_lite_tpu_torch.tools.convert_checkpoint --pt f_lite_7b.pt \\
        --width 3072 --output_dir ./f-lite-7b
    python -m f_lite_tpu_torch.tools.convert_checkpoint --export_torch \\
        ./f-lite-7b --output_dir ./f-lite-7b-hf --pt_file ./f_lite_7b.pt
"""

from __future__ import annotations

import argparse
import json
import logging
import shutil
from pathlib import Path

import torch

logger = logging.getLogger("f_lite_tpu_torch.convert")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Convert F-Lite checkpoints between the reference's "
                    "torch layouts and the native layout")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--pt", type=str, help="raw .pt DiT state dict")
    src.add_argument("--hf_dir", type=str, help="diffusers-layout dir")
    src.add_argument("--export_torch", type=str, metavar="CKPT_DIR",
                     help="reverse: native checkpoint dir -> torch/HF")
    src.add_argument("--export_lora", type=str, metavar="LORA_PATH",
                     help="reverse: LoRA factors (trainer --use_lora dir or "
                          ".safetensors) -> the reference's peft "
                          "lora_weights.pt")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--pt_file", type=str, default=None,
                   help="(with --export_torch) also write a raw torch .pt "
                        "state dict at this path")
    # the .pt path's architecture fallbacks (the reference's pt.py defaults)
    p.add_argument("--width", type=int, default=3072)
    p.add_argument("--head_dim", type=int, default=256)
    p.add_argument("--patch_size", type=int, default=2)
    p.add_argument("--mlp_ratio", type=float, default=4.0)
    p.add_argument("--cross_attn_input_size", type=int, default=4096)
    p.add_argument("--residual_v", action="store_true", default=True)
    p.add_argument("--no_residual_v", dest="residual_v",
                   action="store_false")
    p.add_argument("--train_bias_and_rms", action="store_true")
    p.add_argument("--vae_dir", type=str, default=None,
                   help="diffusers VAE dir (config.json + safetensors)")
    p.add_argument("--text_encoder_dir", type=str, default=None)
    p.add_argument("--tokenizer_dir", type=str, default=None)
    p.add_argument("--test_image", action="store_true")
    p.add_argument("--strict", action="store_true",
                   help="fail (instead of warn) when the source ships keys "
                        "the conversion does not consume or lacks keys the "
                        "config implies (convert/manifest.py)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of --test_image; 'cpu' runs it on "
                        "the CPU")
    return p.parse_args(argv)


def hf_component_class(subdir: Path) -> str:
    """The transformers class of a copied text_encoder/tokenizer dir, for
    its `model_index.json` entry: tokenizer_config.json's tokenizer_class,
    else config.json's architectures[0], else the Auto loader of its
    kind."""
    tok_cfg = subdir / "tokenizer_config.json"
    if tok_cfg.exists():
        cls = json.loads(tok_cfg.read_text()).get("tokenizer_class")
        return cls or "AutoTokenizer"
    model_cfg = subdir / "config.json"
    if model_cfg.exists():
        arch = json.loads(model_cfg.read_text()).get("architectures") or []
        if arch:
            return arch[0]
    return "AutoTokenizer" if "tokenizer" in subdir.name else "AutoModel"


def export_torch(args) -> Path:
    """A native dir -> the reference's diffusers layout: `dit_model/` and
    `vae/` (fp32 safetensors under the reference's names, their
    `config.json`), copies of `text_encoder/` and `tokenizer/`, and
    `model_index.json` with an entry for each component written."""
    from f_lite_tpu_torch.convert.from_jax import (
        reference_dit_config,
        reference_vae_config,
        state_dict_from_jax,
        vae_state_dict_from_jax,
    )
    from f_lite_tpu_torch.models.dit import DiTConfig
    from f_lite_tpu_torch.models.vae import VAEConfig
    from f_lite_tpu_torch.utils.safetensors import load_file, save_file

    ck, out = Path(args.export_torch), Path(args.output_dir)
    cfg = DiTConfig.from_json_dict(json.loads((ck / "dit" / "config.json").read_text()))
    flat = load_file(ck / "dit" / "flax_params.safetensors")
    if any(name.endswith(".w8") for name in flat):  # `from_jax` would take them
        raise ValueError(
            "cannot export int8-quantized params to torch — quantization is "
            "lossy; export the source bf16/fp32 checkpoint instead")
    sd = state_dict_from_jax(flat, cfg)
    del flat
    logger.info("inverted DiT: width=%d depth=%d heads=%d (%d tensors)",
                cfg.hidden_size, cfg.depth, cfg.num_heads, len(sd))
    (out / "dit_model").mkdir(parents=True, exist_ok=True)
    save_file(sd, out / "dit_model" / "diffusion_pytorch_model.safetensors")
    (out / "dit_model" / "config.json").write_text(
        json.dumps(reference_dit_config(cfg), indent=2))

    index = {"_class_name": "FLitePipeline", "dit_model": ["f_lite.model", "DiT"]}
    vae_ck = ck / "vae"
    if vae_ck.exists():
        # an entry only for a subdir written: diffusers-style consumers
        # resolve every entry of model_index.json
        index["vae"] = ["diffusers", "AutoencoderKL"]
        vcfg = VAEConfig.from_json_dict(json.loads((vae_ck / "config.json").read_text()))
        vsd = vae_state_dict_from_jax(load_file(vae_ck / "flax_params.safetensors"), vcfg)
        (out / "vae").mkdir(exist_ok=True)
        save_file(vsd, out / "vae" / "diffusion_pytorch_model.safetensors")
        (out / "vae" / "config.json").write_text(
            json.dumps(reference_vae_config(vcfg), indent=2))
        logger.info("inverted VAE (%d tensors)", len(vsd))
    for sub in ("text_encoder", "tokenizer"):
        if (ck / sub).exists():
            shutil.copytree(ck / sub, out / sub, dirs_exist_ok=True)
            index[sub] = ["transformers", hf_component_class(out / sub)]
    (out / "model_index.json").write_text(json.dumps(index, indent=2))

    if args.pt_file:
        torch.save(sd, args.pt_file)
        logger.info("raw torch state dict written to %s", args.pt_file)
    logger.info("torch/HF export written to %s", out)
    return out


def export_lora(args) -> Path:
    """LoRA factors -> the reference's peft `lora_weights.pt` in
    `--output_dir` (the other direction needs no tool: `lora_path=` takes
    a `lora_weights.pt`)."""
    from f_lite_tpu_torch.convert.lora_torch import lora_to_peft_state_dict
    from f_lite_tpu_torch.train.lora import load_lora_weights

    sd = lora_to_peft_state_dict(load_lora_weights(args.export_lora))
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / "lora_weights.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))
    logger.info("peft LoRA state dict (%d tensors) written to %s", len(sd), path)
    return path


def render_test_image(out: Path, device):
    """The JAX tool's smoke request on the converted dir: one 256 px image
    of "a photo of a cat" in 4 steps (start noise seed 1 on `device`),
    bf16, through a `ZeroTextEncoder` of 32 tokens; written as
    `test_image.png`, or, in pixel space, its latents returned unwritten.
    The pipeline's output."""
    from f_lite_tpu_torch.models.vae import IdentityVAE
    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.text.encoder import ZeroTextEncoder
    from f_lite_tpu_torch.utils.image import png_bytes_with_metadata

    pipe = FLitePipeline.from_pretrained(out, dtype=torch.bfloat16, device=device,
                                         load_text_encoder=False)
    pipe.text_encoder = ZeroTextEncoder(
        embed_dim=pipe.dit.config.cross_attn_input_size, seq_len=32)
    pixel_space = isinstance(pipe.vae, IdentityVAE)
    o = pipe(prompt="a photo of a cat", height=256, width=256,
             num_inference_steps=4,
             generator=torch.Generator(device).manual_seed(1),
             return_latents=pixel_space)
    if not pixel_space:
        (out / "test_image.png").write_bytes(png_bytes_with_metadata(o.images[0]))
    logger.info("smoke test image generated")
    return o


def main(argv=None) -> Path:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("convert_checkpoint: needs an NVIDIA GPU (pass "
                         "--device cpu to run on the CPU)")
    if args.export_torch:
        return export_torch(args)
    if args.export_lora:
        return export_lora(args)

    from f_lite_tpu_torch.convert.ingest import convert_reference_checkpoint

    out = convert_reference_checkpoint(
        args.output_dir,
        pt=args.pt,
        hf_dir=args.hf_dir,
        vae_dir=args.vae_dir,
        text_encoder_dir=args.text_encoder_dir,
        tokenizer_dir=args.tokenizer_dir,
        width=args.width,
        head_dim=args.head_dim,
        patch_size=args.patch_size,
        mlp_ratio=args.mlp_ratio,
        cross_attn_input_size=args.cross_attn_input_size,
        residual_v=args.residual_v,
        train_bias_and_rms=args.train_bias_and_rms,
        strict="error" if args.strict else None,
    )
    if args.test_image:
        render_test_image(out, device)
    return out


if __name__ == "__main__":
    main()
