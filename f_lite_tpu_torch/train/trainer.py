"""Training entry point: `python -m f_lite_tpu_torch.train` (counterpart of
`python -m f_lite_tpu.train`, with the same option names).

Ported: the DiT model options, `--pixel_space`, the precomputed-data path
(`--use_precomputed_data --precomputed_data_dir`, caption dropout 0.01),
batch size / epochs / max_steps, the optimizer and schedule options,
`--use_8bit_adam`, `--max_grad_norm`, `--mixed_precision bf16` (fp32 master
weights, bf16 compute), `--gradient_checkpointing` with `--remat_policy
full`, `--seed`, `--output_dir`, `--log_every`, `--report_to none` and
`--export_pipeline` (writes `pipeline/dit/{config.json,
flax_params.safetensors}`, which both packages load). The log line and the
returned dict are the JAX trainer's.

Every other option raises "not ported yet" when set to a value that would
do something. Options that only the JAX program or the online image path
read (text encoder, resolution, worker counts) are accepted and unused.
The run is on the card (`--device cuda`) unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import random
import time
from pathlib import Path

import torch

logger = logging.getLogger("f_lite_tpu_torch.train")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DiT training (PyTorch port)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    # Model
    p.add_argument("--pretrained_model_path", type=str, default=None)
    p.add_argument("--vae_path", type=str, default=None)
    p.add_argument("--text_encoder_path", type=str, default=None)
    p.add_argument("--text_encoder_type", type=str, default="zero",
                   choices=["t5", "qwen2", "torch", "zero", "precomputed"])
    p.add_argument("--processor_path", type=str, default=None)
    p.add_argument("--model_width", type=int, default=3072)
    p.add_argument("--model_depth", type=int, default=40)
    p.add_argument("--model_head_dim", type=int, default=256)
    p.add_argument("--in_channels", type=int, default=16)
    p.add_argument("--model_patch_size", type=int, default=2)
    p.add_argument("--pixel_space", action="store_true",
                   help="train on RGB pixels (identity VAE); implies "
                        "--in_channels 3")
    p.add_argument("--rope_base", type=int, default=10_000)
    p.add_argument("--cross_attn_input_size", type=int, default=4096)
    p.add_argument("--mlp_ratio", type=float, default=4.0)
    p.add_argument("--cross_attn_first_n", type=int, default=8)
    p.add_argument("--cross_attn_period", type=int, default=4)
    p.add_argument("--cross_attn_all", action="store_true")
    p.add_argument("--adaln_mode", type=str, default="shared",
                   choices=["shared", "per_block"])
    p.add_argument("--residual_v", action="store_true")
    p.add_argument("--train_bias_and_rms", action="store_true")
    p.add_argument("--scan_layers", action="store_true")
    # Data
    p.add_argument("--train_data_path", type=str, default=None)
    p.add_argument("--val_data_path", type=str, default=None)
    p.add_argument("--base_image_dir", type=str, default=None)
    p.add_argument("--image_column", type=str, default="media_path")
    p.add_argument("--caption_column", type=str, default="captions")
    p.add_argument("--root_dir_type", type=str, default="parquet")
    p.add_argument("--base_url", type=str, default="dummy://")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--center_crop", action="store_true")
    p.add_argument("--random_flip", action="store_true",
                   help="on the precomputed path: latent h-flip")
    p.add_argument("--use_resolution_buckets", action="store_true")
    p.add_argument("--num_workers", type=int, default=4,
                   help="accepted; the port loads in-process")
    p.add_argument("--loader_worker_type", choices=("thread", "process"),
                   default="thread")
    # Training
    p.add_argument("--train_batch_size", type=int, default=1)
    p.add_argument("--eval_batch_size", type=int, default=1)
    p.add_argument("--num_epochs", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--lr_scheduler", type=str, default="linear",
                   choices=["linear", "cosine", "wsd", "constant"])
    p.add_argument("--num_warmup_steps", type=int, default=0)
    p.add_argument("--use_8bit_adam", action="store_true",
                   help="bf16 first moments")
    p.add_argument("--use_precomputed_data", action="store_true")
    p.add_argument("--precomputed_data_dir", type=str, default=None)
    p.add_argument("--batch_multiplicity", type=int, default=1)
    p.add_argument("--ema_decay", type=float, default=0.0)
    p.add_argument("--ema_dtype", choices=("fp32", "bf16"), default="fp32")
    p.add_argument("--bs_rampup", type=int, default=None)
    p.add_argument("--uncond_prob", type=float, default=0.05)
    p.add_argument("--sequence_dropout", type=float, default=0.0)
    # Parallelism
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sequence_parallel", action="store_true")
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--pp_microbatches", type=int, default=1)
    p.add_argument("--multihost", action="store_true")
    # LoRA
    p.add_argument("--use_lora", action="store_true")
    p.add_argument("--train_only_lora", action="store_true")
    p.add_argument("--lora_rank", type=int, default=64)
    p.add_argument("--lora_alpha", type=int, default=64)
    p.add_argument("--lora_target_modules", type=str,
                   default="qkv,q,context_kv,proj")
    p.add_argument("--lora_dropout", type=float, default=0.0)
    p.add_argument("--lora_checkpoint", type=str, default=None)
    # Other
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--output_dir", type=str, default="dit-finetuned")
    # 0 until checkpointing is ported; the JAX trainer's default of 500
    # returns with it
    p.add_argument("--checkpointing_steps", type=int, default=0)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--async_checkpoint", action="store_true")
    # off until checkpointing is ported (the JAX default is on)
    p.add_argument("--graceful_term", action=argparse.BooleanOptionalAction,
                   default=False)
    p.add_argument("--mixed_precision", type=str, default=None,
                   choices=["no", "bf16"])
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--remat_policy", choices=("full", "dots"),
                   default="full")
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--debug_nans", action="store_true")
    # Logging / eval ("none" and 0 until metrics backends, sampling and
    # eval are ported; the JAX defaults are tensorboard and 500)
    p.add_argument("--logging_dir", type=str, default="logs")
    p.add_argument("--report_to", type=str, default="none",
                   choices=["tensorboard", "wandb", "all", "none"])
    p.add_argument("--project_name", type=str, default="dit-finetune")
    p.add_argument("--run_name", type=str, default=None)
    p.add_argument("--sample_every", type=int, default=0)
    p.add_argument("--eval_every", type=int, default=0)
    p.add_argument("--sample_prompts_file", type=str, default=None)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--export_pipeline", action="store_true")
    p.add_argument("--profile_steps", type=str, default=None)
    return p.parse_args(argv)


# option -> (value that does nothing, what it needs)
_NOT_PORTED = {
    "pretrained_model_path": (None, "fine-tuning from a pipeline"),
    "vae_path": (None, "the VAE encoder"),
    "scan_layers": (False, "scan-stacked blocks"),
    "train_data_path": (None, "the online image path"),
    "val_data_path": (None, "validation"),
    "use_resolution_buckets": (False, "the bucket sampler"),
    "gradient_accumulation_steps": (1, "gradient accumulation"),
    "batch_multiplicity": (1, "batch multiplicity"),
    "ema_decay": (0.0, "EMA"),
    "bs_rampup": (None, "bs_rampup"),
    "sequence_dropout": (0.0, "sequence dropout (token_indices)"),
    "dp": (1, "data parallelism"),
    "fsdp": (1, "fsdp"),
    "tp": (1, "tensor parallelism"),
    "sequence_parallel": (False, "sequence parallelism"),
    "pp": (1, "pipeline parallelism"),
    "pp_microbatches": (1, "pipeline parallelism"),
    "multihost": (False, "multihost"),
    "use_lora": (False, "LoRA"),
    "train_only_lora": (False, "LoRA"),
    "lora_checkpoint": (None, "LoRA"),
    "checkpointing_steps": (0, "checkpointing"),
    "checkpoints_total_limit": (None, "checkpointing"),
    "resume_from_checkpoint": (None, "resume"),
    "async_checkpoint": (False, "async checkpoints"),
    "graceful_term": (False, "checkpoint on SIGTERM"),
    "remat_policy": ("full", 'remat_policy "dots"'),
    "debug_nans": (False, "NaN checking"),
    "report_to": ("none", "metrics backends"),
    "sample_every": (0, "sampling during training"),
    "sample_prompts_file": (None, "sampling during training"),
    "eval_every": (0, "eval during training"),
    "profile_steps": (None, "profiling"),
}


def check_ported(args) -> None:
    """Raise SystemExit for every option set to something the port cannot
    do yet."""
    for name, (inert, what) in _NOT_PORTED.items():
        if getattr(args, name) != inert:
            raise SystemExit(
                f"--{name} {getattr(args, name)!r}: {what} is not ported yet")
    if not args.use_precomputed_data:
        raise SystemExit(
            "the online image path (VAE encode of images) is not ported yet: "
            "pass --use_precomputed_data --precomputed_data_dir")
    if not args.precomputed_data_dir:
        raise SystemExit("--use_precomputed_data requires --precomputed_data_dir")


def build_config(args):
    from f_lite_tpu_torch.models.dit import DiTConfig

    return DiTConfig(
        in_channels=3 if args.pixel_space else args.in_channels,
        patch_size=args.model_patch_size,
        hidden_size=args.model_width,
        depth=args.model_depth,
        num_heads=args.model_width // args.model_head_dim,
        mlp_ratio=args.mlp_ratio,
        cross_attn_input_size=args.cross_attn_input_size,
        cross_attn_first_n=args.cross_attn_first_n,
        cross_attn_period=args.cross_attn_period,
        cross_attn_all=args.cross_attn_all,
        adaln_mode=args.adaln_mode,
        rope_base=args.rope_base,
        residual_v=args.residual_v,
        train_bias_and_rms=args.train_bias_and_rms,
        gradient_checkpoint=args.gradient_checkpointing,
        remat_policy=args.remat_policy,
        dtype=torch.bfloat16 if args.mixed_precision == "bf16" else None,
    )


def export_pipeline(model, path: Path) -> None:
    """Write a pipeline directory with the DiT alone (pixel-space and
    precomputed runs have no VAE to export): `model_index.json`,
    `dit/config.json` and `dit/flax_params.safetensors` in the JAX layout."""
    from f_lite_tpu_torch.convert.to_jax import state_dict_to_jax
    from f_lite_tpu_torch.utils.safetensors import save_file

    (path / "dit").mkdir(parents=True, exist_ok=True)
    (path / "model_index.json").write_text(json.dumps(
        {"_class_name": "FLitePipeline", "framework": "f-lite-tpu"}, indent=2))
    (path / "dit" / "config.json").write_text(
        json.dumps(model.config.to_json_dict(), indent=2))
    save_file(state_dict_to_jax(model.state_dict(), model.config),
              path / "dit" / "flax_params.safetensors")


def train(args, on_step=None) -> dict:
    """Train as `args` say; `on_step(state, metrics)`, when given, is called
    after every step with the `TrainState` and the step's metrics (device
    tensors)."""
    from f_lite_tpu_torch.data.precomputed import create_precomputed_data_loader
    from f_lite_tpu_torch.models.dit import DiT
    from f_lite_tpu_torch.pipeline import resolve_device
    from f_lite_tpu_torch.train.optim import build_lr_schedule, build_optimizer
    from f_lite_tpu_torch.train.step import TrainState, train_step

    t_start = time.time()
    check_ported(args)
    device = resolve_device(args.device)
    seed = args.seed or 0
    if args.seed is not None:
        random.seed(args.seed)  # the latent flip's draws
    dtype = torch.bfloat16 if args.mixed_precision == "bf16" else torch.float32

    cfg = build_config(args)
    with torch.device(device):
        model = DiT(cfg)  # fp32 master weights; compute in cfg.dtype
    model.init_weights(torch.Generator(device).manual_seed(seed)).train()
    n_params = sum(p.numel() for p in model.parameters())

    dl, sampler = create_precomputed_data_loader(
        args.precomputed_data_dir, args.train_batch_size, seed=seed,
        latent_flip=args.random_flip)
    max_steps = args.max_steps or len(dl) * args.num_epochs
    opt = build_optimizer(
        list(model.parameters()), learning_rate=args.learning_rate,
        lr_scheduler=args.lr_scheduler, num_warmup_steps=args.num_warmup_steps,
        max_steps=max_steps, weight_decay=args.weight_decay,
        max_grad_norm=args.max_grad_norm,
        moment_dtype=torch.bfloat16 if args.use_8bit_adam else None)
    lr_fn = build_lr_schedule(args.lr_scheduler, args.learning_rate,
                              num_warmup_steps=args.num_warmup_steps,
                              max_steps=max_steps)
    state = TrainState(model, opt)
    gen = torch.Generator(device).manual_seed(seed)
    uncond_prob = 0.01  # the precomputed path's caption dropout

    logger.info("device=%s params=%d dtype=%s", device, n_params, dtype)
    logger.info("dataset=%d items, %d batches/epoch, max_steps=%d",
                len(dl.dataset), len(dl), max_steps)
    bin_sums = torch.zeros(10, device=device)
    bin_counts = torch.zeros(10, device=device)
    global_step = 0
    result: dict = {}
    stop = False
    for epoch in range(args.num_epochs):
        sampler.set_epoch(epoch)
        epoch_start = time.time()
        for batch in dl:
            latents = torch.from_numpy(batch["vae_latent"]).to(device, dtype)
            ctx = torch.from_numpy(batch["text_embedding"]).to(device, dtype)
            mask = torch.from_numpy(batch["text_mask"]).to(device)
            metrics = train_step(state, latents, ctx, mask, generator=gen,
                                 uncond_prob=uncond_prob,
                                 patch_size=cfg.patch_size)
            global_step += 1
            if on_step is not None:
                on_step(state, metrics)
            bin_sums += metrics["bin_sums"]
            bin_counts += metrics["bin_counts"]
            if global_step % args.log_every == 0:
                logs = {
                    "train/loss": float(metrics["loss"]),
                    "train/diffusion_loss": float(metrics["loss"]),
                    "train/lr": lr_fn(global_step),
                    "train/epoch": epoch,
                    "train/step": global_step,
                    "train/grad_norm": float(metrics["grad_norm"]),
                }
                bs, bc = bin_sums.cpu().numpy(), bin_counts.cpu().numpy()
                for i in range(10):
                    if bc[i] > 0:
                        logs[f"metrics/avg_loss_bin_{i}"] = float(bs[i] / bc[i])
                logger.info("step %d loss %.4f lr %.2e grad %.3f",
                            global_step, logs["train/loss"], logs["train/lr"],
                            logs["train/grad_norm"])
                bin_sums.zero_()
                bin_counts.zero_()
                result.update(logs)
            if global_step >= max_steps:
                stop = True
                break
        logger.info("epoch %d done in %.1fs", epoch, time.time() - epoch_start)
        if stop:
            break

    if args.export_pipeline:
        export_dir = Path(args.output_dir) / "pipeline"
        export_pipeline(model, export_dir)
        logger.info("exported pipeline to %s", export_dir)
    result["global_step"] = global_step
    result["wall_s"] = time.time() - t_start
    logger.info("training completed after %d steps (%.1fs)", global_step,
                result["wall_s"])
    return result


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    return train(parse_args(argv))
