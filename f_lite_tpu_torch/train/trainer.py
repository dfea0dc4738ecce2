"""Training entry point: `python -m f_lite_tpu_torch.train` (counterpart of
`python -m f_lite_tpu.train`, with the same option names).

Ported: the DiT model options, `--pixel_space`, the precomputed-data path
(`--use_precomputed_data --precomputed_data_dir`, caption dropout 0.01,
`--use_resolution_buckets`), batch size / epochs / max_steps, the optimizer
and schedule options, `--use_8bit_adam`, `--max_grad_norm`,
`--mixed_precision bf16` (fp32 master weights, bf16 compute),
`--gradient_checkpointing` with `--remat_policy full|dots`, `--seed`,
`--output_dir`, `--log_every`, `--report_to none`, and the run state and
recipe options:
- `--pretrained_model_path` (fine-tune a pipeline dir of any layout, loaded
  strictly into the model the arguments build; its VAE unless
  `--vae_path`);
- `--checkpointing_steps`, `--checkpoints_total_limit`,
  `--resume_from_checkpoint latest|DIR`, `--async_checkpoint`,
  `--graceful_term` (`train/checkpoint.py`; the port's own format);
- `--use_lora` with `--lora_rank`, `--lora_alpha`, `--lora_target_modules`
  and `--lora_checkpoint` (the base frozen, the factors merged in the step;
  `lora_weights.safetensors` in the final checkpoint);
- `--ema_decay`, `--ema_dtype`; `--bs_rampup`;
  `--gradient_accumulation_steps` (`optim.Accumulate`; `global_step`
  counts micro-batches, as in the JAX trainer) and `--batch_multiplicity`;
  `--sequence_dropout`;
- `--export_pipeline` (writes `pipeline/` through
  `FLitePipeline.save_pretrained`, which both packages load: the DiT, with
  the EMA and the merged factors where they are on, and, but in pixel
  space, the run's VAE).
Each step's draws come from a generator keyed by (seed, step), so a resumed
run repeats the straight run's. The log line and the returned dict are the
JAX trainer's.

Every other option raises "not ported yet" when set to a value that would
do something (the online image path with its buckets, validation and
sampling, metrics backends, profiling, NaN checks, `--scan_layers` and
multi-GPU). `--train_only_lora` is accepted and unused, as in the JAX
trainer. Options that only the JAX program or the online image path
read (text encoder, resolution, worker counts) are accepted and unused.
The run is on the card (`--device cuda`) unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import random
import signal
import time
from pathlib import Path

import numpy as np
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
    p.add_argument("--use_resolution_buckets", action="store_true",
                   help="batches of one latent shape (precomputed path)")
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
    p.add_argument("--train_only_lora", action="store_true",
                   help="accepted and unused, as in the JAX trainer: "
                        "--use_lora always trains the factors only")
    p.add_argument("--lora_rank", type=int, default=64)
    p.add_argument("--lora_alpha", type=int, default=64)
    p.add_argument("--lora_target_modules", type=str,
                   default="qkv,q,context_kv,proj")
    p.add_argument("--lora_dropout", type=float, default=0.0)
    p.add_argument("--lora_checkpoint", type=str, default=None)
    # Other
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--output_dir", type=str, default="dit-finetuned")
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--async_checkpoint", action="store_true")
    p.add_argument("--graceful_term", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="on SIGTERM/SIGINT finish the step, checkpoint and "
                        "exit 0; a second signal kills")
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
    "scan_layers": (False, "scan-stacked blocks"),
    "train_data_path": (None, "the online image path"),
    "val_data_path": (None, "validation"),
    "dp": (1, "data parallelism"),
    "fsdp": (1, "fsdp"),
    "tp": (1, "tensor parallelism"),
    "sequence_parallel": (False, "sequence parallelism"),
    "pp": (1, "pipeline parallelism"),
    "pp_microbatches": (1, "pipeline parallelism"),
    "multihost": (False, "multihost"),
    "debug_nans": (False, "NaN checking"),
    "report_to": ("none", "metrics backends"),
    "sample_every": (0, "sampling during training"),
    "sample_prompts_file": (None, "sampling during training"),
    "eval_every": (0, "eval during training"),
    "profile_steps": (None, "profiling"),
}


def check_ported(args) -> None:
    """Raise SystemExit for a combination the JAX trainer rejects, and for
    every option set to something the port cannot do yet."""
    if args.use_lora and args.scan_layers:
        raise SystemExit(
            "--use_lora is incompatible with --scan_layers: LoRA factors "
            "attach to unrolled 2-D kernels (stacked scan kernels would "
            "produce an empty factor tree and train nothing)")
    if args.use_lora and args.lora_dropout:
        raise SystemExit(
            "--lora_dropout > 0 is unsupported: LoRA factors are merged "
            "into the base weights inside jit (train/lora.py), which "
            "cannot express per-sample branch-input dropout. The "
            "reference default is 0.0; use --uncond_prob / "
            "--sequence_dropout for regularization instead.")
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
    if args.ema_decay != 0.0 and not 0.0 < args.ema_decay < 1.0:
        # 1.0 would freeze the EMA, which the export prefers, at the start
        raise ValueError(f"--ema_decay must be 0 (off) or in (0, 1), got "
                         f"{args.ema_decay}")


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


def build_vae(args, device):
    """The run's VAE, as the JAX trainer's `build_vae` makes it: None in
    pixel space (the identity), the native `vae/` dir of `--vae_path`, else
    a tiny VAE with 16 latent channels and seeded weights (flax's default
    initializers; not `jax.random`'s draws). fp32. The precomputed path
    trains on latents, so the VAE only goes into the export."""
    from f_lite_tpu_torch.convert.from_jax import vae_state_dict_from_jax
    from f_lite_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from f_lite_tpu_torch.utils.safetensors import load_file

    if args.pixel_space:
        return None
    if args.vae_path:
        vp = Path(args.vae_path)
        cfg = VAEConfig.from_json_dict(json.loads((vp / "config.json").read_text()))
        vae = AutoencoderKL(cfg)
        vae.load_state_dict(vae_state_dict_from_jax(
            load_file(vp / "flax_params.safetensors"), cfg))
        return vae.to(device).eval()
    with torch.device(device):
        vae = AutoencoderKL(VAEConfig.tiny(latent_channels=16))
    return vae.init_weights(torch.Generator(device).manual_seed(0)).eval()


def load_pretrained(args, model, device):
    """Load `--pretrained_model_path`'s DiT (any layout the port's loader
    takes) strictly into `model`, built from the arguments; return the
    pipeline's VAE (None in pixel space, with `--vae_path`, or without
    one)."""
    from f_lite_tpu_torch.models.vae import AutoencoderKL
    from f_lite_tpu_torch.pipeline import FLitePipeline

    pipe = FLitePipeline.from_pretrained(
        args.pretrained_model_path, dtype=torch.float32, device=device,
        load_text_encoder=False)
    try:
        model.load_state_dict(pipe.dit.state_dict(), strict=True)
    except RuntimeError as e:
        raise ValueError(
            f"--pretrained_model_path {args.pretrained_model_path}: its DiT "
            f"does not fit the model the arguments build: {e}") from None
    if args.pixel_space or args.vae_path or not isinstance(pipe.vae, AutoencoderKL):
        return None
    return pipe.vae


def rampup_weights(step: int, bsz: int, rampup: int | None, seed: int):
    """`--bs_rampup`'s 0/1 loss weights of step `step` (None: the whole
    batch): min(bsz, ceil((step + 1) bsz / (4 rampup)) * 4) rows, the first
    of `RandomState((seed * 1000003 + step) % 2**32).permutation(bsz)`."""
    if not rampup or step >= rampup:
        return None
    target = min(bsz, -(-(step + 1) * bsz // (rampup * 4)) * 4)
    if target >= bsz:
        return None
    rs = np.random.RandomState((seed * 1000003 + step) % 2**32)
    w = np.zeros(bsz, np.float32)
    w[rs.permutation(bsz)[:target]] = 1.0
    return w


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The draws of step `step` (caption dropout, t, noise, kept tokens):
    keyed by (seed, step), as JAX's `fold_in(key(seed), step)`, so a run
    resumed at step N draws what the straight run drew there."""
    return torch.Generator(device).manual_seed(seed * 1000003 + step)


def state_tensors(trained: dict, opt) -> dict:
    """The checkpoint's tensors: the trained tensors and the optimizer's
    moments (and accumulator) under the trained tensors' names."""
    opt_state = opt.state_dict()
    out = dict(trained)
    for key in ("mu", "nu", "acc"):
        if key in opt_state:
            out.update({f"opt.{key}/{name}": t
                        for name, t in zip(trained, opt_state[key], strict=True)})
    return out


def restore_state(trained: dict, opt, tensors: dict, meta: dict) -> None:
    """Copy a checkpoint's tensors back into the trained tensors and the
    optimizer (which must have been built with the same options)."""
    expected = state_tensors(trained, opt)
    if set(tensors) != set(expected):
        raise ValueError(
            "checkpoint does not match this run's trained tensors and "
            f"optimizer: {sorted(set(tensors) ^ set(expected))[:5]}")
    with torch.no_grad():
        for name, t in trained.items():
            t.copy_(tensors[name])
    state = {"count": meta["count"], "mini_step": meta["mini_step"]}
    for key in ("mu", "nu", "acc"):
        if f"opt.{key}/{next(iter(trained))}" in tensors:
            state[key] = [tensors[f"opt.{key}/{name}"] for name in trained]
    opt.load_state_dict(state)


@torch.no_grad()
def ema_update(ema: dict, trained: dict, decay: float) -> None:
    """e <- (e * d + p * (1 - d)) in fp32, cast back to e's dtype."""
    for name, e in ema.items():
        p = trained[name].detach()
        e.copy_((e.float() * decay + p.float() * (1.0 - decay)).to(e.dtype))


def train(args, on_step=None) -> dict:
    """Train as `args` say; `on_step(state, metrics)`, when given, is called
    after every step with the `TrainState` and the step's metrics (device
    tensors)."""
    from f_lite_tpu_torch.convert.from_jax import unflatten
    from f_lite_tpu_torch.data.precomputed import create_precomputed_data_loader
    from f_lite_tpu_torch.models.dit import DiT
    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.train.checkpoint import Checkpointer
    from f_lite_tpu_torch.train.lora import (
        apply_lora,
        attach_lora,
        detach_lora,
        flatten_lora,
        init_lora_params,
        load_lora_weights,
        save_lora_weights,
    )
    from f_lite_tpu_torch.train.optim import build_lr_schedule, build_optimizer
    from f_lite_tpu_torch.train.step import TrainState, train_step
    from f_lite_tpu_torch.utils.device import resolve_device

    t_start = time.time()
    check_ported(args)
    device = resolve_device(args.device)
    seed = args.seed or 0
    if args.seed is not None:
        random.seed(args.seed)  # the latent flip's draws
    dtype = torch.bfloat16 if args.mixed_precision == "bf16" else torch.float32
    k_acc = args.gradient_accumulation_steps

    cfg = build_config(args)
    with torch.device(device):
        model = DiT(cfg)  # fp32 master weights; compute in cfg.dtype
    vae = None
    if args.pretrained_model_path:
        vae = load_pretrained(args, model, device)
    else:
        model.init_weights(torch.Generator(device).manual_seed(seed))
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    if vae is None:
        vae = build_vae(args, device)

    lora = None
    if args.use_lora:
        targets = tuple(t.strip() for t in args.lora_target_modules.split(",")
                        if t.strip())
        tree = (load_lora_weights(args.lora_checkpoint) if args.lora_checkpoint
                else init_lora_params(model, rank=args.lora_rank, targets=targets,
                                      generator=torch.Generator(device).manual_seed(7)))
        lora = attach_lora(model, tree, alpha=args.lora_alpha, rank=args.lora_rank)
        trained = flatten_lora(lora)
    else:
        trained = dict(model.named_parameters())

    def loader(sampler_state=None):
        return create_precomputed_data_loader(
            args.precomputed_data_dir, args.train_batch_size, seed=seed,
            use_buckets=args.use_resolution_buckets,
            latent_flip=args.random_flip, sampler_state=sampler_state)

    dl, sampler = loader()
    # the JAX trainer's count: global_step counts micro-batches, the
    # default max_steps is the epochs' batches / k
    max_steps = args.max_steps or len(dl) * args.num_epochs // k_acc
    opt = build_optimizer(
        list(trained.values()), learning_rate=args.learning_rate,
        lr_scheduler=args.lr_scheduler, num_warmup_steps=args.num_warmup_steps,
        max_steps=max_steps, weight_decay=args.weight_decay,
        max_grad_norm=args.max_grad_norm,
        moment_dtype=torch.bfloat16 if args.use_8bit_adam else None,
        accumulation_steps=k_acc)
    lr_fn = build_lr_schedule(args.lr_scheduler, args.learning_rate,
                              num_warmup_steps=args.num_warmup_steps,
                              max_steps=max_steps)
    state = TrainState(model, opt)
    uncond_prob = 0.01  # the precomputed path's caption dropout

    ckpt = Checkpointer(args.output_dir, total_limit=args.checkpoints_total_limit)
    global_step = 0
    if args.resume_from_checkpoint:
        step_no = ckpt.resolve(args.resume_from_checkpoint)
        if step_no is not None:
            meta, tensors = ckpt.load(step_no)
            restore_state(trained, opt, tensors, meta)
            del tensors
            global_step = state.step = int(meta["step"])
            sstate = ckpt.load_sampler_state(step_no)
            if sstate:  # the loader this run trains with, resumed
                dl, sampler = loader(sstate)
            logger.info("resumed from step %d", global_step)

    ema = None
    if args.ema_decay != 0.0:
        ema_dt = torch.bfloat16 if args.ema_dtype == "bf16" else None
        ema = {name: t.detach().to(ema_dt if ema_dt and t.is_floating_point()
                                   else t.dtype, copy=True)
               for name, t in trained.items()}
        restored = ckpt.load_extra(global_step, "ema") if global_step else None
        if restored is not None:
            for name, e in ema.items():
                e.copy_(restored[name])

    logger.info("device=%s params=%d trained=%d dtype=%s", device, n_params,
                sum(t.numel() for t in trained.values()), dtype)
    logger.info("dataset=%d items, %d batches/epoch, max_steps=%d",
                len(dl.dataset), len(dl), max_steps)

    def save(step, wait=True):
        meta = {"step": step, "epoch": int(sampler.epoch), "count": opt.count,
                "mini_step": getattr(opt, "mini_step", 0)}
        return ckpt.save(step, state_tensors(trained, opt), meta,
                         sampler.state_dict(step), wait=wait,
                         extra={"ema": ema} if ema is not None else None)

    # finish the step in flight on SIGTERM / SIGINT, checkpoint and stop;
    # the handlers are restored after the loop (a second signal kills)
    preempt = {"sig": None}
    prev_handlers = {}
    if args.graceful_term:
        def _on_term(signum, frame):
            preempt["sig"] = signum
            logger.warning("signal %d received: will checkpoint and stop at "
                           "the next step boundary (send again to "
                           "force-kill)", signum)
            signal.signal(signum, prev_handlers.get(signum, signal.SIG_DFL))

        try:
            for s in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[s] = signal.signal(s, _on_term)
        except ValueError:
            prev_handlers = {}  # not the main thread (in-process callers)

    bin_sums = torch.zeros(10, device=device)
    bin_counts = torch.zeros(10, device=device)
    result: dict = {}
    stop = False
    # resume continues inside the saved epoch (the sampler's state)
    for epoch in range(int(sampler.epoch), args.num_epochs):
        sampler.set_epoch(epoch)
        epoch_start = time.time()
        for batch in dl:
            latents = torch.from_numpy(batch["vae_latent"]).to(device, dtype)
            ctx = torch.from_numpy(batch["text_embedding"]).to(device, dtype)
            mask = torch.from_numpy(batch["text_mask"]).to(device)
            if args.batch_multiplicity > 1:
                reps = args.batch_multiplicity
                latents = latents.repeat(reps, 1, 1, 1)
                ctx = ctx.repeat(reps, 1, 1)
                mask = mask.repeat(reps, 1)
            weight = rampup_weights(global_step, latents.shape[0],
                                    args.bs_rampup, seed)
            metrics = train_step(
                state, latents, ctx, mask,
                generator=step_generator(device, seed, global_step),
                uncond_prob=uncond_prob, patch_size=cfg.patch_size,
                token_keep_ratio=1.0 - args.sequence_dropout,
                sample_weight=None if weight is None
                else torch.from_numpy(weight).to(device))
            if ema is not None:
                ema_update(ema, trained, args.ema_decay)
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
            if args.checkpointing_steps and global_step % args.checkpointing_steps == 0:
                save(global_step, wait=not args.async_checkpoint)
                logger.info("saved checkpoint @ %d%s", global_step,
                            " (async)" if args.async_checkpoint else "")
            if preempt["sig"] is not None:
                logger.warning("stopping on signal %d at step %d; saving final "
                               "checkpoint", preempt["sig"], global_step)
                result["preempted_at"] = global_step
                stop = True
                break
            if global_step >= max_steps:
                stop = True
                break
        logger.info("epoch %d done in %.1fs", epoch, time.time() - epoch_start)
        if stop:
            break
        sampler.reset(0)  # a restored offset holds for its own epoch only

    for s, h in prev_handlers.items():
        signal.signal(s, h)

    final_dir = save(global_step)
    result["checkpoints"] = ckpt.timings
    if lora is not None:
        save_lora_weights(lora, final_dir)
        logger.info("saved LoRA weights to %s", final_dir)

    if args.export_pipeline:
        export = ema if ema is not None else trained
        with torch.no_grad():
            if lora is not None:
                detach_lora(model)
                apply_lora(model, unflatten(export), alpha=args.lora_alpha,
                           rank=args.lora_rank)
            elif ema is not None:
                for name, p in model.named_parameters():
                    p.copy_(ema[name])
        export_dir = Path(args.output_dir) / "pipeline"
        FLitePipeline(model, vae).save_pretrained(export_dir)
        logger.info("exported pipeline to %s", export_dir)
    result["global_step"] = global_step
    result["wall_s"] = time.time() - t_start
    logger.info("training completed after %d steps (%.1fs)", global_step,
                result["wall_s"])
    return result


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    return train(parse_args(argv))
