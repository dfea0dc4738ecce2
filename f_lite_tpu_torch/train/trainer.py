"""Training entry point: `python -m f_lite_tpu_torch.train` (counterpart of
`python -m f_lite_tpu.train`, with the same option names and defaults).

Ported:
- the DiT model options and `--pixel_space`;
- the online image path (the JAX trainer's default): `--train_data_path`
  with `--root_dir_type json|parquet`, `--base_url dummy://|file://|
  http(s)://|s3://`, `--base_image_dir`, `--image_column`,
  `--caption_column`, `--resolution`, `--center_crop`, `--random_flip`,
  `--use_resolution_buckets`, `--num_workers` and `--loader_worker_type`
  (`data/dataset.py`, `data/loader.py`); each batch's images are VAE
  encoded on the device (a posterior sample, fp32) and its captions by
  `--text_encoder_type` (`t5`, `qwen2`, `torch` with `--text_encoder_path`
  and `--processor_path`, else the hermetic `ZeroTextEncoder`), caption
  dropout `--uncond_prob`;
- the precomputed-data path (`--use_precomputed_data
  --precomputed_data_dir`, caption dropout 0.01, `--use_resolution_buckets`,
  `--random_flip` as a latent flip);
- batch size / epochs / max_steps, the optimizer and schedule options,
  `--use_8bit_adam`, `--max_grad_norm`, `--mixed_precision bf16` (fp32
  master weights, bf16 compute), `--gradient_checkpointing` with
  `--remat_policy full|dots`, `--seed`, `--output_dir`;
- the run state and recipe options: `--pretrained_model_path`,
  `--checkpointing_steps`, `--checkpoints_total_limit`,
  `--resume_from_checkpoint latest|DIR`, `--async_checkpoint`,
  `--graceful_term` (`train/checkpoint.py`; the port's own format);
  `--use_lora` with `--lora_rank`, `--lora_alpha`,
  `--lora_target_modules` and `--lora_checkpoint`; `--ema_decay`,
  `--ema_dtype`; `--bs_rampup`; `--gradient_accumulation_steps` and
  `--batch_multiplicity`; `--sequence_dropout`; `--export_pipeline`;
- what runs during training: `--log_every` with `--report_to
  tensorboard|wandb|all|none` (`MetricsLogger`: tensorboardX, wandb, each
  imported where it is used), `--val_data_path` with `--eval_every` and
  `--eval_batch_size`, `--sample_every` with `--sample_prompts_file`
  (`samples/step_N.png`, from the EMA where it is on), `--profile_steps
  a,b` (a torch.profiler trace under `{output_dir}/profile/`, the
  program's spans a track of it) and
  `--debug_nans` (the step under `torch.autograd.detect_anomaly()`, a
  FloatingPointError at the first loss or gradient norm that is not
  finite, before the update).
Each step's draws come from generators keyed by (seed, step), so a resumed
run repeats the straight run's. The log lines and the returned dict are the
JAX trainer's; on rank 0 every logged step is also a line of
`{output_dir}/{logging_dir}/metrics.jsonl` (the scalars at full precision,
the wall clock and, on the card, the kernels' launch counts and the peak
memory), and the returned dict its last line.

Across GPUs (`parallel/`): `torchrun --nproc_per_node N -m
f_lite_tpu_torch.train --dp D --fsdp F ...` (`--fsdp 0`: every rank `--dp`
leaves; dp x fsdp = WORLD_SIZE; `--multihost` across nodes, `torchrun
--nnodes M`). The DiT is under FSDP2 (`shard_dit`: HSDP where both are
above 1) and computes the run that the JAX trainer computes on a (dp,
fsdp) mesh: each node loads the batch a JAX host loads (the samplers
strided by node, both paths), each of its ranks keeps its contiguous rows,
each rank draws the step's values over the global batch and keeps its rows
(also `--bs_rampup`'s weights, normalized by their global sum), the logged
loss and deciles are the global batch's, and the gradient norm the whole
gradient's. Rank 0 logs and writes the files (the checkpoint from whole
tensors, gathered one at a time, so it resumes at any world size; samples;
the export; the LoRA factors); every rank joins each collective, and a
signal to any rank stops all of them at the same step. Under torchrun a
group is formed at every world size (NCCL on the card, gloo with `--device
cpu`); without it the run is one rank, unwrapped.

`--tp N` adds tensor parallelism (`parallel/tensor.py` `parallelize_dit`
on the mesh's tp sub-mesh, then FSDP2 over its data sub-mesh): dp x fsdp
x tp = WORLD_SIZE, the ranks of a tp group (consecutive, inside a node)
take the same rows, and `--sequence_parallel` (which needs `--tp` > 1, as
in JAX) splits the residual stream along L over them. A tp that does not
divide the heads or the MLP width raises ValueError, as the JAX trainer
does (neither pads). Under torchrun the plan is applied at every tp, 1
included.

`--pp P --pp_microbatches M` adds pipeline parallelism
(`parallel/pipeline.py`): dp x pp x fsdp x tp = WORLD_SIZE, each rank
holds one of P stages of the blocks (the uniform region's units split
evenly, v1's front blocks, the embedders and the context projection on
stage 0, the final layer on the last; a v1 model with no periodic region
runs whole on every stage), and every step (every `Accumulate`
micro-step) runs one GPipe schedule of M microbatches through the stages
(`torch.distributed.pipelining`), each stage's AdamW and EMA on its own
tensors, the gradient norm summed over the stages. The ranks of a
pipeline (inside one node) take the same rows and draws; eval and
sampling run forward through the stages, an off-recipe batch degrading
to fewer microbatches as in JAX. JAX's checks hold, with its messages:
`--pp` > 1 needs `--scan_layers` and refuses `--sequence_dropout`,
`--pp_microbatches` > 1 needs `--pp` > 1, the global batch must divide
by the microbatches, and `--use_lora` refuses `--scan_layers`.
`--scan_layers` also makes the export's DiT scan-stacked, as the JAX
trainer's (`scan_layers: true`, `pipeline_stages: 1`); the port trains
the blocks unrolled either way. `--train_only_lora` is accepted and unused,
as in the JAX trainer. The run is on the card (`--device cuda`) unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import random
import signal
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from f_lite_tpu_torch.parallel.mesh import (
    TORCHRUN_VARS,
    launch_info,
    process_replica_info,
    resolve_mesh,
    under_torchrun,
)
from f_lite_tpu_torch.parallel.sharding import load_full_state_dict, local
from f_lite_tpu_torch.utils import trace

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
                   help="online path: a per-item image h-flip (drawn per "
                        "epoch); precomputed path: a latent h-flip")
    p.add_argument("--use_resolution_buckets", action="store_true",
                   help="batches of one shape: the crop's aspect bucket "
                        "(online path) or the latent shape (precomputed "
                        "path)")
    p.add_argument("--num_workers", type=int, default=4,
                   help="the online path's loader workers")
    p.add_argument("--loader_worker_type", choices=("thread", "process"),
                   default="thread",
                   help="the online path's loader workers: threads "
                        "(network-backed default) or forkserver processes "
                        "(decode-bound local data)")
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
    p.add_argument("--debug_nans", action="store_true",
                   help="run each step under torch.autograd.detect_anomaly() "
                        "and raise FloatingPointError at the first loss or "
                        "gradient norm that is not finite")
    # Logging / eval
    p.add_argument("--logging_dir", type=str, default="logs")
    p.add_argument("--report_to", type=str, default="tensorboard",
                   choices=["tensorboard", "wandb", "all", "none"])
    p.add_argument("--project_name", type=str, default="dit-finetune")
    p.add_argument("--run_name", type=str, default=None)
    p.add_argument("--sample_every", type=int, default=500,
                   help="write samples/step_N.png every N steps (0: never)")
    p.add_argument("--eval_every", type=int, default=500,
                   help="validation loss every N steps with --val_data_path")
    p.add_argument("--sample_prompts_file", type=str, default=None)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--export_pipeline", action="store_true")
    p.add_argument("--profile_steps", type=str, default=None,
                   help="'start,stop': a torch.profiler trace of those steps "
                        "under {output_dir}/profile/")
    return p.parse_args(argv)


def pipeline_schedule(args) -> tuple[int, int] | None:
    """(stages, microbatches) of the GPipe schedule the run trains with
    (`--pp` > 1), or None: no pipeline."""
    return (args.pp, args.pp_microbatches) if args.pp > 1 else None


def global_batch(args) -> int:
    """The rows the model sees a step, as the JAX trainer counts them:
    train_batch_size x batch_multiplicity x the nodes (JAX's processes)."""
    return (args.train_batch_size * max(args.batch_multiplicity, 1)
            * process_replica_info()[0])


def check_mesh(args) -> None:
    """Raise SystemExit where the mesh options do not fit the processes
    `torchrun` started (or did not start), or the batch does not divide
    over a node's ranks."""
    world, _, local_world, _ = launch_info()
    pp = max(args.pp, 1)
    if not under_torchrun():
        if args.dp > 1 or args.fsdp > 1 or args.tp > 1 or pp > 1:
            raise SystemExit(
                f"--dp {args.dp} --fsdp {args.fsdp} --tp {args.tp}"
                + (f" --pp {pp}" if pp > 1 else "")
                + ": a mesh of more than one rank runs one process a GPU, under "
                "torchrun: torchrun --nproc_per_node N -m f_lite_tpu_torch.train ...")
        if args.multihost:
            raise SystemExit(
                "--multihost: the process group forms from torchrun's "
                f"variables ({', '.join(TORCHRUN_VARS)}), which are not set: "
                "run under torchrun --nnodes M --nproc_per_node N ...")
    else:
        try:
            _, fsdp = resolve_mesh(args.dp, args.fsdp, world, args.tp, pp)
        except ValueError as e:
            raise SystemExit(str(e)) from None
        if local_world % args.tp:
            raise SystemExit(f"--tp {args.tp} does not divide the {local_world} "
                             "ranks of a node: a tp group lies inside one node")
        if pp > 1 and local_world % (pp * fsdp * args.tp):
            raise SystemExit(
                f"--pp {pp} x fsdp {fsdp} x --tp {args.tp} does not divide the "
                f"{local_world} ranks of a node: a pipeline lies inside one node "
                "(its stages take the node's rows), so nodes split along dp")
        if args.multihost and world == local_world:
            raise SystemExit(f"--multihost: torchrun started one node "
                             f"({world} ranks); --multihost is for more than one")
    group = args.tp * pp  # the ranks that take the same rows
    replicas = max(local_world // group, 1)  # a node's data replicas
    over = (f"{local_world} ranks of a node (LOCAL_WORLD_SIZE)" if group == 1 else
            f"{replicas} data replicas of a node (LOCAL_WORLD_SIZE / "
            + ("tp)" if pp == 1 else "(pp x tp))"))
    for name in ("train_batch_size", "eval_batch_size"):
        b = getattr(args, name)
        if b % replicas and (name == "train_batch_size" or args.val_data_path):
            raise SystemExit(f"--{name} {b} does not divide evenly over the {over}")


def check_ported(args) -> None:
    """Raise SystemExit (ValueError for `--sequence_parallel` and
    `--ema_decay`) for a combination the JAX trainer rejects, with its
    message, or a mesh that does not fit the processes."""
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
    pp = max(args.pp, 1)
    if pp > 1 and not args.scan_layers:
        raise SystemExit("--pp > 1 requires --scan_layers")
    if pp > 1 and args.sequence_dropout > 0:
        raise SystemExit(
            "--pp > 1 is incompatible with --sequence_dropout "
            "(per-sample rope under token subsetting)")
    if pp == 1 and args.pp_microbatches > 1:
        raise SystemExit(
            "--pp_microbatches > 1 has no effect without --pp > 1 "
            "(microbatches only stream through a multi-stage pipeline)")
    if pp > 1 and global_batch(args) % max(args.pp_microbatches, 1):
        raise SystemExit(
            f"global batch {global_batch(args)} (= train_batch_size x "
            f"batch_multiplicity x process_count) must be divisible by "
            f"--pp_microbatches {args.pp_microbatches} (the model "
            "degrades off-recipe batches silently, which is meant for "
            "eval sampling, not the training step)")
    if args.sequence_parallel and args.tp <= 1:
        raise ValueError("--sequence_parallel requires --tp > 1")
    check_mesh(args)
    if args.use_precomputed_data and not args.precomputed_data_dir:
        raise SystemExit("--use_precomputed_data requires --precomputed_data_dir")
    if not args.use_precomputed_data and not args.train_data_path:
        raise SystemExit("the online image path needs --train_data_path (or "
                         "pass --use_precomputed_data --precomputed_data_dir)")
    if args.use_precomputed_data and args.val_data_path:
        # the JAX trainer builds an image loader for validation and its
        # first eval reads latents from it (KeyError 'vae_latent')
        raise SystemExit(
            "--val_data_path with --use_precomputed_data: validation reads "
            "an image table, which the precomputed path cannot encode; drop "
            "one of the two options")
    if args.profile_steps is not None:
        try:
            a, b = (int(x) for x in args.profile_steps.split(","))
        except ValueError:
            raise SystemExit(f"--profile_steps {args.profile_steps!r}: expected "
                             "'start,stop'") from None
        if not 0 <= a < b:
            raise SystemExit(f"--profile_steps {args.profile_steps!r}: need "
                             "0 <= start < stop")
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
    initializers; not `jax.random`'s draws). fp32. The online path encodes
    the images through it, sampling decodes through it and the export
    writes it."""
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
    from f_lite_tpu_torch.parallel.pipeline import DiTStage
    from f_lite_tpu_torch.pipeline import FLitePipeline

    # a pipeline stage takes its own tensors of the DiT, read on the host
    staged = isinstance(model, DiTStage)
    pipe = FLitePipeline.from_pretrained(
        args.pretrained_model_path, dtype=torch.float32,
        device="cpu" if staged else device, load_text_encoder=False)
    state = pipe.dit.state_dict()
    if staged:
        state = {k: state[k] for k in model.state_dict()}
    try:
        model.load_state_dict(state, strict=True)
    except RuntimeError as e:
        raise ValueError(
            f"--pretrained_model_path {args.pretrained_model_path}: its DiT "
            f"does not fit the model the arguments build: {e}") from None
    if args.pixel_space or args.vae_path or not isinstance(pipe.vae, AutoencoderKL):
        return None
    return pipe.vae.to(device)


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


# the salt of the VAE posterior's draws: a second stream beside
# `step_generator`'s, as JAX splits fold_in(key(seed), step) into k_enc and
# k_step, so the loss draws what it draws on the precomputed path
_ENCODE_SALT = 1 << 40


def encode_generator(device, seed: int, step: int) -> torch.Generator:
    """The VAE posterior's draws of step `step`, keyed by (seed, step)."""
    return torch.Generator(device).manual_seed(seed * 1000003 + step + _ENCODE_SALT)


def build_text_encoder(args, device):
    """The captions' encoder, as the JAX trainer's `build_text_encoder`
    chooses it: the precomputed cache's, a T5 / Qwen2 / `transformers`
    model from `--text_encoder_path` (chat-wrapped as in training for the
    last two), else the hermetic `ZeroTextEncoder` (32 tokens)."""
    from f_lite_tpu_torch.text.encoder import (
        PrecomputedTextEncoder,
        T5TextEncoder,
        TorchTextEncoder,
        ZeroTextEncoder,
    )
    from f_lite_tpu_torch.text.templates import training_chat_messages

    kind, path = args.text_encoder_type, args.text_encoder_path
    if args.use_precomputed_data or kind == "precomputed":
        return PrecomputedTextEncoder(args.precomputed_data_dir)
    if kind == "t5" and path:
        return T5TextEncoder(path, tokenizer_path=args.processor_path, device=device)
    if kind == "qwen2" and path:
        from f_lite_tpu_torch.text.qwen2 import Qwen2TextEncoder

        return Qwen2TextEncoder(path, processor_path=args.processor_path,
                                message_fn=training_chat_messages, device=device)
    if kind == "torch" and path:
        return TorchTextEncoder(path, processor_path=args.processor_path,
                                message_fn=training_chat_messages, device=device)
    return ZeroTextEncoder(embed_dim=args.cross_attn_input_size, seq_len=32)


def build_dataloader(args, batch_size, train=True, sampler_state=None):
    """(loader, sampler) of the online path over `--train_data_path` (or,
    with train=False, `--val_data_path`: no shuffle, no flip), batched in
    aspect buckets with `--use_resolution_buckets`; `sampler_state` resumes
    inside the saved epoch. The sampler strides by node
    (`process_replica_info`)."""
    from f_lite_tpu_torch.data.dataset import ImageDataset
    from f_lite_tpu_torch.data.loader import DataLoader
    from f_lite_tpu_torch.data.samplers import (
        ResolutionBucketSampler,
        StatefulDistributedSampler,
    )

    seed = args.seed or 0
    num_replicas, rank = process_replica_info()
    ds = ImageDataset(
        args.train_data_path if train else args.val_data_path,
        base_image_dir=args.base_image_dir, image_column=args.image_column,
        caption_column=args.caption_column, resolution=args.resolution,
        center_crop=args.center_crop, random_flip=args.random_flip and train,
        root_dir_type=args.root_dir_type, base_url=args.base_url,
        debug=args.debug, seed=seed)
    if args.use_resolution_buckets:
        sampler = ResolutionBucketSampler(ds, batch_size, num_replicas=num_replicas,
                                          rank=rank, shuffle=train, seed=seed)
        loader = DataLoader(ds, batch_sampler=sampler, num_workers=args.num_workers,
                            worker_type=args.loader_worker_type)
    else:
        sampler = StatefulDistributedSampler(ds, batch_size, num_replicas=num_replicas,
                                             rank=rank, shuffle=train, seed=seed)
        loader = DataLoader(ds, batch_size=batch_size, sampler=sampler,
                            num_workers=args.num_workers, drop_last=True,
                            worker_type=args.loader_worker_type)
    if sampler_state:
        sampler.load_state_dict(sampler_state)
    return loader, sampler


def encode_batch(batch, vae, text_encoder, *, generator, dtype, device,
                 batch_multiplicity: int = 1, rows=None):
    """A loader's batch -> (latents (B, h, w, C), context (B, S, Ctx), mask
    (B, S)) on `device`, latents and context in `dtype`. A precomputed
    batch carries its latents and embeddings; an image batch is VAE
    encoded here (a posterior sample, fp32, no autograd: the noise drawn
    from `generator` over the whole batch, as one rank draws it) and
    normalized, and its captions encoded by `text_encoder` (the whole
    batch's). The result holds the batch's rows `rows` (a rank's rows,
    `parallel.sharding.rank_rows`), by default every row repeated
    `batch_multiplicity` times; each distinct row is encoded once."""
    from f_lite_tpu_torch.models.vae import AutoencoderKL, normalize_latents

    b = len(batch["caption"])
    if rows is None:
        rows = np.tile(np.arange(b), batch_multiplicity)
    uniq, inverse = np.unique(rows, return_inverse=True)
    take = torch.from_numpy(inverse).to(device)
    if "vae_latent" in batch:
        latents = torch.from_numpy(batch["vae_latent"][uniq]).to(device, torch.float32)
        ctx, mask = batch["text_embedding"], batch["text_mask"]
    else:
        images = batch["image"]
        x = torch.from_numpy(images[uniq]).to(device, torch.float32)
        noise = None
        if isinstance(vae, AutoencoderKL):
            sf, c = vae.config.spatial_scale, vae.config.latent_channels
            noise = torch.randn((b, images.shape[1] // sf, images.shape[2] // sf, c),
                                generator=generator, device=device)
            noise = noise[torch.from_numpy(uniq).to(device)]
        with torch.no_grad():
            latents = normalize_latents(vae.encode(x, generator=generator, noise=noise),
                                        vae.config)
        ctx, mask = text_encoder.encode(batch["caption"])
    ctx = torch.from_numpy(np.asarray(ctx)[uniq]).to(device, dtype)
    mask = torch.from_numpy(np.asarray(mask)[uniq]).to(device)
    return latents.to(dtype)[take], ctx[take], mask[take]


class MetricsLogger:
    """Scalars, the timestep-bin histogram and the sample grid to
    tensorboard (tensorboardX) and / or wandb, as `--report_to` says;
    each package is imported here, where it is used; `record` writes a
    line of `{output_dir}/{logging_dir}/metrics.jsonl`. With
    `enabled=False` (every rank but 0) it does nothing."""

    def __init__(self, args, enabled: bool = True):
        self.tb = None
        self.wandb = None
        self.jsonl = None
        self.enabled = enabled
        if not enabled:
            return
        log_dir = self.log_dir = Path(args.output_dir) / args.logging_dir
        if args.report_to in ("tensorboard", "all"):
            try:
                from tensorboardX import SummaryWriter

                self.tb = SummaryWriter(str(log_dir))
            except ImportError:
                self.tb = None
        if args.report_to in ("wandb", "all"):
            try:
                import wandb

                wandb.init(project=args.project_name, name=args.run_name,
                           config=vars(args))
                self.wandb = wandb
            except ImportError:
                logger.warning("wandb not installed; skipping wandb logging")
        if args.report_to != "none" and self.tb is None and self.wandb is None:
            # never silence: a long run with no metrics backend is almost
            # certainly a misconfiguration
            logger.error(
                "NO metrics backend is active (--report_to %s, tensorboardX"
                " %savailable, wandb %savailable) — training metrics will "
                "only appear in stdout logs and metrics.jsonl. Install "
                "tensorboardX/wandb or pass --report_to none to silence this.",
                args.report_to,
                "" if self.tb is not None else "un",
                "" if self.wandb is not None else "un",
            )

    def log(self, scalars: dict, step: int):
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, float(v), step)
        if self.wandb is not None:
            self.wandb.log(scalars, step=step)

    def record(self, values: dict):
        """One line of metrics.jsonl (numbers at full precision; the file
        is opened, for appending, at the first line)."""
        if not self.enabled:
            return
        if self.jsonl is None:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            self.jsonl = open(self.log_dir / "metrics.jsonl", "a")
        self.jsonl.write(json.dumps(values, default=float) + "\n")
        self.jsonl.flush()

    def log_histogram(self, tag, bin_counts, step):
        """The timestep bins' occupancy: [bin] * count raw samples, as the
        reference builds its wandb.Histogram."""
        counts = [int(c) for c in bin_counts]
        if not any(counts):
            return
        raw = [i for i, c in enumerate(counts) for _ in range(c)]
        if self.tb is not None:
            self.tb.add_histogram(tag, np.asarray(raw), step, bins=10)
        if self.wandb is not None:
            self.wandb.log({tag: self.wandb.Histogram(raw)}, step=step)

    def log_image(self, tag, image: np.ndarray, step):
        """`image`: uint8 (H, W, 3)."""
        if self.tb is not None:
            self.tb.add_image(tag, np.asarray(image).transpose(2, 0, 1), step)
        if self.wandb is not None:
            self.wandb.log({tag: self.wandb.Image(image)}, step=step)

    def close(self):
        if self.tb is not None:
            self.tb.close()
        if self.jsonl is not None:
            self.jsonl.close()
            self.jsonl = None


DEFAULT_SAMPLE_PROMPTS = [
    "a beautiful photograph of a mountain landscape at sunset",
    "a cute cat playing with a ball of yarn",
    "a futuristic cityscape with flying cars",
    "an oil painting of a flower garden",
]


def sample_prompts(prompts_file=None, prompts=None) -> list[str]:
    """The non-empty lines of `prompts_file` (when it exists and has any),
    else `prompts`, else `DEFAULT_SAMPLE_PROMPTS`."""
    if prompts_file and Path(prompts_file).exists():
        lines = [line.strip() for line in Path(prompts_file).read_text().splitlines()
                 if line.strip()]
        prompts = lines or prompts
    return list(prompts or DEFAULT_SAMPLE_PROMPTS)


@torch.no_grad()
def sample_decoded(model, vae, text_encoder, global_step, *, image_size=256,
                   num_inference_steps=50, cfg_scale=6.0, prompts=None,
                   prompts_file=None, latents=None) -> np.ndarray:
    """The sample grid's images, float32 (N, H, W, 3) in [-1, 1]: the
    prompts denoised from latents drawn from `torch.Generator(device)
    .manual_seed(global_step)` (or `latents`) at `cfg_scale`, with zeros
    as the negative context, then decoded by `vae`."""
    from f_lite_tpu_torch.models.vae import denormalize_latents
    from f_lite_tpu_torch.sampling.euler import DenoiseSettings, denoise

    prompts = sample_prompts(prompts_file, prompts)
    embeds, mask = text_encoder.encode(prompts)
    param = next(model.parameters())
    device, dtype = param.device, model.config.dtype or param.dtype
    if latents is None:
        lh = lw = image_size // vae.config.spatial_scale
        latents = torch.randn(
            (len(prompts), lh, lw, model.config.in_channels), dtype=dtype,
            device=device,
            generator=torch.Generator(device).manual_seed(global_step))
    pos = torch.from_numpy(np.asarray(embeds)).to(device, dtype)
    settings = DenoiseSettings(num_inference_steps=num_inference_steps,
                               guidance_scale=cfg_scale)
    final = denoise(model, latents.to(device, dtype), pos, torch.zeros_like(pos),
                    torch.from_numpy(np.asarray(mask)).to(device), settings)
    z = denormalize_latents(final.float(), vae.config)
    return vae.decode(z).float().cpu().numpy()


def sample_images(model, vae, text_encoder, global_step, *, image_size=256,
                  num_inference_steps=50, cfg_scale=6.0, prompts=None,
                  prompts_file=None, output_dir=None, latents=None) -> np.ndarray:
    """The eval-time sample grid (uint8 (H, W, 3), 3 images a row) of
    `sample_decoded`, written to `{output_dir}/samples/step_{N}.png`."""
    from f_lite_tpu_torch.data.image_ops import denormalize_to_u8
    from f_lite_tpu_torch.utils.image import make_image_grid, png_bytes_with_metadata

    images = sample_decoded(model, vae, text_encoder, global_step,
                            image_size=image_size,
                            num_inference_steps=num_inference_steps,
                            cfg_scale=cfg_scale, prompts=prompts,
                            prompts_file=prompts_file, latents=latents)
    grid = make_image_grid(denormalize_to_u8(images), nrow=3)
    if output_dir is not None:
        out = Path(output_dir) / "samples"
        out.mkdir(parents=True, exist_ok=True)
        (out / f"step_{global_step}.png").write_bytes(png_bytes_with_metadata(grid))
    return grid


class swapped_weights:
    """Within the block, each trained tensor holds `values[name]` (cast to
    its dtype); its own storage is put back on exit, so the tensors, their
    autograd state and the optimizer are as they were. None: no swap.
    A DTensor shard (FSDP2 all-gathers from the shard's own storage) gets
    the values copied in, and its own copied back."""

    def __init__(self, trained: dict, values: dict | None):
        self.trained, self.values, self.saved = trained, values, {}

    @torch.no_grad()
    def __enter__(self):
        if self.values is not None:
            for name, t in self.trained.items():
                if t is not local(t):
                    self.saved[name] = local(t).clone()
                    local(t).copy_(local(self.values[name]))
                else:
                    self.saved[name] = t.data
                    t.data = self.values[name].to(t.dtype)

    @torch.no_grad()
    def __exit__(self, *exc):
        for name, data in self.saved.items():
            t = self.trained[name]
            if t is not local(t):
                local(t).copy_(data)
            else:
                t.data = data
        self.saved = {}


@torch.no_grad()
def evaluate(model, val_dl, vae, text_encoder, *, global_step: int, seed: int,
             dtype, device, batch_multiplicity: int = 1, uncond_prob: float,
             patch_size: int, token_keep_ratio: float = 1.0, ranks=(1, 0, 1),
             group=None, tp: int = 1, pp: int = 1, fsdp: int = 1) -> float | None:
    """The mean loss over at most 20 validation batches, without
    gradients; batch vi's draws come from the generators of step
    (1 << 30) + global_step * 32 + vi, so no draw of the training run
    moves. None without a batch. Across `ranks` (world, rank,
    local_world) each rank takes its rows of each batch and its rows of
    the global batch's draws (the ranks of a tp group of `tp` and of a
    pipeline of `pp` the same rows; `fsdp` places the replicas on the
    mesh), every rank runs the least batch count of all ranks, and the
    losses and their count are summed over `group` (a host-side group of
    every rank; pp and tp peers add equal losses and counts, so the mean
    is the replicas'). A pipelined model (`PipelinedDiT`) runs forward
    only through its stages."""
    from f_lite_tpu_torch.parallel.mesh import host_all_reduce
    from f_lite_tpu_torch.parallel.sharding import rank_rows
    from f_lite_tpu_torch.train.loss import draw_loss_inputs, flow_matching_loss

    world, rank, local_world = ranks
    # every rank runs as many wrapped forwards: the least batch count of
    # the nodes' strides, and at most the reference's 20
    n = min(len(val_dl), 20)
    if world > 1:
        n = int(host_all_reduce([n], dist.ReduceOp.MIN, group)[0])
    losses = []
    for vi, vbatch in zip(range(n), val_dl):
        key = (1 << 30) + global_step * 32 + vi
        rows, lo, n_global = rank_rows(len(vbatch["caption"]), world=world, rank=rank,
                                       local_world=local_world,
                                       multiplicity=batch_multiplicity, tp=tp, pp=pp,
                                       fsdp=fsdp)
        latents, ctx, mask = encode_batch(
            vbatch, vae, text_encoder, generator=encode_generator(device, seed, key),
            dtype=dtype, device=device, rows=rows)
        draws = draw_loss_inputs(
            step_generator(device, seed, key), (n_global, *latents.shape[1:]), device,
            uncond_prob=uncond_prob, patch_size=patch_size,
            token_keep_ratio=token_keep_ratio).rows(lo, lo + len(rows))
        loss, _ = flow_matching_loss(model, latents, ctx, mask, draws=draws,
                                     patch_size=patch_size)
        losses.append(float(loss))
    total, count = sum(losses), len(losses)
    if world > 1:
        total, count = host_all_reduce([total, count], group=group)
    return total / count if count else None


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


def restore_state(trained: dict, opt, tensors, meta: dict, names=None) -> None:
    """Copy a checkpoint's tensors (a mapping of whole tensors, read one
    at a time) back into the trained tensors and the optimizer (which must
    have been built with the same options); a sharded tensor keeps its
    shard. `names`: every name the run's checkpoint holds, where this
    rank's tensors are a part of them (a pipeline stage's)."""
    expected = set(names if names is not None else state_tensors(trained, opt))
    if set(tensors) != expected:
        raise ValueError(
            "checkpoint does not match this run's trained tensors and "
            f"optimizer: {sorted(set(tensors) ^ expected)[:5]}")
    load_full_state_dict(trained, tensors)
    state = {"count": meta["count"], "mini_step": meta["mini_step"],
             "names": list(trained)}
    for key in ("mu", "nu", "acc"):
        if f"opt.{key}/{next(iter(trained))}" in tensors:
            state[key] = map(tensors.__getitem__, [f"opt.{key}/{n}" for n in trained])
    opt.load_state_dict(state)


@torch.no_grad()
def ema_update(ema: dict, trained: dict, decay: float) -> None:
    """e <- (e * d + p * (1 - d)) in fp32, cast back to e's dtype (on the
    local shards, under FSDP2)."""
    for name, e in ema.items():
        p, e = local(trained[name].detach()), local(e)
        e.copy_((e.float() * decay + p.float() * (1.0 - decay)).to(e.dtype))


def _start_profile(device, cleanup: contextlib.ExitStack):
    """A running torch.profiler session (CPU, and CUDA on the card) and a
    span recording beside it, both closed by `cleanup` where the run ends
    by an error before `_stop_profile`: (profiler, Recording, their
    ExitStack)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    session = contextlib.ExitStack()
    prof = session.enter_context(profile(activities=activities))
    rec = session.enter_context(trace.recording())
    cleanup.push(session)
    return prof, rec, session


def _stop_profile(session, device, out_dir: Path, steps, rank=None) -> Path:
    """End the profile once the device is idle and write its Chrome trace,
    with the program's spans as a track of their own, to
    `out_dir/steps_{a}_{b}.json` (`steps_{a}_{b}_rank{r}.json` across
    ranks)."""
    prof, rec, stack = session
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stack.close()
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = "" if rank is None else f"_rank{rank}"
    path = out_dir / f"steps_{steps[0]}_{steps[1]}{suffix}.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    doc["traceEvents"] += trace.chrome_events(rec, doc.get("baseTimeNanoseconds", 0))
    path.write_text(json.dumps(doc))
    logger.info("profile of steps %d-%d written to %s", steps[0] + 1, steps[1], path)
    return path


def device_stats(device) -> dict:
    """What metrics.jsonl records of the card at a logged step: the port's
    kernel launches so far and the peak allocated memory (nothing on the
    CPU)."""
    if device.type != "cuda":
        return {}
    launches = {key: trace.counter(name).count for key, name in
                (("fwd", "flash_fwd"), ("dq", "flash_bwd_dq"), ("dkv", "flash_bwd_dkv"),
                 ("rms_norm", "rms_norm"), ("rms_norm_bwd", "rms_norm_bwd"))}
    return {"launches": launches,
            "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9}


def export_dit(model, cfg, *, ema, lora, lora_alpha, lora_rank, rank: int,
               stages=None):
    """The DiT to export, whole and on the CPU, on rank 0 (None on the
    others; every rank gathers; a pipeline stage's ranks through `stages`):
    the trained weights, the EMA where it is on, the LoRA factors (or their
    EMA) merged into the frozen base."""
    from f_lite_tpu_torch.convert.from_jax import unflatten
    from f_lite_tpu_torch.models.dit import DiT
    from f_lite_tpu_torch.parallel.sharding import full_state_dict
    from f_lite_tpu_torch.train.lora import apply_lora, flatten_lora

    state = full_state_dict(model, stages)
    source = ema if ema is not None else (flatten_lora(lora) if lora is not None else {})
    override = full_state_dict(source, stages) if source else {}
    if rank != 0:
        return None
    if lora is not None:  # the frozen base, its parametrizations' originals
        state = {k.replace(".parametrizations.weight.original", ".weight"): v
                 for k, v in state.items() if "parametrizations.weight.0." not in k}
    else:
        state.update({k: v.to(state[k].dtype) for k, v in override.items()})
    with torch.device("meta"):
        dit = DiT(cfg)
    dit.load_state_dict(state, strict=True, assign=True)
    if lora is not None:
        apply_lora(dit, unflatten(override), alpha=lora_alpha, rank=lora_rank)
    return dit


def train(args, on_step=None) -> dict:
    """Train as `args` say; `on_step(state, metrics)`, when given, is called
    after every step with the `TrainState` and the step's metrics (device
    tensors). Under torchrun the process group is formed here and
    destroyed on the way out, on success and on error alike."""
    from f_lite_tpu_torch.parallel.mesh import init_distributed
    from f_lite_tpu_torch.utils.device import resolve_device
    from f_lite_tpu_torch.utils.env import load_dotenv

    t_start = time.time()
    load_dotenv()  # S3KEY / S3SECRET and the like, from ./.env
    check_ported(args)
    device = resolve_device(args.device)
    owned = under_torchrun() and not dist.is_initialized()
    ranks = init_distributed(device)
    try:
        if under_torchrun() and device.type == "cuda":
            device = torch.device("cuda", ranks[3])
        with contextlib.ExitStack() as cleanup:
            return _train(args, on_step, device, ranks, t_start, cleanup)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, on_step, device, ranks, t_start, cleanup) -> dict:
    from f_lite_tpu_torch.data.precomputed import create_precomputed_data_loader
    from f_lite_tpu_torch.models.dit import DiT
    from f_lite_tpu_torch.models.vae import IdentityVAE
    from f_lite_tpu_torch.parallel.mesh import (
        create_mesh,
        data_group,
        host_all_reduce,
        host_group,
        stage_of,
    )
    from f_lite_tpu_torch.parallel.pipeline import (
        PipelinedDiT,
        StageGroup,
        build_stage,
        pipeline_region,
        stage_blocks,
    )
    from f_lite_tpu_torch.parallel.sharding import (
        full_state_dict,
        rank_rows,
        shard_dit,
    )
    from f_lite_tpu_torch.parallel.tensor import parallelize_dit
    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.train.checkpoint import Checkpointer
    from f_lite_tpu_torch.train.lora import (
        attach_lora,
        attached_factors,
        flatten_lora,
        init_lora_params,
        load_lora_weights,
        save_lora_weights,
    )
    from f_lite_tpu_torch.train.loss import draw_loss_inputs
    from f_lite_tpu_torch.train.optim import build_lr_schedule, build_optimizer
    from f_lite_tpu_torch.train.step import TrainState, train_step

    world, rank, local_world, local_rank = ranks
    nodes, node_rank = process_replica_info()
    grouped = dist.is_initialized()
    tp, pp = args.tp, max(args.pp, 1)
    dp, fsdp = resolve_mesh(args.dp, args.fsdp, world, tp, pp)
    host = host_group() if grouped else None
    seed = args.seed or 0
    if args.seed is not None:
        # the global draws: the latent flip, collate's donors, the
        # placeholders' refresh (the same on every rank)
        random.seed(args.seed)
    dtype = torch.bfloat16 if args.mixed_precision == "bf16" else torch.float32
    k_acc = args.gradient_accumulation_steps

    cfg = build_config(args)
    if args.scan_layers:  # the export's layout must hold the config
        pipeline_region(cfg)
    mesh = create_mesh(dp, fsdp, tp, pp, device_type=device.type) if grouped else None
    schedule = pipeline_schedule(args)
    stages = stage = blocks = None
    if schedule is not None:
        stage, n_stages = stage_of(mesh)
        layout = stage_blocks(cfg, schedule[0], scan_layers=args.scan_layers)
        if layout is None:  # v1 without a periodic region: nothing to split
            logger.info("pipeline: no periodic block region at depth %d, every "
                        "stage holds and runs the whole model", cfg.depth)
            schedule = None
        else:
            blocks = layout[stage]
    if blocks is not None:  # fp32 master weights; compute in cfg.dtype
        model = build_stage(cfg, stage, n_stages, blocks, device)
    else:
        with torch.device(device):
            model = DiT(cfg)
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
        attach_lora(model, tree, alpha=args.lora_alpha, rank=args.lora_rank)
    data = None  # the group the loss sums over: the default one at pp x tp 1
    if grouped:
        data = data_group(mesh)
        # tensor parallelism over the tp sub-mesh (at tp 1 too), then
        # FSDP2 over the data sub-mesh
        parallelize_dit(model, mesh["tp"], sequence_parallel=args.sequence_parallel)
        shard_dit(model, mesh)
    net = model  # what the step, eval and sampling call
    if schedule is not None:
        pp_group = mesh["pp"].get_group()
        net = PipelinedDiT(model, pp_group, schedule[1], device)
        leader = all(mesh[d].get_local_rank() == 0 for d in ("dp", "fsdp", "tp"))
        stages = StageGroup(pp_group, stage, leader)
    # after fully_shard: its Parameters replace the module's
    if args.use_lora:
        lora = attached_factors(model)
        trained = flatten_lora(lora)
    else:
        trained = dict(model.named_parameters())

    # the online path encodes (and sampling decodes) through the identity
    # in pixel space
    coder = vae if vae is not None else IdentityVAE()
    text_encoder = build_text_encoder(args, device)

    def loader(sampler_state=None):
        if args.use_precomputed_data:
            return create_precomputed_data_loader(
                args.precomputed_data_dir, args.train_batch_size, seed=seed,
                use_buckets=args.use_resolution_buckets,
                latent_flip=args.random_flip, sampler_state=sampler_state,
                num_replicas=nodes, rank=node_rank)
        return build_dataloader(args, args.train_batch_size, train=True,
                                sampler_state=sampler_state)

    dl, sampler = loader()
    # a whole epoch's batches, the same on every rank: the least that any
    # node's stride holds (the strides may differ by a batch)
    epoch_batches = len(dl)
    if grouped:
        epoch_batches = int(host_all_reduce([epoch_batches], dist.ReduceOp.MIN, host)[0])
    val_dl = None
    if args.val_data_path:
        val_dl, _ = build_dataloader(args, args.eval_batch_size, train=False)
    # the JAX trainer's count: global_step counts micro-batches, the
    # default max_steps is the epochs' batches / k
    max_steps = args.max_steps or epoch_batches * args.num_epochs // k_acc
    opt = build_optimizer(
        list(trained.values()), learning_rate=args.learning_rate,
        lr_scheduler=args.lr_scheduler, num_warmup_steps=args.num_warmup_steps,
        max_steps=max_steps, weight_decay=args.weight_decay,
        max_grad_norm=args.max_grad_norm,
        moment_dtype=torch.bfloat16 if args.use_8bit_adam else None,
        accumulation_steps=k_acc,
        norm_group=stages.group if stages is not None else None)
    lr_fn = build_lr_schedule(args.lr_scheduler, args.learning_rate,
                              num_warmup_steps=args.num_warmup_steps,
                              max_steps=max_steps)
    state = TrainState(net, opt)
    # caption dropout: 0.01 on the precomputed path, as in the JAX trainer
    uncond_prob = 0.01 if args.use_precomputed_data else args.uncond_prob

    ckpt = Checkpointer(args.output_dir, total_limit=args.checkpoints_total_limit,
                        rank=rank, group=host, stages=stages)
    global_step = 0
    if args.resume_from_checkpoint:
        step_no = [ckpt.resolve(args.resume_from_checkpoint)]
        if grouped:  # rank 0's `latest`
            dist.broadcast_object_list(step_no, src=0, group=host)
        step_no = step_no[0]
        if step_no is not None:
            meta, tensors = ckpt.load(step_no)
            names = (None if stages is None
                     else stages.view(state_tensors(trained, opt)))
            restore_state(trained, opt, tensors, meta, names)
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
            load_full_state_dict(ema, restored)

    if args.sample_every and hasattr(text_encoder, "has"):
        # a precomputed cache holds its captions' embeddings only: the JAX
        # trainer raises KeyError at the first sample; this raises it
        # before the first step
        first = (global_step // args.sample_every + 1) * args.sample_every
        missing = [q for q in sample_prompts(args.sample_prompts_file)
                   if not text_encoder.has(q)]
        if first <= max_steps and missing:
            raise KeyError(
                f"no precomputed embedding for sample prompt {missing[0]!r} "
                f"(--sample_every {args.sample_every} samples at step {first}); "
                "pass --sample_prompts_file with cached captions or "
                "--sample_every 0")

    logger.info("device=%s params=%d trained=%d dtype=%s", device, n_params,
                sum(t.numel() for t in trained.values()), dtype)
    logger.info("mesh: dp=%d fsdp=%d world=%d nodes=%d", dp, fsdp, world, nodes)
    if grouped:
        logger.info("tensor parallel: tp=%d sequence_parallel=%s", tp,
                    args.sequence_parallel)
    if blocks is not None:
        logger.info("pipeline: pp=%d microbatches=%d, stage %d holds blocks %d-%d",
                    n_stages, schedule[1], stage, blocks.start, blocks.stop - 1)
    logger.info("dataset=%d images, %d batches/epoch, max_steps=%d",
                len(dl.dataset), epoch_batches, max_steps)
    # the batches each replica has run in the sampler's epoch (those the
    # resumed epoch ran before, to begin with)
    epoch_step = sampler.batches_skipped()

    def sampler_state():
        """The sampler's JSON at the batches this replica ran in the epoch
        (JAX's `global_step` arithmetic lands elsewhere after epoch 0
        under several replicas or an uneven last batch, R4); a finished
        epoch resumes at the start of the next."""
        if epoch_step < epoch_batches:
            return sampler.state_dict(epoch_step)
        return {**sampler.state_dict(0), "epoch": int(sampler.epoch) + 1}

    def save(step, wait=True):
        meta = {"step": step, "epoch": int(sampler.epoch), "count": opt.count,
                "mini_step": getattr(opt, "mini_step", 0)}
        return ckpt.save(step, state_tensors(trained, opt), meta, sampler_state(),
                         wait=wait, extra={"ema": ema} if ema is not None else None)

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

    metrics_logger = MetricsLogger(args, enabled=rank == 0)
    profile_range = (tuple(int(x) for x in args.profile_steps.split(","))
                     if args.profile_steps else None)
    prof = None
    bin_sums = torch.zeros(10, device=device)
    bin_counts = torch.zeros(10, device=device)
    loader_wait = trace.counter("train.loader_wait")
    waited = loader_wait.count
    result: dict = {}
    stop = False
    # resume continues inside the saved epoch (the sampler's state)
    first_epoch = int(sampler.epoch)
    for epoch in range(first_epoch, args.num_epochs):
        if epoch > first_epoch:  # a restored offset holds for its own epoch only
            sampler.reset(0)
            epoch_step = 0
        sampler.set_epoch(epoch)
        if hasattr(dl.dataset, "set_epoch"):  # fresh flips and caption picks
            dl.dataset.set_epoch(epoch)
        epoch_start = time.time()
        for batch in trace.waits(dl, "train.loader_wait"):
            if epoch_step >= epoch_batches:  # every rank takes as many steps
                break
            if profile_range and global_step == profile_range[0]:
                prof = _start_profile(device, cleanup)
            rows, lo, n_global = rank_rows(
                len(batch["caption"]), world=world, rank=rank,
                local_world=local_world, multiplicity=args.batch_multiplicity, tp=tp,
                pp=pp, fsdp=fsdp)
            latents, ctx, mask = encode_batch(
                batch, coder, text_encoder,
                generator=encode_generator(device, seed, global_step),
                dtype=dtype, device=device, rows=rows)
            # the step's draws and weights over the global batch; this
            # rank's rows of them
            draws = draw_loss_inputs(
                step_generator(device, seed, global_step),
                (n_global, *latents.shape[1:]), device, uncond_prob=uncond_prob,
                patch_size=cfg.patch_size,
                token_keep_ratio=1.0 - args.sequence_dropout).rows(lo, lo + len(rows))
            weight = rampup_weights(global_step, n_global, args.bs_rampup, seed)
            metrics = train_step(
                state, latents, ctx, mask, draws=draws, patch_size=cfg.patch_size,
                sample_weight=None if weight is None
                else torch.from_numpy(weight[lo:lo + len(rows)]).to(device),
                weight_sum=torch.tensor(
                    float(n_global if weight is None else weight.sum()), device=device),
                world=world // (tp * pp), group=data, debug_nans=args.debug_nans)
            if ema is not None:
                ema_update(ema, trained, args.ema_decay)
            global_step += 1
            epoch_step += 1
            if prof is not None and global_step == profile_range[1]:
                _stop_profile(prof, device, Path(args.output_dir) / "profile",
                              profile_range, rank if world > 1 else None)
                prof = None
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
                metrics_logger.log(logs, global_step)
                metrics_logger.record({**logs, "step": global_step, "time": time.time(),
                                       **device_stats(device)})
                metrics_logger.log_histogram("metrics/diffusion_loss_bin_counts",
                                             bc, global_step)
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
            if args.sample_every and global_step % args.sample_every == 0:
                # from the EMA where it is on (the merged factors under
                # LoRA), the trained tensors swapped back after; every rank
                # runs the wrapped forward, rank 0 writes
                with swapped_weights(trained, ema):
                    grid = sample_images(
                        net, coder, text_encoder, global_step,
                        image_size=args.resolution,
                        num_inference_steps=8 if args.debug else 50,
                        prompts_file=args.sample_prompts_file,
                        output_dir=args.output_dir if rank == 0 else None)
                metrics_logger.log_image("samples", grid, global_step)
            if val_dl is not None and args.eval_every \
                    and global_step % args.eval_every == 0:
                v = evaluate(net, val_dl, coder, text_encoder,
                             global_step=global_step, seed=seed, dtype=dtype,
                             device=device,
                             batch_multiplicity=args.batch_multiplicity,
                             uncond_prob=uncond_prob, patch_size=cfg.patch_size,
                             token_keep_ratio=1.0 - args.sequence_dropout,
                             ranks=(world, rank, local_world), group=host, tp=tp,
                             pp=pp, fsdp=fsdp)
                if v is not None:
                    metrics_logger.log({"val/loss": v, "val/diffusion_loss": v},
                                       global_step)
                    metrics_logger.record({"val/loss": v, "step": global_step})
                    logger.info("validation loss: %.4f", v)
                    result["val/loss"] = v
            # a signal to any rank stops every rank here (agreed on the
            # host, once a step)
            signalled = preempt["sig"] is not None
            if grouped:
                signalled = host_all_reduce([signalled], dist.ReduceOp.MAX, host)[0] > 0
            if signalled:
                logger.warning("stopping on signal %s at step %d; saving final "
                               "checkpoint", preempt["sig"] or "(another rank's)",
                               global_step)
                result["preempted_at"] = global_step
                stop = True
                break
            if global_step >= max_steps:
                stop = True
                break
        logger.info("epoch %d done in %.1fs", epoch, time.time() - epoch_start)
        if stop:
            break

    for s, h in prev_handlers.items():
        signal.signal(s, h)
    if prof is not None:  # the run ended inside the profiled range
        _stop_profile(prof, device, Path(args.output_dir) / "profile",
                      profile_range, rank if world > 1 else None)

    final_dir = save(global_step)
    result["checkpoints"] = ckpt.timings
    result["loader_wait_s"] = loader_wait.count - waited
    if lora is not None:
        factors = full_state_dict(flatten_lora(lora))
        if rank == 0:
            save_lora_weights(factors, final_dir)
            logger.info("saved LoRA weights to %s", final_dir)

    if args.export_pipeline:
        dit = export_dit(model, cfg, ema=ema, lora=lora, lora_alpha=args.lora_alpha,
                         lora_rank=args.lora_rank, rank=rank, stages=stages)
        if rank == 0:
            export_dir = Path(args.output_dir) / "pipeline"
            FLitePipeline(dit, vae).save_pretrained(export_dir,
                                                    scan_layers=args.scan_layers)
            logger.info("exported pipeline to %s", export_dir)
    if grouped:  # every rank returns once rank 0 has written
        dist.barrier(group=host)
    result["global_step"] = global_step
    result["wall_s"] = time.time() - t_start
    metrics_logger.record({"result": result})
    metrics_logger.close()
    logger.info("training completed after %d steps (%.1fs)", global_step,
                result["wall_s"])
    return result


def main(argv=None):
    # one rank's log lines: the others log warnings only
    logging.basicConfig(level=logging.INFO if launch_info()[1] == 0 else logging.WARNING)
    return train(parse_args(argv))
