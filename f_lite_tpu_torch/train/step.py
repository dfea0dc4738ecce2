"""One training step: loss -> backward -> clip -> AdamW (counterpart of
`f_lite_tpu/train/step.py`, whose jitted step does the same in one XLA
program). Here the forward and backward run eagerly through the DiT, with
the flash-attention kernels on the card. The optimizer's parameters are
what trains: the DiT's, or the LoRA factors of a frozen DiT
(`train/lora.py`); under `Accumulate` a call is one micro-batch.
`debug_nans` is the counterpart of `jax_debug_nans`: the step runs under
`torch.autograd.detect_anomaly()` and raises FloatingPointError at a loss
or gradient norm that is not finite (or a backward that gives NaN), before
the update.

Across `world` data replicas (FSDP2, which averages the replicas'
gradients) each rank passes its rows, their draws and the global batch's
weight sum: its loss is its share of the global loss, scaled by `world`
for the backward, and the metrics are the global batch's (the loss and the
decile sums all-reduced over `group`, the replicas of this rank's pp
and tp coordinates; the norm is the whole gradient's). Under tensor parallelism the
ranks of a tp group are one replica: they pass the same rows. Under `debug_nans` the
checks read those global values, so every rank stops at the same step;
anomaly mode stays off there, since it would stop one rank alone in the
middle of the backward's collectives.

Under pipeline parallelism (`state.model` a `parallel.pipeline.
PipelinedDiT`) the forwards and backwards of the step's microbatches run
in one GPipe schedule (`loss.pipelined_flow_matching_loss`); the loss and
the deciles are the last stage's, broadcast over the pipeline, each stage
updates its own parameters, and the optimizer's norm sums over the
stages (`optim.global_norm(group=)`). Anomaly mode stays off there too."""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist

from f_lite_tpu_torch.parallel.pipeline import PipelinedDiT
from f_lite_tpu_torch.train.loss import flow_matching_loss, pipelined_flow_matching_loss
from f_lite_tpu_torch.train.optim import Accumulate, AdamW, global_norm
from f_lite_tpu_torch.utils.trace import span


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: AdamW | Accumulate
    step: int = 0


def train_step(state: TrainState, latents, context, context_mask, *,
               generator: torch.Generator | None = None,
               uncond_prob: float = 0.05, patch_size: int = 2,
               token_keep_ratio: float = 1.0, sample_weight=None,
               timesteps=None, noise=None, token_indices=None, draws=None,
               weight_sum=None, world: int = 1, group=None,
               debug_nans: bool = False) -> dict:
    """Run one step in place on `state` and return its metrics as device
    tensors: loss, grad_norm (the global norm of this call's gradients,
    before clipping), bin_sums and bin_counts (per-decile loss sums and
    counts). With `debug_nans` the step is checked (see the module
    docstring); without it nothing waits for the device. With `world` > 1
    data replicas (every rank of the default group calls this; `group`:
    this rank's replicas, None for the default group) `weight_sum` is the
    global batch's weight sum (its row count without `sample_weight`).

    Spans: `train.step`, and in it `train.loss` (the forward and the loss;
    under pipeline parallelism the whole schedule) and `train.backward`;
    the optimizer's own (`optim.*`)."""
    with span("train.step"):
        model, opt = state.model, state.optimizer
        n = state.step + 1
        if world > 1 and weight_sum is None:
            raise ValueError("a step across ranks needs the global batch's weight_sum")
        for p in opt.params:
            p.grad = None
        pipelined = isinstance(model, PipelinedDiT)
        anomaly = (torch.autograd.detect_anomaly() if debug_nans and world == 1
                   and not pipelined else contextlib.nullcontext())
        with anomaly:
            with span("train.loss"):
                if pipelined:  # the backward runs inside the schedule
                    loss, aux = pipelined_flow_matching_loss(
                        model, latents, context, context_mask, draws=draws,
                        patch_size=patch_size, sample_weight=sample_weight,
                        weight_sum=weight_sum if world > 1 else None, grad_scale=world)
                else:
                    loss, aux = flow_matching_loss(
                        model, latents, context, context_mask, generator=generator,
                        uncond_prob=uncond_prob, patch_size=patch_size,
                        token_keep_ratio=token_keep_ratio, sample_weight=sample_weight,
                        timesteps=timesteps, noise=noise, token_indices=token_indices,
                        draws=draws, weight_sum=weight_sum if world > 1 else None,
                    )
            metrics = {"loss": loss.detach(), "bin_sums": aux.bin_sums,
                       "bin_counts": aux.bin_counts}
            if world > 1:
                packed = torch.cat([loss.detach().reshape(1), aux.bin_sums,
                                    aux.bin_counts])
                dist.all_reduce(packed, group=group)
                metrics = {"loss": packed[0], "bin_sums": packed[1:11],
                           "bin_counts": packed[11:]}
                loss = loss * world
            if debug_nans:
                _check_finite(metrics["loss"], "loss", n)
            if not pipelined:
                try:
                    with span("train.backward"):
                        loss.backward()
                except RuntimeError as e:
                    if debug_nans and "nan values" in str(e):
                        raise FloatingPointError(f"--debug_nans: step {n}: {e}") from e
                    raise
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in opt.params]
        if debug_nans:
            _check_finite(global_norm(grads, opt.norm_group), "gradient norm", n)
        grad_norm = opt.step(grads)
        for p in opt.params:
            p.grad = None
        state.step += 1
        return {**metrics, "grad_norm": grad_norm}


def _check_finite(value: torch.Tensor, what: str, step: int) -> None:
    v = float(value)
    if not math.isfinite(v):
        raise FloatingPointError(f"--debug_nans: step {step}: the {what} is {v}")
