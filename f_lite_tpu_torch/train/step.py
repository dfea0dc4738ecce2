"""One training step: loss -> backward -> clip -> AdamW (counterpart of
`f_lite_tpu/train/step.py`, whose jitted step does the same in one XLA
program). Here the forward and backward run eagerly through the DiT, with
the flash-attention kernels on the card. The optimizer's parameters are
what trains: the DiT's, or the LoRA factors of a frozen DiT
(`train/lora.py`); under `Accumulate` a call is one micro-batch.
`debug_nans` is the counterpart of `jax_debug_nans`: the step runs under
`torch.autograd.detect_anomaly()` and raises FloatingPointError at a loss
or gradient norm that is not finite (or a backward that gives NaN), before
the update."""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from f_lite_tpu_torch.train.loss import flow_matching_loss
from f_lite_tpu_torch.train.optim import Accumulate, AdamW, global_norm


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: AdamW | Accumulate
    step: int = 0


def train_step(state: TrainState, latents, context, context_mask, *,
               generator: torch.Generator | None = None,
               uncond_prob: float = 0.05, patch_size: int = 2,
               token_keep_ratio: float = 1.0, sample_weight=None,
               timesteps=None, noise=None, token_indices=None,
               debug_nans: bool = False) -> dict:
    """Run one step in place on `state` and return its metrics as device
    tensors: loss, grad_norm (the global norm of this call's gradients,
    before clipping), bin_sums and bin_counts (per-decile loss sums and
    counts). With `debug_nans` the step is checked (see the module
    docstring); without it nothing waits for the device."""
    model, opt = state.model, state.optimizer
    n = state.step + 1
    for p in opt.params:
        p.grad = None
    anomaly = (torch.autograd.detect_anomaly() if debug_nans
               else contextlib.nullcontext())
    with anomaly:
        loss, aux = flow_matching_loss(
            model, latents, context, context_mask, generator=generator,
            uncond_prob=uncond_prob, patch_size=patch_size,
            token_keep_ratio=token_keep_ratio, sample_weight=sample_weight,
            timesteps=timesteps, noise=noise, token_indices=token_indices,
        )
        if debug_nans:
            _check_finite(loss.detach(), "loss", n)
        try:
            loss.backward()
        except RuntimeError as e:
            if debug_nans and "nan values" in str(e):
                raise FloatingPointError(f"--debug_nans: step {n}: {e}") from e
            raise
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in opt.params]
    if debug_nans:
        _check_finite(global_norm(grads), "gradient norm", n)
    grad_norm = opt.step(grads)
    for p in opt.params:
        p.grad = None
    state.step += 1
    return {
        "loss": loss.detach(),
        "grad_norm": grad_norm,
        "bin_sums": aux.bin_sums,
        "bin_counts": aux.bin_counts,
    }


def _check_finite(value: torch.Tensor, what: str, step: int) -> None:
    v = float(value)
    if not math.isfinite(v):
        raise FloatingPointError(f"--debug_nans: step {step}: the {what} is {v}")
