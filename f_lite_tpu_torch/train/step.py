"""One training step: loss -> backward -> clip -> AdamW (counterpart of
`f_lite_tpu/train/step.py`, whose jitted step does the same in one XLA
program). Here the forward and backward run eagerly through the DiT, with
the flash-attention kernels on the card."""

from __future__ import annotations

import dataclasses

import torch

from f_lite_tpu_torch.train.loss import flow_matching_loss
from f_lite_tpu_torch.train.optim import AdamW


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: AdamW
    step: int = 0


def train_step(state: TrainState, latents, context, context_mask, *,
               generator: torch.Generator | None = None,
               uncond_prob: float = 0.05, patch_size: int = 2,
               timesteps=None, noise=None) -> dict:
    """Run one step in place on `state` and return its metrics as device
    tensors: loss, grad_norm (the global norm before clipping), bin_sums and
    bin_counts (per-decile loss sums and counts)."""
    model, opt = state.model, state.optimizer
    for p in opt.params:
        p.grad = None
    loss, aux = flow_matching_loss(
        model, latents, context, context_mask, generator=generator,
        uncond_prob=uncond_prob, patch_size=patch_size,
        timesteps=timesteps, noise=noise,
    )
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in opt.params]
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
