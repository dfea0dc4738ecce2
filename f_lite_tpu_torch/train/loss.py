"""Flow-matching training loss with caption dropout and timestep-decile
binning (counterpart of `f_lite_tpu/train/loss.py`).

- caption dropout with probability `uncond_prob`: the context is zeroed and
  its mask set to all-ones for the dropped rows;
- t from `sample_train_timesteps` (90% resolution-shifted sigmoid-normal,
  10% uniform); z_t = (1 - t) x + t n; velocity target v = x - n;
- MSE in patchified token space, per-sample mean, then the batch mean
  (or the `sample_weight`-weighted mean);
- per-decile sums and counts of the per-sample losses (bin = min(int(10 t),
  9)).
`timesteps=` and `noise=` replace the random draws (tests, parity). The
random draws come from a `torch.Generator` on the latents' device; they are
not the JAX package's numbers. Inputs are normalized latents; all
reductions are fp32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from f_lite_tpu_torch.ops.patching import patchify
from f_lite_tpu_torch.ops.timesteps import sample_train_timesteps


class LossAux(NamedTuple):
    diffusion_loss: torch.Tensor   # scalar
    per_sample_loss: torch.Tensor  # (B,)
    timesteps: torch.Tensor        # (B,)
    bin_sums: torch.Tensor         # (10,) per-decile loss sums
    bin_counts: torch.Tensor       # (10,)


def flow_matching_loss(
    dit,
    latents: torch.Tensor,        # (B, h, w, C) normalized latents
    context: torch.Tensor,        # (B, S, Ctx)
    context_mask: torch.Tensor | None,
    *,
    generator: torch.Generator | None = None,
    uncond_prob: float = 0.05,
    patch_size: int = 2,
    token_keep_ratio: float = 1.0,
    timesteps: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
    sample_weight: torch.Tensor | None = None,  # (B,) 0/1
) -> tuple[torch.Tensor, LossAux]:
    if token_keep_ratio < 1.0:
        raise NotImplementedError(
            "token_keep_ratio < 1 (sequence dropout) is not ported yet: it "
            "needs token_indices in the DiT")
    b, h, w, _ = latents.shape
    device = latents.device

    if uncond_prob > 0:
        drop = torch.rand(b, generator=generator, device=device) < uncond_prob
        context = torch.where(drop[:, None, None], torch.zeros_like(context),
                              context)
        if context_mask is not None:
            context_mask = context_mask | drop[:, None]

    if timesteps is None:
        timesteps = sample_train_timesteps(generator, b, h * w)
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=device,
                            dtype=torch.float32)

    t = timesteps.float()[:, None, None, None]
    x = latents.float()
    z_t = x * (1.0 - t) + noise * t
    v_target = x - noise

    pred = dit(z_t.to(latents.dtype), context, context_mask,
               timesteps.to(latents.dtype))
    targ_tok = patchify(v_target, patch_size)
    pred_tok = patchify(pred.float(), patch_size)
    per_sample = ((targ_tok - pred_tok) ** 2).mean(dim=(1, 2))  # (B,)
    if sample_weight is None:
        loss = per_sample.mean()
        weight = torch.ones_like(per_sample)
    else:
        weight = sample_weight.float()
        loss = (per_sample * weight).sum() / weight.sum().clamp_min(1.0)

    bins = torch.clamp((timesteps * 10).to(torch.int64), max=9)
    zeros = torch.zeros(10, device=device, dtype=torch.float32)
    bin_sums = zeros.index_add(0, bins, (per_sample * weight).detach())
    bin_counts = zeros.index_add(0, bins, weight)
    return loss, LossAux(
        diffusion_loss=loss,
        per_sample_loss=per_sample,
        timesteps=timesteps,
        bin_sums=bin_sums,
        bin_counts=bin_counts,
    )
