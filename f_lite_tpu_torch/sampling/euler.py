"""CFG-batched Euler flow-matching sampler (counterpart of the Euler path of
`f_lite_tpu/sampling/euler.py`, `_denoise_schedule`).

A plain Python loop over the (t, t_next) schedule: per step one DiT forward
on the CFG pair batched as [neg, pos] with masks [neg_mask, pos_mask], the
CFG or APG combine, and z += (t - t_next) * v on an fp32 accumulator.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from f_lite_tpu_torch.ops.guidance import APGConfig, guidance_combine
from f_lite_tpu_torch.ops.timesteps import euler_timestep_pairs, resolution_alpha


@dataclasses.dataclass(frozen=True)
class DenoiseSettings:
    num_inference_steps: int = 30
    guidance_scale: float = 6.0
    apg: APGConfig | None = None
    alpha: float | None = None  # None: derive from latent h*w


def full_schedule(settings: DenoiseSettings, lh: int, lw: int) -> torch.Tensor:
    alpha = settings.alpha
    if alpha is None:
        alpha = resolution_alpha(lh * lw)
    return euler_timestep_pairs(settings.num_inference_steps, alpha)


@torch.no_grad()
def denoise(dit: Callable, latents: torch.Tensor, prompt_embeds: torch.Tensor,
            negative_embeds: torch.Tensor, context_mask: torch.Tensor | None,
            settings: DenoiseSettings,
            negative_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Run the Euler loop. latents (B, h, w, C) NHWC; embeds (B, S, Ctx).

    `dit(x, context, context_mask, t)` is the model forward. `negative_mask`
    defaults to `context_mask`. Returns the final latents in
    `latents.dtype`."""
    b, lh, lw, _ = latents.shape
    schedule = full_schedule(settings, lh, lw)
    ts = schedule[:, 0].to(latents.device)
    dts = (schedule[:, 0] - schedule[:, 1]).to(latents.device)  # fp32
    do_cfg = settings.guidance_scale >= 1.0
    if do_cfg:
        context = torch.cat([negative_embeds, prompt_embeds])
        if context_mask is not None:
            nm = negative_mask if negative_mask is not None else context_mask
            context_mask = torch.cat([nm, context_mask])
    else:
        context = prompt_embeds

    z = latents.float()
    for i in range(schedule.shape[0]):
        if do_cfg:
            out = dit(torch.cat([z, z]), context, context_mask,
                      ts[i].expand(2 * b))
            v = guidance_combine(out[:b], out[b:], settings.guidance_scale,
                                 settings.apg).float()
        else:
            v = dit(z, context, context_mask, ts[i].expand(b)).float()
        z = z + dts[i] * v
    return z.to(latents.dtype)
