"""Flow-matching training loss with caption dropout and timestep-decile
binning (counterpart of `f_lite_tpu/train/loss.py`).

- caption dropout with probability `uncond_prob`: the context is zeroed and
  its mask set to all-ones for the dropped rows;
- t from `sample_train_timesteps` (90% resolution-shifted sigmoid-normal,
  10% uniform); z_t = (1 - t) x + t n; velocity target v = x - n;
- sequence dropout (`token_keep_ratio` < 1): each row keeps the first
  max(1, int(n_patches * ratio)) of an argsort of uniform scores, the DiT
  runs on those tokens only and the target is gathered with the same
  indices;
- MSE in patchified token space, per-sample mean, then the batch mean
  (or the `sample_weight`-weighted mean);
- per-decile sums and counts of the per-sample losses (bin = min(int(10 t),
  9)).
`timesteps=`, `noise=` and `token_indices=` replace the random draws
(tests, parity), and `draws=` all of them. The random draws
(`draw_loss_inputs`) come from a `torch.Generator` on the latents' device;
they are not the JAX package's numbers. Across ranks each rank draws a
step's values over the global batch, as one rank would, and keeps its rows
(`LossDraws.rows`, at `parallel.sharding.rank_rows`' bounds, which give
the ranks of a tp group the same rows and so the same draws);
`weight_sum` is then the global batch's weight sum.
Inputs are normalized latents; all reductions are fp32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from f_lite_tpu_torch.ops.patching import patchify
from f_lite_tpu_torch.ops.timesteps import sample_train_timesteps


class LossDraws(NamedTuple):
    drop: torch.Tensor | None           # (B,) bool, caption dropout
    timesteps: torch.Tensor             # (B,)
    noise: torch.Tensor                 # (B, h, w, C) fp32
    token_indices: torch.Tensor | None  # (B, K) int64, sequence dropout

    def rows(self, lo: int, hi: int) -> "LossDraws":
        """The draws of rows lo..hi-1 of the batch."""
        return LossDraws(*(None if x is None else x[lo:hi] for x in self))


def draw_loss_inputs(generator: torch.Generator | None, shape, device, *,
                     uncond_prob: float = 0.05, patch_size: int = 2,
                     token_keep_ratio: float = 1.0, timesteps=None, noise=None,
                     token_indices=None) -> LossDraws:
    """A step's draws for a batch of latents of `shape` (B, h, w, C), in
    `flow_matching_loss`'s order: caption dropout, t, noise, the kept
    tokens' scores; a value passed in is not drawn."""
    b, h, w, _ = shape
    drop = None
    if uncond_prob > 0:
        drop = torch.rand(b, generator=generator, device=device) < uncond_prob
    if timesteps is None:
        timesteps = sample_train_timesteps(generator, b, h * w)
    if noise is None:
        noise = torch.randn(tuple(shape), generator=generator, device=device,
                            dtype=torch.float32)
    if token_indices is None and token_keep_ratio < 1.0:
        n_patches = (h // patch_size) * (w // patch_size)
        keep = max(1, int(n_patches * token_keep_ratio))
        scores = torch.rand(b, n_patches, generator=generator, device=device)
        token_indices = torch.argsort(scores, dim=1)[:, :keep]
    return LossDraws(drop, timesteps, noise, token_indices)


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
    token_indices: torch.Tensor | None = None,  # (B, K) int64
    sample_weight: torch.Tensor | None = None,  # (B,) 0/1
    draws: LossDraws | None = None,
    weight_sum: torch.Tensor | None = None,
) -> tuple[torch.Tensor, LossAux]:
    """The loss and its aux. With `weight_sum` the loss is the weighted
    sum of these rows' losses over `weight_sum` (a larger batch's weight
    sum; rows weigh 1 without `sample_weight`), so that the ranks' losses
    add up to the global batch's."""
    device = latents.device
    if draws is None:
        draws = draw_loss_inputs(
            generator, latents.shape, device, uncond_prob=uncond_prob,
            patch_size=patch_size, token_keep_ratio=token_keep_ratio,
            timesteps=timesteps, noise=noise, token_indices=token_indices)
    context, context_mask, z_t, v_target = _noised(latents, context, context_mask, draws)
    timesteps, token_indices = draws.timesteps, draws.token_indices

    pred = dit(z_t.to(latents.dtype), context, context_mask,
               timesteps.to(latents.dtype), token_indices)
    per_sample = per_sample_losses(pred, v_target, patch_size, token_indices)
    weight = (torch.ones_like(per_sample) if sample_weight is None
              else sample_weight.float())
    if sample_weight is None and weight_sum is None:
        loss = per_sample.mean()
    else:
        total = weight.sum() if weight_sum is None else weight_sum
        loss = (per_sample * weight).sum() / total.clamp_min(1.0)
    return loss, _aux(loss, per_sample, weight, timesteps)


def _noised(latents, context, context_mask, draws: LossDraws):
    """Caption dropout applied; (context, mask, z_t, v_target)."""
    drop, timesteps, noise, _ = draws
    if drop is not None:
        context = torch.where(drop[:, None, None], torch.zeros_like(context),
                              context)
        if context_mask is not None:
            context_mask = context_mask | drop[:, None]
    t = timesteps.float()[:, None, None, None]
    x = latents.float()
    z_t = x * (1.0 - t) + noise * t
    return context, context_mask, z_t, x - noise


def per_sample_losses(pred, v_target, patch_size: int, token_indices=None):
    """Each row's MSE in patchified token space (B,), fp32."""
    targ_tok = patchify(v_target, patch_size)
    if token_indices is None:
        pred_tok = patchify(pred.float(), patch_size)
    else:  # token-space prediction of the kept tokens
        pred_tok = pred.float()
        targ_tok = torch.take_along_dim(targ_tok, token_indices[..., None], dim=1)
    return ((targ_tok - pred_tok) ** 2).mean(dim=(1, 2))


def _aux(loss, per_sample, weight, timesteps) -> LossAux:
    bins = torch.clamp((timesteps * 10).to(torch.int64), max=9)
    zeros = torch.zeros(10, device=per_sample.device, dtype=torch.float32)
    bin_sums = zeros.index_add(0, bins, (per_sample * weight).detach())
    bin_counts = zeros.index_add(0, bins, weight)
    return LossAux(
        diffusion_loss=loss,
        per_sample_loss=per_sample,
        timesteps=timesteps,
        bin_sums=bin_sums,
        bin_counts=bin_counts,
    )


def pipelined_flow_matching_loss(pipe, latents, context, context_mask, *,
                                 draws: LossDraws, patch_size: int = 2,
                                 sample_weight=None, weight_sum=None,
                                 grad_scale: float = 1.0):
    """`flow_matching_loss` through a pipeline of stages
    (`parallel.pipeline.PipelinedDiT`), forwards and backwards in one
    schedule: the last stage computes each microbatch's loss, the weighted
    sum of its rows' losses over the batch's weight sum (`weight_sum`,
    else these rows'), so the microbatches' losses add up to the batch's;
    times `grad_scale` for the backward (the data replicas FSDP averages
    over). The gradients are in the parameters' `.grad` on return. The
    loss (detached) and the aux, with every row's loss, are the last
    stage's, broadcast over the pipeline."""
    if draws.token_indices is not None:
        raise ValueError("pipeline_stages > 1 is incompatible with sequence "
                         "dropout (token_indices) — rope becomes per-sample")
    context, context_mask, z_t, v_target = _noised(latents, context, context_mask, draws)
    b = latents.shape[0]
    weight = (torch.ones(b, device=latents.device) if sample_weight is None
              else sample_weight.float())
    total = (weight.sum() if weight_sum is None else weight_sum).clamp_min(1.0)
    # what the last stage needs of each row: its target and its weight
    target = torch.cat([v_target.reshape(b, -1), weight[:, None]], dim=1)
    rows = []

    def loss(pred, tgt):
        ps = per_sample_losses(pred, tgt[:, :-1].reshape(pred.shape), patch_size)
        rows.append(ps.detach())
        return (ps * tgt[:, -1]).sum() / total * grad_scale

    order = pipe.train_microbatches(z_t.to(latents.dtype), context, context_mask,
                                    draws.timesteps.to(latents.dtype), target, loss)
    per_sample = torch.zeros(b, device=latents.device)
    if rows:  # the last stage: back to the batch's order
        per_sample.index_copy_(0, order, torch.cat(rows))
    per_sample = pipe.broadcast_from_last(per_sample)
    loss_value = (per_sample * weight).sum() / total
    return loss_value, _aux(loss_value, per_sample, weight, draws.timesteps)
