"""Timestep embeddings and the resolution-shift schedule (counterpart of
`f_lite_tpu/ops/timesteps.py`)."""

from __future__ import annotations

import math

import torch


def timestep_embedding(t: torch.Tensor, dim: int, *,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding (B, dim): [cos(t*f) | sin(t*f)], fp32, with
    f = exp(-ln(max_period) * i / half) for i in [0, half)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def resolution_alpha(image_token_size: int) -> float:
    """`alpha = 2 * sqrt(hw / 64^2)` for latent_h * latent_w = hw."""
    return 2.0 * math.sqrt(image_token_size / (64.0 * 64.0))


def shift_t(t, alpha):
    """Resolution-shifted timestep: `t * a / (1 + (a - 1) * t)`."""
    return t * alpha / (1.0 + (alpha - 1.0) * t)


def euler_timestep_pairs(num_steps: int, alpha: float) -> torch.Tensor:
    """(t, t_next) of the descending Euler schedule, shape (N, 2), fp32:
    step i = N..1 uses t = shift(i/N), t_next = shift((i-1)/N)."""
    i = torch.arange(num_steps, 0, -1, dtype=torch.float32)
    t = shift_t(i / num_steps, alpha)
    t_next = shift_t((i - 1.0) / num_steps, alpha)
    return torch.stack([t, t_next], dim=-1)
