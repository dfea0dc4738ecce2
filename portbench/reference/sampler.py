"""The CFG Euler sampler of flow matching over the resolution-shifted
schedule, in float32.

Step i of N (i = N .. 1) goes from t = shift(i / N) to shift((i - 1) / N),
shift(t) = a t / (1 + (a - 1) t), a = 2 sqrt(h w / 64^2) for an h x w
latent grid. One step: v = u + g (c - u), the unconditional and the
conditional velocity of the DiT at t (the unconditional row sees a zero
context under the prompt's mask), and z <- z + (t - t_next) v.
"""

from __future__ import annotations

import math

import torch


def schedule(steps: int, lh: int, lw: int) -> list[tuple[float, float]]:
    a = 2.0 * math.sqrt(lh * lw / 4096.0)

    def shift(t):
        return t * a / (1.0 + (a - 1.0) * t)

    return [(shift(i / steps), shift((i - 1) / steps)) for i in range(steps, 0, -1)]


def cfg_step(model, z, context, mask, t: float, t_next: float, guidance: float):
    """The state after one step from z (B, h, w, C): the DiT runs on
    [zero context, context] with the mask twice, as one batch."""
    b = z.shape[0]
    ctx = torch.cat([torch.zeros_like(context), context]).float()
    out = model(torch.cat([z, z]).float(), ctx, torch.cat([mask, mask]),
                torch.full((2 * b,), t, device=z.device))
    u, c = out[:b], out[b:]
    return z.float() + (t - t_next) * (u + guidance * (c - u))
