"""Seeded random weights for runs without a checkpoint (smoke runs at full
width, tests)."""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def randomize_(module: nn.Module, seed: int) -> nn.Module:
    """Overwrite every parameter in place with seeded non-zero values, drawn
    on the parameters' device: matrices and convolutions
    N(0, (0.5/sqrt(fan_in))^2), norm weights 1 + N(0, 0.05^2), other
    vectors N(0, 0.05^2), register tokens N(0, 1), lambda_v U(0, 1). The
    zero-init AdaLN and final heads get weights too, or a DiT's velocity
    would be exactly 0."""
    device = next(module.parameters()).device
    gen = torch.Generator(device).manual_seed(seed)
    for name, p in module.named_parameters():
        shape = tuple(p.shape)
        if name.endswith("lambda_v"):
            val = torch.rand(shape, generator=gen, device=device)
        else:
            val = torch.randn(shape, generator=gen, device=device)
            if name == "register_tokens":
                pass
            elif len(shape) >= 2:
                val *= 0.5 / math.sqrt(math.prod(shape[1:]))
            elif "norm" in name and name.endswith("weight"):
                val = 1.0 + 0.05 * val
            else:
                val *= 0.05
        p.copy_(val)
    return module
