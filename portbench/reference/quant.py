"""Symmetric integer products as `quant.py` defines W8A8: each weight row
and each activation row scaled by its max |value| / Q (Q = 127 for int8,
7 for int4; scale 1 where the max is 0), rounded half to even and clipped
to [-Q, Q]; the integer product accumulated, then times both scales. The
integers are held in float32: their products and sums are exact while
they stay under 2^24, and off by float32 rounding past it. And float8
e4m3 rounding, for a computation held in fp8."""

from __future__ import annotations

import torch

LEVELS = {"int8": 127.0, "int4": 7.0}


def quantize(x: torch.Tensor, q: float):
    """(integers as fp32, scale (..., 1)) of x's rows (last dim)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax / torch.full_like(amax, q)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    return torch.clamp(torch.round(xf / scale), -q, q), scale


def int_linear(x: torch.Tensor, w: torch.Tensor, bias, q: float) -> torch.Tensor:
    """x (..., K) @ w (N, K)^T through symmetric integers of `q` levels."""
    xq, sx = quantize(x, q)
    wq, sw = quantize(w, q)
    y = (xq @ wq.T) * sx * sw[:, 0]
    return y if bias is None else y + bias.float()


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3, each row (last dim) scaled so that its max
    |value| is the format's largest (448); the gradient passes unchanged."""
    with torch.no_grad():
        scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / 448.0
        rounded = (x / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (rounded - x).detach() if x.requires_grad else rounded
