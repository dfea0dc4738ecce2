"""Patchify / unpatchify between NHWC images and token sequences
(counterpart of `f_lite_tpu/ops/patching.py`).

Each (p, p, C) patch flattens in (ki, kj, c) order, the order of the
patch-embed kernel; unpatchify reads the final projection's columns in
(p1, p2, c) order.
"""

from __future__ import annotations

import torch


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, (H/p)*(W/p), p*p*C)."""
    b, h, w, c = x.shape
    p = patch_size
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def unpatchify(tokens: torch.Tensor, grid_h: int, grid_w: int,
               patch_size: int, channels: int) -> torch.Tensor:
    """(B, h*w, p*p*C) -> (B, h*p, w*p, C)."""
    b = tokens.shape[0]
    p = patch_size
    x = tokens.reshape(b, grid_h, grid_w, p, p, channels)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, grid_h * p, grid_w * p, channels)
