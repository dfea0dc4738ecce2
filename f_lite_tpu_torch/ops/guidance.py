"""Classifier-free guidance and APG combines (counterpart of
`f_lite_tpu/ops/guidance.py`).

CFG: u + g * (c - u). APG splits (c - u) into parts parallel and
orthogonal to c with one scalar projection over the whole batch tensor,
clamps the orthogonal part's global std to `orthogonal_threshold`, and
returns c + (g - 1) * orth. The global reduction is the reference's.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class APGConfig:
    enabled: bool = True
    orthogonal_threshold: float = 0.03


def cfg_combine(uncond: torch.Tensor, cond: torch.Tensor,
                guidance_scale: float) -> torch.Tensor:
    return uncond + guidance_scale * (cond - uncond)


def apg_combine(uncond: torch.Tensor, cond: torch.Tensor,
                guidance_scale: float,
                orthogonal_threshold: float = 0.03) -> torch.Tensor:
    dy = cond.float()
    dd = dy - uncond.float()
    parallel = (dy * dd).sum() / (dy * dy).sum() * dy
    orth = dd - parallel
    orth_std = orth.std(unbiased=False)
    orth_scale = torch.clamp(orthogonal_threshold / orth_std, max=1.0)
    out = dy + (guidance_scale - 1.0) * orth * orth_scale
    return out.to(cond.dtype)


def guidance_combine(uncond, cond, guidance_scale: float,
                     apg: APGConfig | None = None):
    if apg is not None and apg.enabled:
        return apg_combine(uncond, cond, guidance_scale,
                           apg.orthogonal_threshold)
    return cfg_combine(uncond, cond, guidance_scale)
