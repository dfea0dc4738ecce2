"""2D rotary embeddings for patch grids (counterpart of `f_lite_tpu/ops/rope.py`).

Per-axis frequencies `1 / base**(i / dim)` for even i in [0, dim) with
dim = head_dim // 2; rows take the H frequencies and columns the W ones,
concatenated to (h*w, head_dim // 2). Register tokens get the identity
rotation (cos 1, sin 0), prepended. The rotation is rotate-half in fp32.
"""

from __future__ import annotations

import torch

from f_lite_tpu_torch.utils.trace import span


def rope_2d_freqs(head_dim: int, h: int, w: int, *, base: float = 10000.0,
                  n_register_tokens: int = 0, device=None):
    """cos/sin tables of shape (n_register + h*w, head_dim // 2), fp32."""
    dim = head_dim // 2
    inv_freq = 1.0 / (
        base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                 / dim)
    )
    freqs_h = torch.outer(torch.arange(h, dtype=torch.float32, device=device),
                          inv_freq)
    freqs_w = torch.outer(torch.arange(w, dtype=torch.float32, device=device),
                          inv_freq)
    freqs = torch.cat(
        [freqs_h[:, None, :].expand(h, w, -1),
         freqs_w[None, :, :].expand(h, w, -1)],
        dim=-1,
    ).reshape(h * w, dim)
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    if n_register_tokens > 0:
        cos = torch.cat([cos.new_ones(n_register_tokens, dim), cos])
        sin = torch.cat([sin.new_zeros(n_register_tokens, dim), sin])
    return cos, sin


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE in fp32. x (B, H, T, D); cos/sin (T, D // 2) or
    per batch row (B, T, D // 2) (the rows gathered under sequence
    dropout). Span `op.rope`."""
    if cos.dim() == 3:  # (B, T, D/2): broadcast over the heads
        cos, sin = cos[:, None], sin[:, None]
    with span("op.rope"):
        x32 = x.float()
        d = x32.shape[-1] // 2
        x1, x2 = x32[..., :d], x32[..., d:]
        y1 = x1 * cos + x2 * sin
        y2 = -x1 * sin + x2 * cos
        return torch.cat([y1, y2], dim=-1).to(x.dtype)
