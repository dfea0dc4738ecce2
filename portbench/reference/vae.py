"""The Flux VAE's decoder in float32 (the diffusers AutoencoderKL layout).

decode(w, vae, z) -> image: z (B, h, w, C) latents, already denormalized
(z / scaling_factor + shift_factor), to (B, 8h, 8w, 3) in about [-1, 1],
NHWC. conv_in, a middle block (resnet, single-head attention over every
position, resnet), up blocks of layers_per_block + 1 resnets each with a
nearest x2 upsample and a 3x3 conv after all but the last, then GroupNorm,
SiLU and conv_out. GroupNorm has epsilon 1e-6; a resnet is
x + conv2(silu(gn2(conv1(silu(gn1(x)))))), with a 1x1 conv on x where the
widths differ.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def group_norm(x, w, b, groups: int, eps: float = 1e-6):
    n, c = x.shape[:2]
    g = x.reshape(n, groups, -1)
    mean = g.mean(-1, keepdim=True)
    var = (g - mean).pow(2).mean(-1, keepdim=True)
    g = (g - mean) * torch.rsqrt(var + eps)
    return g.reshape(x.shape) * w[None, :, None, None] + b[None, :, None, None]


def decode(w: dict, vae: dict, z: torch.Tensor) -> torch.Tensor:
    groups = vae["norm_num_groups"]

    def conv(name, x, pad=1):
        return F.conv2d(x, w[name + ".weight"], w[name + ".bias"], padding=pad)

    def resnet(p, x):
        h = conv(p + "conv1", F.silu(group_norm(x, w[p + "norm1.weight"],
                                                w[p + "norm1.bias"], groups)))
        h = conv(p + "conv2", F.silu(group_norm(h, w[p + "norm2.weight"],
                                                w[p + "norm2.bias"], groups)))
        if p + "conv_shortcut.weight" in w:
            x = conv(p + "conv_shortcut", x, pad=0)
        return x + h

    def mid_attention(p, x):
        n, c, hh, ww = x.shape
        y = group_norm(x, w[p + "group_norm.weight"], w[p + "group_norm.bias"], groups)
        y = y.flatten(2).transpose(1, 2)
        q, k, v = (F.linear(y, w[f"{p}{m}.weight"], w[f"{p}{m}.bias"])
                   for m in ("to_q", "to_k", "to_v"))
        a = torch.softmax((q @ k.transpose(1, 2)) * c ** -0.5, -1) @ v
        a = F.linear(a, w[p + "to_out.0.weight"], w[p + "to_out.0.bias"])
        return x + a.transpose(1, 2).reshape(n, c, hh, ww)

    x = conv("conv_in", z.float().permute(0, 3, 1, 2))
    x = resnet("mid_block.resnets.0.", x)
    x = mid_attention("mid_block.attentions.0.", x)
    x = resnet("mid_block.resnets.1.", x)
    levels = len(vae["block_out_channels"])
    for i in range(levels):
        for j in range(vae["layers_per_block"] + 1):
            x = resnet(f"up_blocks.{i}.resnets.{j}.", x)
        if i < levels - 1:
            x = conv(f"up_blocks.{i}.upsamplers.0.conv",
                     F.interpolate(x, scale_factor=2.0, mode="nearest"))
    x = F.silu(group_norm(x, w["conv_norm_out.weight"], w["conv_norm_out.bias"], groups))
    return conv("conv_out", x).permute(0, 2, 3, 1)


def denormalize(latents: torch.Tensor, vae: dict) -> torch.Tensor:
    return latents.float() / vae["scaling_factor"] + vae["shift_factor"]


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> round(clip(x / 2 + 1 / 2, 0, 1) * 255), ties to even."""
    return torch.round(torch.clamp(images.float() * 0.5 + 0.5, 0.0, 1.0) * 255.0).to(torch.uint8)
