"""Flux AutoencoderKL, decode side, in PyTorch (counterpart of
`f_lite_tpu/models/vae.py`).

Module names follow the diffusers state dict (`decoder.up_blocks.{i}...`),
the key set of `invert_vae_params`. Latents and images are NHWC at the
public boundary; inside, the convolutions run NCHW. GroupNorm computes in
fp32; the mid-block attention is one dense head over h*w tokens, a plain
einsum as in the JAX package (it is not a Pallas kernel there).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159
    mid_block_add_attention: bool = True

    @property
    def spatial_scale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @classmethod
    def flux(cls, **overrides) -> "VAEConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "VAEConfig":
        """2-level toy config for CPU tests (scale /2)."""
        kw = dict(block_out_channels=(8, 16), layers_per_block=1,
                  norm_num_groups=4, latent_channels=4)
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def from_json_dict(cls, d: dict) -> "VAEConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        if "block_out_channels" in kw:
            kw["block_out_channels"] = tuple(kw["block_out_channels"])
        return cls(**kw)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm in fp32 (eps 1e-6), cast back to the input dtype."""

    def __init__(self, groups: int, channels: int):
        super().__init__(groups, channels, eps=1e-6)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class ResnetBlock(nn.Module):
    def __init__(self, cfg: VAEConfig, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm32(cfg.norm_num_groups, in_ch)
        self.conv1 = _conv3(in_ch, out_ch)
        self.norm2 = GroupNorm32(cfg.norm_num_groups, out_ch)
        self.conv2 = _conv3(out_ch, out_ch)
        if in_ch != out_ch:
            self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class MidAttention(nn.Module):
    """Single-head spatial self-attention over h*w tokens (NCHW in/out)."""

    def __init__(self, cfg: VAEConfig, ch: int):
        super().__init__()
        self.group_norm = GroupNorm32(cfg.norm_num_groups, ch)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).flatten(2).transpose(1, 2)  # (B, hw, C)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        logits = torch.einsum("bqc,bkc->bqk", q.float(), k.float()) * c**-0.5
        probs = torch.softmax(logits, dim=-1).to(y.dtype)
        out = torch.einsum("bqk,bkc->bqc", probs.float(), v.float()).to(y.dtype)
        out = self.to_out[0](out)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class MidBlock(nn.Module):
    def __init__(self, cfg: VAEConfig, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(cfg, ch, ch), ResnetBlock(cfg, ch, ch)]
        )
        if cfg.mid_block_add_attention:
            self.attentions = nn.ModuleList([MidAttention(cfg, ch)])

    def forward(self, x):
        x = self.resnets[0](x)
        if hasattr(self, "attentions"):
            x = self.attentions[0](x)
        return self.resnets[1](x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = _conv3(ch, ch)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class UpBlock(nn.Module):
    def __init__(self, cfg: VAEConfig, in_ch: int, out_ch: int, upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(cfg, in_ch if j == 0 else out_ch, out_ch)
            for j in range(cfg.layers_per_block + 1)
        )
        if upsample:
            self.upsamplers = nn.ModuleList([Upsample(out_ch)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = list(reversed(cfg.block_out_channels))
        self.conv_in = _conv3(cfg.latent_channels, chans[0])
        self.mid_block = MidBlock(cfg, chans[0])
        self.up_blocks = nn.ModuleList(
            UpBlock(cfg, chans[max(i - 1, 0)], ch, i < len(chans) - 1)
            for i, ch in enumerate(chans)
        )
        self.conv_norm_out = GroupNorm32(cfg.norm_num_groups, chans[-1])
        self.conv_out = _conv3(chans[-1], cfg.out_channels)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """decode(z (B, h, w, C)) -> image (B, h*s, w*s, 3), NHWC."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        self.decoder = Decoder(cfg)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        dtype = self.decoder.conv_in.weight.dtype
        x = self.decoder(z.to(dtype).permute(0, 3, 1, 2))
        return x.permute(0, 2, 3, 1)


class IdentityVAE:
    """Pixel-space stand-in: decode is the identity. `config` has spatial
    scale 1, 3 latent channels, shift 0 and scale 1, so
    `normalize_latents`/`denormalize_latents` leave pixels unchanged."""

    def __init__(self):
        self.config = VAEConfig(latent_channels=3, block_out_channels=(4,),
                                scaling_factor=1.0, shift_factor=0.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return z


def normalize_latents(latents, cfg: VAEConfig):
    """(z - shift) * scale, the training normalisation."""
    return (latents - cfg.shift_factor) * cfg.scaling_factor


def denormalize_latents(latents, cfg: VAEConfig):
    """z / scale + shift, before decode."""
    return latents / cfg.scaling_factor + cfg.shift_factor


# "auto" switches to tiled decode past this many latents on the long side
AUTO_TILE_LATENTS = 128


def resolve_memory_mode(mode: str, lmax: int) -> str:
    """The decode mode for a latent long side `lmax`. Only "direct" is
    ported: "auto" resolves to it up to AUTO_TILE_LATENTS (1024 px for the
    Flux VAE); tiled and sliced decode are not ported yet and raise."""
    resolved = mode
    if mode == "auto":
        resolved = "tiled" if lmax > AUTO_TILE_LATENTS else "direct"
    if resolved != "direct":
        raise NotImplementedError(
            f"VAE memory mode {resolved!r} (latent side {lmax}) is not "
            "ported yet; only direct decode is"
        )
    return resolved
