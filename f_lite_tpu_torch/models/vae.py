"""Flux AutoencoderKL in PyTorch (counterpart of `f_lite_tpu/models/vae.py`):
encoder and decoder, and the memory modes of large images (sliced: one
sample at a time; tiled: overlapping tiles with linearly blended seams).

Module names follow the diffusers state dict (`encoder.down_blocks.{i}...`,
`decoder.up_blocks.{i}...`), the key set of `invert_vae_params`. Latents
and images are NHWC at the public boundary; inside, the convolutions run
NCHW. GroupNorm computes in fp32; the mid-block attention is one dense head
over h*w tokens, a plain einsum as in the JAX package (it is not a Pallas
kernel there).
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


class Downsample(nn.Module):
    """Pad right and bottom by one, then a stride-2 3x3 conv (diffusers)."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class DownBlock(nn.Module):
    def __init__(self, cfg: VAEConfig, in_ch: int, out_ch: int, downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(cfg, in_ch if j == 0 else out_ch, out_ch)
            for j in range(cfg.layers_per_block)
        )
        if downsample:
            self.downsamplers = nn.ModuleList([Downsample(out_ch)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
        return x


class Encoder(nn.Module):
    """Image (NCHW) -> moments (mean | logvar, 2 * latent_channels)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = list(cfg.block_out_channels)
        self.conv_in = _conv3(cfg.in_channels, chans[0])
        self.down_blocks = nn.ModuleList(
            DownBlock(cfg, chans[max(i - 1, 0)], ch, i < len(chans) - 1)
            for i, ch in enumerate(chans)
        )
        self.mid_block = MidBlock(cfg, chans[-1])
        self.conv_norm_out = GroupNorm32(cfg.norm_num_groups, chans[-1])
        self.conv_out = _conv3(chans[-1], 2 * cfg.latent_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


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
    """encode(image (B, H, W, 3)) -> posterior mean (B, H/s, W/s, C);
    decode(z (B, h, w, C)) -> image (B, h*s, w*s, 3). All NHWC."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)

    def encode_moments(self, x: torch.Tensor):
        """(mean, logvar) of the posterior, logvar clipped to [-30, 20]."""
        dtype = self.encoder.conv_in.weight.dtype
        moments = self.encoder(x.to(dtype).permute(0, 3, 1, 2))
        mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """The posterior's mean (the mode): deterministic, as the pipeline
        encodes."""
        return self.encode_moments(x)[0]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        dtype = self.decoder.conv_in.weight.dtype
        x = self.decoder(z.to(dtype).permute(0, 3, 1, 2))
        return x.permute(0, 2, 3, 1)


class IdentityVAE:
    """Pixel-space stand-in: decode is the identity (there is no encode:
    image-to-image needs a VAE). `config` has spatial scale 1, 3 latent
    channels, shift 0 and scale 1, so `normalize_latents` and
    `denormalize_latents` leave pixels unchanged."""

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


# "auto" switches to tiled encode and decode past this many latents on the
# long side (1024 px for the Flux VAE): the mid-block attention is
# quadratic in the latent count
AUTO_TILE_LATENTS = 128
MEMORY_MODES = ("auto", "direct", "sliced", "tiled")


def resolve_memory_mode(mode: str, lmax: int) -> str:
    """The VAE memory mode for a latent long side `lmax`: explicit modes
    pass through; "auto" tiles past AUTO_TILE_LATENTS."""
    if mode not in MEMORY_MODES:
        raise ValueError(f"VAE memory mode {mode!r} not in {MEMORY_MODES}")
    if mode != "auto":
        return mode
    return "tiled" if lmax > AUTO_TILE_LATENTS else "direct"


def decode_sliced(vae: AutoencoderKL, z: torch.Tensor) -> torch.Tensor:
    """Decode one sample at a time."""
    return torch.cat([vae.decode(z[i:i + 1]) for i in range(z.shape[0])])


def encode_sliced(vae: AutoencoderKL, x: torch.Tensor) -> torch.Tensor:
    """Encode (posterior mean) one sample at a time."""
    return torch.cat([vae.encode(x[i:i + 1]) for i in range(x.shape[0])])


def _blend(a, bb, n, dim):
    """`bb` after `a` along `dim` (NHWC: 2 side by side, 1 below), the last
    n entries of `a` blended linearly into the first n of `bb`."""
    n = min(n, a.shape[dim], bb.shape[dim])
    shape = [1] * a.ndim
    shape[dim] = n
    w = ((torch.arange(n, dtype=a.dtype, device=a.device) + 1) / (n + 1)).reshape(shape)
    mixed = a.narrow(dim, a.shape[dim] - n, n) * (1 - w) + bb.narrow(dim, 0, n) * w
    return torch.cat([a.narrow(dim, 0, a.shape[dim] - n), mixed,
                      bb.narrow(dim, n, bb.shape[dim] - n)], dim=dim)


def _merge_tiled(rows, blend):
    """Rows of tiles -> one image: each row blended left to right, then the
    rows top to bottom."""
    merged_rows = []
    for row in rows:
        acc = row[0]
        for tile in row[1:]:
            acc = _blend(acc, tile, blend, dim=2)
        merged_rows.append(acc)
    out = merged_rows[0]
    for r in merged_rows[1:]:
        out = _blend(out, r, blend, dim=1)
    return out


def _tile_starts(n: int, t: int, stride: int) -> list[int]:
    """Tile origins along a side of n: every `stride` until a tile of `t`
    reaches the end."""
    starts = []
    for s in range(0, n, stride):
        starts.append(s)
        if s + t >= n:
            break
    return starts


def _tiled(fn, x, lh, lw, t, overlap, scale_in, scale_out):
    """fn over overlapping tiles of t latents (t * scale_in entries of x),
    merged with seams blended over the overlap (in output entries)."""
    stride = int(t * (1 - overlap))
    rows = [[fn(x[:, i0 * scale_in:(i0 + t) * scale_in,
                  j0 * scale_in:(j0 + t) * scale_in, :])
             for j0 in _tile_starts(lw, t, stride)]
            for i0 in _tile_starts(lh, t, stride)]
    merged = _merge_tiled(rows, (t - stride) * scale_out)
    return merged[:, :lh * scale_out, :lw * scale_out, :]


def encode_tiled(vae: AutoencoderKL, x: torch.Tensor, *,
                 tile_latent_size: int = 64, overlap: float = 0.25) -> torch.Tensor:
    """Tiled deterministic encode: overlapping pixel tiles of
    `tile_latent_size` latents, each encoded to its posterior mean, with the
    latent seams blended linearly. A small image is encoded whole."""
    sf = vae.config.spatial_scale
    lh, lw = x.shape[1] // sf, x.shape[2] // sf
    if lh <= tile_latent_size and lw <= tile_latent_size:
        return vae.encode(x)
    return _tiled(vae.encode, x, lh, lw, tile_latent_size, overlap, sf, 1)


def decode_tiled(vae: AutoencoderKL, z: torch.Tensor, *,
                 tile_latent_size: int = 64, overlap: float = 0.25) -> torch.Tensor:
    """Tiled decode: overlapping latent tiles, decoded one by one, with the
    pixel seams blended linearly (the diffusers algorithm). Small latents
    are decoded whole."""
    lh, lw = z.shape[1], z.shape[2]
    if lh <= tile_latent_size and lw <= tile_latent_size:
        return vae.decode(z)
    return _tiled(vae.decode, z, lh, lw, tile_latent_size, overlap, 1,
                  vae.config.spatial_scale)
