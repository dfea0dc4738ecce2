"""The port's state dicts -> the JAX package's parameters: the inverses of
`convert.from_jax.state_dict_from_jax` and `vae_state_dict_from_jax`.

Output: dot-flattened flax keys exactly as `flax_params.safetensors` stores
them (the layout `FLitePipeline.save_pretrained` writes, unrolled blocks),
as CPU tensors in their own dtype (fp32, bf16; int8 weights int8, their
scales fp32). Layouts:
- Linear weight (out, in)                 -> Dense kernel (in, out);
- fused weight (prod(split)*H*D, in)      -> head-aligned kernel
                                             (in, *split, H, D), bias
                                             (*split, H, D);
- `QuantDense` w8 (N, in) int8, scale (N,) -> w8 and scale in the kernel's
                                             layout above ((in, *out) and
                                             (*out)), as `quantize_dit_params`
                                             leaves them;
- Conv2d weight (D, C, p, p)              -> patch-embed kernel (p*p*C, D),
                                             rows in the patches' (ki, kj, c)
                                             order;
- VAE Conv2d weight (out, in, kh, kw)     -> Conv kernel (kh, kw, in, out);
- GroupNorm weight/bias                   -> norm scale/bias.
Every step is a transpose or reshape, so the conversion is exact.

`to_scan_layout` (own copy of `f_lite_tpu/convert/torch_to_jax.py:279`)
restacks those unrolled blocks into the `scan_layers` layout, as the JAX
trainer's export under `--scan_layers` holds them.
"""

from __future__ import annotations

from typing import Mapping

import torch


def _cpu(t) -> torch.Tensor:
    return t.detach().cpu()


def _kernel(w: torch.Tensor, out_shape=None) -> torch.Tensor:
    """(N, in) -> (in, N), or (in, *out_shape) (transposed where it lies,
    then copied to the host)."""
    k = _cpu(w.detach().t().contiguous())
    return k if out_shape is None else k.reshape(k.shape[0], *out_shape)


def _dense(sd, name, key, out, out_shape=None) -> None:
    """A Linear or `QuantDense` layer; `out_shape` folds its N outputs
    (head-aligned kernels)."""
    if f"{name}.w8" in sd:
        out[f"{key}.w8"] = _kernel(sd[f"{name}.w8"], out_shape)
        scale = _cpu(sd[f"{name}.scale"])
        out[f"{key}.scale"] = scale if out_shape is None else scale.reshape(out_shape)
    else:
        out[f"{key}.kernel"] = _kernel(sd[f"{name}.weight"], out_shape)
    if f"{name}.bias" in sd:
        bias = _cpu(sd[f"{name}.bias"])
        out[f"{key}.bias"] = bias if out_shape is None else bias.reshape(out_shape)


def _head_dense(sd, name, key, split, cfg, out) -> None:
    _dense(sd, name, key, out, (*split, cfg.num_heads, cfg.head_dim))


def state_dict_to_jax(sd: Mapping[str, torch.Tensor], cfg) -> dict[str, torch.Tensor]:
    """The port's `DiT` state dict (float or quantized) -> flat JAX DiT
    params (unrolled layout), each in its dtype."""
    out: dict[str, torch.Tensor] = {}
    _dense(sd, "context_proj", "context_proj", out)
    out["context_norm.weight"] = _cpu(sd["context_norm.weight"])

    w = _cpu(sd["patch_embed.patch_proj.weight"])  # (D, C, p, p)
    out["patch_proj.kernel"] = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]).contiguous()
    out["patch_proj.bias"] = _cpu(sd["patch_embed.patch_proj.bias"])
    out["register_tokens"] = _cpu(sd["register_tokens"])
    if "positional_embedding" in sd:
        out["positional_embedding"] = _cpu(sd["positional_embedding"])

    _dense(sd, "time_embed.0", "time_embed.linear_1", out)
    _dense(sd, "time_embed.2", "time_embed.linear_2", out)
    if "adaLN_modulation.1.weight" in sd:
        _dense(sd, "adaLN_modulation.1", "adaLN_modulation.linear", out)

    for i in range(cfg.depth):
        b, j = f"blocks.{i}", f"blocks_{i}"
        out[f"{j}.norm1.weight"] = _cpu(sd[f"{b}.norm1.weight"])
        out[f"{j}.norm3.weight"] = _cpu(sd[f"{b}.norm3.weight"])
        _head_dense(sd, f"{b}.self_attn.qkv", f"{j}.self_attn.qkv", (3,), cfg, out)
        _dense(sd, f"{b}.self_attn.proj", f"{j}.self_attn.proj", out)
        if f"{b}.self_attn.lambda_v" in sd:
            out[f"{j}.self_attn.lambda_v"] = _cpu(sd[f"{b}.self_attn.lambda_v"])
        for name in ("gate_proj", "up_proj", "down_proj"):
            _dense(sd, f"{b}.mlp.{name}", f"{j}.mlp.{name}", out)
        if f"{b}.norm2.weight" in sd:
            out[f"{j}.norm2.weight"] = _cpu(sd[f"{b}.norm2.weight"])
            _head_dense(sd, f"{b}.cross_attn.q", f"{j}.cross_attn.q", (), cfg, out)
            _head_dense(sd, f"{b}.cross_attn.context_kv",
                        f"{j}.cross_attn.context_kv", (2,), cfg, out)
            _dense(sd, f"{b}.cross_attn.proj", f"{j}.cross_attn.proj", out)
        if f"{b}.adaLN_modulation.1.weight" in sd:
            _dense(sd, f"{b}.adaLN_modulation.1", f"{j}_adaLN.linear", out)

    _dense(sd, "final_modulation.1", "final_modulation.linear", out)
    if "final_norm.weight" in sd:
        out["final_norm.weight"] = _cpu(sd["final_norm.weight"])
    _dense(sd, "final_proj", "final_proj", out)
    return out


def _conv(sd, name, key, out) -> None:
    out[f"{key}.kernel"] = _cpu(sd[f"{name}.weight"]).permute(2, 3, 1, 0).contiguous()
    if f"{name}.bias" in sd:
        out[f"{key}.bias"] = _cpu(sd[f"{name}.bias"])


def _groupnorm(sd, name, key, out) -> None:
    out[f"{key}.norm.scale"] = _cpu(sd[f"{name}.weight"])
    out[f"{key}.norm.bias"] = _cpu(sd[f"{name}.bias"])


def _resnet(sd, name, key, out) -> None:
    for part in ("norm1", "norm2"):
        _groupnorm(sd, f"{name}.{part}", f"{key}.{part}", out)
    for part in ("conv1", "conv2", "conv_shortcut"):
        if f"{name}.{part}.weight" in sd:
            _conv(sd, f"{name}.{part}", f"{key}.{part}", out)


def _mid(sd, name, key, out) -> None:
    _resnet(sd, f"{name}.mid_block.resnets.0", f"{key}.mid_resnet_0", out)
    _resnet(sd, f"{name}.mid_block.resnets.1", f"{key}.mid_resnet_1", out)
    attn = f"{name}.mid_block.attentions.0"
    if f"{attn}.to_q.weight" in sd:
        _groupnorm(sd, f"{attn}.group_norm", f"{key}.mid_attn.group_norm", out)
        for part in ("to_q", "to_k", "to_v"):
            _dense(sd, f"{attn}.{part}", f"{key}.mid_attn.{part}", out)
        _dense(sd, f"{attn}.to_out.0", f"{key}.mid_attn.to_out", out)


def vae_state_dict_to_jax(sd: Mapping[str, torch.Tensor], cfg) -> dict[str, torch.Tensor]:
    """The port's `AutoencoderKL` state dict (diffusers names) -> flat JAX
    VAE params."""
    out: dict[str, torch.Tensor] = {}
    _conv(sd, "encoder.conv_in", "encoder.conv_in", out)
    for i in range(len(cfg.block_out_channels)):
        for j in range(cfg.layers_per_block):
            _resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}",
                    f"encoder.down_{i}_resnet_{j}", out)
        down = f"encoder.down_blocks.{i}.downsamplers.0.conv"
        if f"{down}.weight" in sd:
            _conv(sd, down, f"encoder.down_{i}_downsample", out)
    _mid(sd, "encoder", "encoder", out)
    _groupnorm(sd, "encoder.conv_norm_out", "encoder.conv_norm_out", out)
    _conv(sd, "encoder.conv_out", "encoder.conv_out", out)

    _conv(sd, "decoder.conv_in", "decoder.conv_in", out)
    _mid(sd, "decoder", "decoder", out)
    for i in range(len(cfg.block_out_channels)):
        for j in range(cfg.layers_per_block + 1):
            _resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}",
                    f"decoder.up_{i}_resnet_{j}", out)
        up = f"decoder.up_blocks.{i}.upsamplers.0.conv"
        if f"{up}.weight" in sd:
            _conv(sd, up, f"decoder.up_{i}_upsample", out)
    _groupnorm(sd, "decoder.conv_norm_out", "decoder.conv_norm_out", out)
    _conv(sd, "decoder.conv_out", "decoder.conv_out", out)
    return out


def to_scan_layout(flat: Mapping[str, torch.Tensor], cfg) -> dict[str, torch.Tensor]:
    """Flat unrolled DiT params (`state_dict_to_jax`'s) -> the `scan_layers`
    layout (JAX's `ScanUnit` trees): `blocks_all` (cross_attn_all, one
    block a unit) or v1's `blocks_front` (one a unit) and `blocks_rest`
    (`cross_attn_period` blocks a unit, `blk_{j}`), each leaf with a
    leading unit axis; per-block AdaLN heads as `blk_{j}_adaLN`. Under
    residual_v block 0, which has no lambda_v unrolled, gets a ones one
    (inert: the scan gates it)."""
    out = dict(flat)
    blocks: dict[int, dict] = {}
    for key in list(out):
        head, _, rest = key.partition(".")
        if head.startswith("blocks_"):
            idx, adaln = head[len("blocks_"):], head.endswith("_adaLN")
            i = int(idx[:-len("_adaLN")] if adaln else idx)
            blocks.setdefault(i, {})[("_adaLN." if adaln else ".") + rest] = out.pop(key)
    if cfg.residual_v and 0 in blocks and ".self_attn.lambda_v" not in blocks[0]:
        like = blocks[1][".self_attn.lambda_v"] if 1 in blocks else None
        blocks[0][".self_attn.lambda_v"] = torch.ones(
            1, dtype=torch.float32 if like is None else like.dtype)

    def stack(trunk, units):
        for j in range(len(units[0])):
            for leaf in blocks[units[0][j]]:
                out[f"{trunk}.blk_{j}{leaf}"] = torch.stack([blocks[u[j]][leaf]
                                                             for u in units])

    if cfg.cross_attn_all:
        stack("blocks_all", [[i] for i in range(cfg.depth)])
        return out
    first_n = min(cfg.cross_attn_first_n, cfg.depth)
    rest = cfg.depth - first_n
    if rest % cfg.cross_attn_period != 0:
        raise ValueError("scan layout requires (depth - first_n) % period == 0")
    stack("blocks_front", [[i] for i in range(first_n)])
    period = cfg.cross_attn_period
    units = [[first_n + u * period + j for j in range(period)]
             for u in range(rest // period)]
    if units:
        stack("blocks_rest", units)
    return out
