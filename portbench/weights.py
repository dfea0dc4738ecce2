"""Seeded weights of the benchmark's configurations, drawn on the device.

The names and shapes are the benchmark's own listing of an F-Lite DiT (v1,
shared AdaLN) and of the Flux VAE decoder, in the layout of the reference
torch state dicts; the port's modules load them with `strict=True`, so a
listing that drifts from the program fails at set-up. The values follow
one rule (a copy of `f_lite_tpu_torch/utils/random_weights.py`
`randomize_`): matrices and convolutions N(0, (0.5 / sqrt(fan_in))^2),
norm weights 1 + N(0, 0.05^2), other vectors N(0, 0.05^2), register tokens
N(0, 1), lambda_v U(0, 1). AdaLN and final heads are non-zero, or the
velocity would be exactly 0. One departure: the shared AdaLN head's bias
is N(0, 0.5^2). Under the 0.05 rule every gate is about 0.06, so each
block adds a few percent to the residual stream, the output is nearly the
patch path's, and a comparison cannot see the blocks' arithmetic (a
block computed in int4 moves the output about as little as bf16
rounding does); at 0.5 the blocks carry the output, and the text moves
the conditional velocity by about two thirds of its size.

All normal draws come from one `torch.randn` over every leaf at once, in
the dtype the weights are served in, and lambda_v from one `torch.rand`;
the same seed, device and dtype give the same tensors. The program and the
reference are handed the same draws.
"""

from __future__ import annotations

import math

import torch

# the projections that int8 W8A8 serving quantizes (`quant.py`'s targets)
QUANT_TARGETS = ("qkv", "proj", "q", "context_kv", "gate_proj", "up_proj",
                 "down_proj")


def has_cross_attn(cfg: dict, idx: int) -> bool:
    return idx % cfg["cross_attn_period"] == 0 or idx < cfg["cross_attn_first_n"]


def dit_specs(cfg: dict) -> list[tuple[str, tuple]]:
    """(name, shape) of every parameter of a v1 DiT with `cfg`'s sizes."""
    d, p, c = cfg["hidden_size"], cfg["patch_size"], cfg["in_channels"]
    inter = int(d * cfg["mlp_ratio"])
    specs = [("register_tokens", (1, cfg["n_register_tokens"], d)),
             ("context_proj.weight", (d, cfg["cross_attn_input_size"])),
             ("context_proj.bias", (d,)),
             ("context_norm.weight", (d,)),
             ("patch_embed.patch_proj.weight", (d, c, p, p)),
             ("patch_embed.patch_proj.bias", (d,)),
             ("time_embed.0.weight", (4 * d, d)), ("time_embed.0.bias", (4 * d,)),
             ("time_embed.2.weight", (d, 4 * d)), ("time_embed.2.bias", (d,)),
             ("adaLN_modulation.1.weight", (9 * d, d)),
             ("adaLN_modulation.1.bias", (9 * d,))]
    for i in range(cfg["depth"]):
        b = f"blocks.{i}."
        specs.append((b + "norm1.weight", (d,)))
        if cfg["residual_v"] and i > 0:
            specs.append((b + "self_attn.lambda_v", (1,)))
        specs += [(b + "self_attn.qkv.weight", (3 * d, d)),
                  (b + "self_attn.proj.weight", (d, d))]
        if has_cross_attn(cfg, i):
            specs += [(b + "norm2.weight", (d,)),
                      (b + "cross_attn.q.weight", (d, d)),
                      (b + "cross_attn.context_kv.weight", (2 * d, d)),
                      (b + "cross_attn.proj.weight", (d, d))]
        specs += [(b + "norm3.weight", (d,)),
                  (b + "mlp.gate_proj.weight", (inter, d)),
                  (b + "mlp.up_proj.weight", (inter, d)),
                  (b + "mlp.down_proj.weight", (d, inter))]
    specs += [("final_modulation.1.weight", (2 * d, d)),
              ("final_modulation.1.bias", (2 * d,)),
              ("final_proj.weight", (p * p * c, d)), ("final_proj.bias", (p * p * c,))]
    return specs


def _resnet(prefix: str, cin: int, cout: int) -> list:
    specs = [(prefix + "norm1.weight", (cin,)), (prefix + "norm1.bias", (cin,)),
             (prefix + "conv1.weight", (cout, cin, 3, 3)), (prefix + "conv1.bias", (cout,)),
             (prefix + "norm2.weight", (cout,)), (prefix + "norm2.bias", (cout,)),
             (prefix + "conv2.weight", (cout, cout, 3, 3)), (prefix + "conv2.bias", (cout,))]
    if cin != cout:
        specs += [(prefix + "conv_shortcut.weight", (cout, cin, 1, 1)),
                  (prefix + "conv_shortcut.bias", (cout,))]
    return specs


def vae_decoder_specs(vae: dict) -> list[tuple[str, tuple]]:
    """(name, shape) of every parameter of the Flux VAE's decoder (keys
    relative to `decoder.`)."""
    chans = list(reversed(vae["block_out_channels"]))
    top = chans[0]
    specs = [("conv_in.weight", (top, vae["latent_channels"], 3, 3)),
             ("conv_in.bias", (top,))]
    specs += _resnet("mid_block.resnets.0.", top, top)
    a = "mid_block.attentions.0."
    specs += [(a + "group_norm.weight", (top,)), (a + "group_norm.bias", (top,))]
    for name in ("to_q", "to_k", "to_v", "to_out.0"):
        specs += [(f"{a}{name}.weight", (top, top)), (f"{a}{name}.bias", (top,))]
    specs += _resnet("mid_block.resnets.1.", top, top)
    for i, ch in enumerate(chans):
        cin = chans[max(i - 1, 0)]
        for j in range(vae["layers_per_block"] + 1):
            specs += _resnet(f"up_blocks.{i}.resnets.{j}.", cin if j == 0 else ch, ch)
        if i < len(chans) - 1:
            specs += [(f"up_blocks.{i}.upsamplers.0.conv.weight", (ch, ch, 3, 3)),
                      (f"up_blocks.{i}.upsamplers.0.conv.bias", (ch,))]
    specs += [("conv_norm_out.weight", (chans[-1],)), ("conv_norm_out.bias", (chans[-1],)),
              ("conv_out.weight", (vae["out_channels"], chans[-1], 3, 3)),
              ("conv_out.bias", (vae["out_channels"],))]
    return specs


def draw(specs, seed: int, device, dtype) -> dict[str, torch.Tensor]:
    """The seeded tensors of `specs`, each in its own storage."""
    gen = torch.Generator(device).manual_seed(seed)
    normal = [(n, s) for n, s in specs if not n.endswith("lambda_v")]
    uniform = [(n, s) for n, s in specs if n.endswith("lambda_v")]
    total = sum(math.prod(s) for _, s in normal)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    lam = torch.rand(sum(math.prod(s) for _, s in uniform), generator=gen,
                     device=device, dtype=dtype)
    out = {}
    offset = 0
    for name, shape in normal:
        n = math.prod(shape)
        val = flat[offset:offset + n].view(shape)
        offset += n
        if name == "register_tokens":
            pass
        elif len(shape) >= 2:
            val.mul_(0.5 / math.sqrt(math.prod(shape[1:])))
        elif name == "adaLN_modulation.1.bias":
            val.mul_(0.5)
        elif "norm" in name and name.endswith("weight"):
            val.mul_(0.05).add_(1.0)
        else:
            val.mul_(0.05)
        out[name] = val.clone()
    del flat
    offset = 0
    for name, shape in uniform:
        n = math.prod(shape)
        out[name] = lam[offset:offset + n].view(shape).clone()
        offset += n
    return {name: out[name] for name, _ in specs}


def dit_weights(cfg: dict, seed: int, device, dtype) -> dict[str, torch.Tensor]:
    return draw(dit_specs(cfg), derive(seed, "dit"), device, dtype)


def vae_decoder_weights(vae: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """fp32, as the VAE is served."""
    return draw(vae_decoder_specs(vae), derive(seed, "vae"), device, torch.float32)


_STREAMS = {"dit": 1, "vae": 2, "request": 3, "batch": 4, "check": 5}


def seeded_order(items: list, seed: int, stream: str) -> list:
    """`items` in an order drawn from the seed: every seed gets the same
    set of sizes, in its own order."""
    gen = torch.Generator().manual_seed(derive(seed, stream, 10**9))
    return [items[i] for i in torch.randperm(len(items), generator=gen).tolist()]


def derive(seed: int, stream: str, index: int = 0) -> int:
    """A generator seed for one stream of draws (weights, a request's
    inputs, a step's batch, the check's sample) of run seed `seed`: distinct
    streams and indices give distinct seeds, within 63 bits."""
    return (int(seed) * 1_000_003 + _STREAMS[stream] * 65_537 + index) % (2**63 - 1)
