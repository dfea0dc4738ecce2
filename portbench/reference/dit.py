"""The F-Lite DiT (v1: one AdaLN head shared by every block) in float32.

forward(w, cfg, x, context, mask, t) -> velocity, with x (B, H, W, C)
NHWC latents, context (B, S, Ctx) text rows, mask (B, S) bool (True = a
real row) and t (B,) in [0, 1]. `w` maps the reference state-dict names of
`portbench.weights.dit_specs` to tensors; `precision` picks how it
computes: "fp32"; "int8" / "int4", the large projections
(`weights.QUANT_TARGETS`) through symmetric W8A8 / W4A4 integers
(`quant.int_linear`); "fp8", every product's inputs and output, the
attention's q, k, v and probabilities and the residual stream after every
addition rounded to float8 e4m3 (each row scaled to the format's largest
value, `quant.fp8`), with the plain gradient.

The model, as published:
- context: Linear(Ctx -> D), then RMSNorm with a weight;
- patches (p x p x C, in (row, column, channel) order) -> Linear(D),
  behind `n_register_tokens` learned register tokens;
- time: sinusoidal embedding of 1000 t ([cos | sin], period 10^4), then
  Linear(4D), SiLU, Linear(D); the shared modulation is Linear(9D) of
  SiLU(time), split into (shift, scale, gate) for self-attention,
  cross-attention and the MLP;
- each block: x += gate * SelfAttn(RMSNorm(x) (1 + scale) + shift); in
  the blocks idx % period == 0 or idx < first_n, the same with
  cross-attention over the context; then the SwiGLU MLP
  down(silu(gate(h)) * up(h)), each norm with its own weight;
- attention: heads of D / num_heads; 2-D rotary embedding (rotate-half,
  rows then columns, identity on the registers) on q and k of
  self-attention, then a weightless RMSNorm on q and k, softmax scaled by
  head_dim^-1/2; residual_v: block 0's values v1, later blocks mix
  lambda v + (1 - lambda) v1 (before the norm, values are not normed);
  the context's padding rows are masked out of the keys;
- final: the registers dropped, a weightless RMSNorm, a shift and scale
  from Linear(2D) of SiLU(time), Linear(p p C), unpatchified.
RMSNorm's epsilon is 1e-6.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.quant import LEVELS, fp8, int_linear
from portbench.weights import has_cross_attn


def rms_norm(x, weight=None, eps: float = 1e-6):
    y = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)
    return y if weight is None else y * weight


def rope_tables(head_dim: int, gh: int, gw: int, n_reg: int, base: float, device):
    """cos, sin (n_reg + gh*gw, head_dim / 2): the row frequencies then
    the column ones of each position, identity rows for the registers."""
    half = head_dim // 2
    inv = 1.0 / base ** (torch.arange(0, half, 2, device=device, dtype=torch.float32) / half)
    rows = torch.arange(gh, device=device, dtype=torch.float32)[:, None, None] * inv
    cols = torch.arange(gw, device=device, dtype=torch.float32)[None, :, None] * inv
    ang = torch.cat([rows.expand(gh, gw, -1), cols.expand(gh, gw, -1)], -1)
    ang = torch.cat([torch.zeros(n_reg, half, device=device), ang.reshape(gh * gw, half)])
    return torch.cos(ang), torch.sin(ang)


def rotate(x, cos, sin):
    half = x.shape[-1] // 2
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos + b * sin, b * cos - a * sin], -1)


def attend(q, k, v, key_mask, scale, held=lambda p: p):
    """q (B, H, L, d), k and v (B, H, S, d); key_mask (B, S) or None;
    `held` rounds the probabilities as the computation holds them."""
    logits = (q @ k.transpose(-1, -2)) * scale
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], float("-inf"))
    return held(torch.softmax(logits, -1)) @ v


def time_embedding(t, dim: int):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device,
                                                         dtype=torch.float32) / half)
    ang = (t.float() * 1000.0)[:, None] * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], -1)


def patchify(x, p):
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def unpatchify(tok, gh, gw, p, c):
    b = tok.shape[0]
    x = tok.reshape(b, gh, gw, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * p, gw * p, c)


class ReferenceDiT:
    """The model over `w`; `remat` recomputes each block in the backward
    (to fit a training step's float32 activations)."""

    def __init__(self, w: dict, cfg: dict, precision: str = "fp32", remat: bool = False):
        self.w, self.cfg, self.precision, self.remat = w, cfg, precision, remat

    def r(self, x):
        """x as the computation holds it: rounded to fp8 under "fp8"."""
        return fp8(x) if self.precision == "fp8" else x

    def linear(self, name, x, quantizable=False):
        w = self.w[name + ".weight"]
        b = self.w.get(name + ".bias")
        if quantizable and self.precision in LEVELS:
            return int_linear(x, w, b, LEVELS[self.precision])
        return self.r(F.linear(self.r(x), self.r(w), b))

    def attention(self, prefix, x, rope, context=None, key_mask=None, v_first=None):
        cfg = self.cfg
        heads, d = cfg["num_heads"], cfg["hidden_size"] // cfg["num_heads"]
        b, n = x.shape[:2]
        if context is None:
            qkv = self.linear(prefix + "qkv", x, True).reshape(b, n, 3, heads, d)
            q, k, v = qkv.permute(2, 0, 3, 1, 4)
            q, k = rotate(q, *rope), rotate(k, *rope)
            if cfg["residual_v"]:
                if v_first is None:
                    v_first = v
                else:
                    lam = self.w[prefix + "lambda_v"]
                    v = lam * v + (1.0 - lam) * v_first
        else:
            q = self.linear(prefix + "q", x, True).reshape(b, n, heads, d).transpose(1, 2)
            kv = self.linear(prefix + "context_kv", context, True)
            k, v = kv.reshape(b, context.shape[1], 2, heads, d).permute(2, 0, 3, 1, 4)
        out = attend(self.r(rms_norm(q)), self.r(rms_norm(k)), self.r(v), key_mask,
                     d ** -0.5, self.r)
        out = out.transpose(1, 2).reshape(b, n, heads * d)
        return self.linear(prefix + "proj", out, True), v_first

    def block(self, i, x, context, key_mask, mod, rope, v_first):
        w, p = self.w, f"blocks.{i}."
        (sh_sa, sc_sa, g_sa, sh_ca, sc_ca, g_ca, sh_m, sc_m, g_m) = mod.unbind(1)
        h = rms_norm(x, w[p + "norm1.weight"]) * (1 + sc_sa) + sh_sa
        a, v_first = self.attention(p + "self_attn.", h, rope, v_first=v_first)
        x = self.r(x + a * g_sa)
        if has_cross_attn(self.cfg, i):
            h = rms_norm(x, w[p + "norm2.weight"]) * (1 + sc_ca) + sh_ca
            a, _ = self.attention(p + "cross_attn.", h, rope, context, key_mask)
            x = self.r(x + a * g_ca)
        h = rms_norm(x, w[p + "norm3.weight"]) * (1 + sc_m) + sh_m
        m = self.linear(p + "mlp.down_proj",
                        F.silu(self.linear(p + "mlp.gate_proj", h, True))
                        * self.linear(p + "mlp.up_proj", h, True), True)
        return self.r(x + m * g_m), v_first

    def __call__(self, x, context, mask, t):
        cfg, w = self.cfg, self.w
        d, p, c = cfg["hidden_size"], cfg["patch_size"], cfg["in_channels"]
        nreg = cfg["n_register_tokens"]
        b, hh, ww, _ = x.shape
        gh, gw = hh // p, ww // p
        ctx = rms_norm(self.linear("context_proj", context.float()),
                       w["context_norm.weight"])
        pw = w["patch_embed.patch_proj.weight"].permute(0, 2, 3, 1).reshape(d, -1)
        tok = F.linear(patchify(x.float(), p), pw, w["patch_embed.patch_proj.bias"])
        tok = torch.cat([w["register_tokens"].expand(b, -1, -1), tok], 1)
        rope = rope_tables(d // cfg["num_heads"], gh, gw, nreg, cfg["rope_base"], x.device)
        temb = self.linear("time_embed.2", F.silu(self.linear(
            "time_embed.0", time_embedding(t, d))))
        mod = self.linear("adaLN_modulation.1", F.silu(temb)).reshape(b, 9, 1, d)
        v_first = None
        for i in range(cfg["depth"]):
            if self.remat and torch.is_grad_enabled():
                tok, v_first = checkpoint(self.block, i, tok, ctx, mask, mod, rope,
                                          v_first, use_reentrant=False)
            else:
                tok, v_first = self.block(i, tok, ctx, mask, mod, rope, v_first)
        fm = self.linear("final_modulation.1", F.silu(temb)).reshape(b, 2, 1, d)
        tok = rms_norm(tok[:, nreg:]) * (1 + fm[:, 1]) + fm[:, 0]
        return unpatchify(self.linear("final_proj", tok), gh, gw, p, c)
