"""F-Lite DiT in PyTorch (counterpart of `f_lite_tpu/models/dit.py`).

Unrolled blocks only. Module and parameter names follow the reference torch
state dict (the key set of `invert_dit_params`), so a released `.pt`
checkpoint loads with `strict=True`. Latents are NHWC at the public
boundary, as in the JAX package.

Covered: v1 shared AdaLN with the `idx % period == 0 or idx < first_n`
cross-attention pattern, v2 per-block AdaLN with cross-attention in every
block, `residual_v` (block 0 emits its V, later blocks mix it in through
`lambda_v`), register tokens, the non-trainable QK-RMSNorm,
`dynamic_softmax_temperature`, and `train_bias_and_rms`. The attention goes
through `ops.attention.attention`, i.e. the Hopper kernels on the card.

Training as the JAX package does it: `DiTConfig.dtype` is the compute dtype
(None = the parameters' own), and every layer casts its weights to the
activations' dtype, as flax's `dtype` over `param_dtype` does (fp32 master
weights computing in bf16); `gradient_checkpoint` recomputes the blocks from
`gradient_checkpoint_from` on in the backward (`remat_policy` "full");
`init_weights` draws the JAX initializers.

Int8 serving (`quantized=True`, `f_lite_tpu_torch/quant.py`): the
`QUANT_TARGETS` projections are `QuantDense` layers (int8 weights, fp32
scales, per-token activation quantization; the Hopper int8 kernels on the
card); every other layer stays as it is.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from f_lite_tpu_torch.ops.attention import attention, compact_context
from f_lite_tpu_torch.ops.norms import rms_norm
from f_lite_tpu_torch.ops.patching import patchify, unpatchify
from f_lite_tpu_torch.ops.rope import apply_rotary, rope_2d_freqs
from f_lite_tpu_torch.ops.timesteps import timestep_embedding
from f_lite_tpu_torch.quant import QUANT_TARGETS, quant_matmul


# `dit/config.json` fields that shape only the JAX program or the saved
# parameter layout (scan-stacked, pipeline-parallel, head-padded; undone at
# load by `convert.from_jax.state_dict_from_jax`): ignored here
_PROGRAM_ONLY = {"pipeline_microbatches": 1, "use_pallas_attention": None,
                 "scan_layers": False, "pipeline_stages": 1,
                 "padded_heads": None}
# lecun_normal: a normal of variance 1/fan_in truncated at two standard
# deviations, widened so that the truncated variance is 1/fan_in
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """The architecture fields of the JAX package's `DiTConfig`."""

    in_channels: int = 16
    patch_size: int = 2
    hidden_size: int = 3072
    depth: int = 40
    num_heads: int = 12
    mlp_ratio: float = 4.0
    cross_attn_input_size: int = 4096
    train_bias_and_rms: bool = False
    use_rope: bool = True
    rope_base: float = 10000.0
    dynamic_softmax_temperature: bool = False
    residual_v: bool = False
    adaln_mode: str = "shared"  # "shared" (v1) | "per_block" (v2)
    cross_attn_period: int = 4  # cross-attn when idx % period == 0 ...
    cross_attn_first_n: int = 8  # ... or idx < first_n
    cross_attn_all: bool = False  # v2: every block
    n_register_tokens: int = 16
    pos_embed_max_len: int = 2048  # only when use_rope=False
    gradient_checkpoint: bool = False
    gradient_checkpoint_from: int = 8  # recompute blocks >= this
    remat_policy: str = "full"  # "full": keep block inputs only
    quantized: bool = False  # int8 W8A8 projections (inference)
    dtype: torch.dtype | None = None  # compute dtype; None = param dtype

    def __post_init__(self):
        if self.adaln_mode not in ("shared", "per_block"):
            raise ValueError(f"adaln_mode {self.adaln_mode!r}")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy {self.remat_policy!r}")

    @classmethod
    def from_json_dict(cls, d: dict) -> "DiTConfig":
        """Parse a saved `dit/config.json`; the parameter layout fields are
        accepted (the port runs unrolled blocks at `num_heads`)."""
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields - set(_PROGRAM_ONLY)
        if unknown:
            raise ValueError(f"DiTConfig: unknown fields {sorted(unknown)}")
        return cls(**{k: v for k, v in d.items() if k in fields})

    def to_json_dict(self) -> dict:
        """`dit/config.json` as the JAX package writes it: every field of
        its DiTConfig but the dtypes, the ones the port lacks at their
        defaults."""
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
             if f.name != "dtype"}
        d.update(_PROGRAM_ONLY)
        return d

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def block_has_cross_attn(self, idx: int) -> bool:
        if self.cross_attn_all:
            return True
        return idx % self.cross_attn_period == 0 or idx < self.cross_attn_first_n

    @classmethod
    def f_lite_7b(cls, **overrides) -> "DiTConfig":
        """F-Lite-7B: hidden 2560, 40 blocks, 10 heads of 256, residual_v."""
        kw = dict(hidden_size=2560, depth=40, num_heads=10, residual_v=True)
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def f_lite_10b(cls, **overrides) -> "DiTConfig":
        """F-Lite 10B: hidden 3072, 40 blocks, 12 heads of 256, residual_v."""
        kw = dict(hidden_size=3072, depth=40, num_heads=12, residual_v=True)
        kw.update(overrides)
        return cls(**kw)


class Dense(nn.Linear):
    """nn.Linear that computes in its input's dtype: weight and bias are
    cast to it inside the layer (flax's `dtype` over `param_dtype`)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class QuantDense(nn.Module):
    """Int8 W8A8 Dense (`f_lite_tpu/models/dit.py` QuantDense / HeadProj):
    buffers w8 (N, K) int8 and scale (N,) fp32, an optional bias; forward
    is `quant.quant_matmul`, output in the input's dtype. The scales stay
    fp32 through `.to(dtype)`. Made by `quant.quantize_dit` or loaded from
    a quantized state dict; the zero weights here are placeholders."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.register_buffer(
            "w8", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    @classmethod
    def from_quantized(cls, w8, scale, bias=None) -> "QuantDense":
        """A layer holding w8, scale and bias themselves (no copy)."""
        with torch.device("meta"):
            layer = cls(w8.shape[1], w8.shape[0], bias=False)
        layer.w8, layer.scale, layer.bias = w8, scale, bias
        return layer

    def _apply(self, fn, recurse=True):
        scale = self.scale
        super()._apply(fn, recurse)
        if self.scale.dtype != torch.float32:  # a cast: keep the fp32 scales
            self.scale = scale.to(self.scale.device)
        return self

    def forward(self, x):
        return quant_matmul(x, self.w8, self.scale, self.bias)


def _linear(cfg: "DiTConfig", name: str, d_in: int, d_out: int,
            bias: bool) -> nn.Module:
    """The projection `name`: QuantDense where the config is quantized and
    `name` is one of QUANT_TARGETS, else Dense."""
    if cfg.quantized and name in QUANT_TARGETS:
        return QuantDense(d_in, d_out, bias=bias)
    return Dense(d_in, d_out, bias=bias)


class RMSNormModule(nn.Module):
    """RMSNorm with a learnable weight, fp32 statistics."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return rms_norm(x, self.weight)


class Attention(nn.Module):
    """Self- or cross-attention. Order of ops as in the JAX package: rope,
    then the dynamic temperature on k, then the non-trainable QK-RMSNorm,
    then the attention kernel, then the bias-free out projection."""

    def __init__(self, cfg: DiTConfig, *, is_self_attn: bool,
                 has_lambda_v: bool = False):
        super().__init__()
        self.cfg = cfg
        self.is_self_attn = is_self_attn
        d, bias = cfg.hidden_size, cfg.train_bias_and_rms
        if is_self_attn:
            self.qkv = _linear(cfg, "qkv", d, 3 * d, bias)
        else:
            self.q = _linear(cfg, "q", d, d, bias)
            self.context_kv = _linear(cfg, "context_kv", d, 2 * d, bias)
        self.proj = _linear(cfg, "proj", d, d, False)
        if has_lambda_v:
            self.lambda_v = nn.Parameter(torch.full((1,), 0.5))

    def forward(self, x, *, context=None, context_mask=None, rope=None,
                v_first=None):
        cfg = self.cfg
        h, d = cfg.num_heads, cfg.head_dim
        b, lq = x.shape[:2]
        if self.is_self_attn:
            qkv = self.qkv(x).reshape(b, lq, 3, h, d).permute(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1], qkv[2]  # (B, H, L, D)
            if rope is not None:
                cos, sin = rope
                q = apply_rotary(q, cos, sin)
                k = apply_rotary(k, cos, sin)
                if cfg.dynamic_softmax_temperature:
                    ratio = math.sqrt(math.log(lq) / math.log(1040.0))
                    k = k * torch.tensor(ratio, dtype=k.dtype)
            kv_mask = None
        else:
            lk = context.shape[1]
            q = self.q(x).reshape(b, lq, h, d).transpose(1, 2)
            kv = self.context_kv(context).reshape(b, lk, 2, h, d)
            kv = kv.permute(2, 0, 3, 1, 4)
            k, v = kv[0], kv[1]
            kv_mask = context_mask

        v_first_out = v_first
        if cfg.residual_v and self.is_self_attn:
            if v_first is None:
                v_first_out = v
            else:
                lamb = self.lambda_v.to(v.dtype)
                v = lamb * v + (1.0 - lamb) * v_first

        q = rms_norm(q)
        k = rms_norm(k)
        out = attention(q, k, v, kv_mask=kv_mask, scale=d**-0.5)
        out = self.proj(out.transpose(1, 2).reshape(b, lq, h * d))
        return out, v_first_out


class SwiGLUMLP(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        d, inter = cfg.hidden_size, int(cfg.hidden_size * cfg.mlp_ratio)
        self.gate_proj = _linear(cfg, "gate_proj", d, inter, False)
        self.up_proj = _linear(cfg, "up_proj", d, inter, False)
        self.down_proj = _linear(cfg, "down_proj", inter, d, False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


def _adaln_head(d: int, n: int) -> nn.Sequential:
    """SiLU -> Linear(d, n*d); keys `<name>.1.weight/bias`."""
    return nn.Sequential(nn.SiLU(), Dense(d, n * d))


class DiTBlock(nn.Module):
    """Pre-RMSNorm AdaLN block: self-attention, optional cross-attention,
    SwiGLU MLP. `modulation` (B, 9, D) holds (shift, scale, gate) for
    (self-attention, cross-attention, MLP)."""

    def __init__(self, cfg: DiTConfig, idx: int):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.do_cross_attn = cfg.block_has_cross_attn(idx)
        self.norm1 = RMSNormModule(d)
        self.self_attn = Attention(
            cfg, is_self_attn=True, has_lambda_v=cfg.residual_v and idx > 0
        )
        if self.do_cross_attn:
            self.norm2 = RMSNormModule(d)
            self.cross_attn = Attention(cfg, is_self_attn=False)
        self.norm3 = RMSNormModule(d)
        self.mlp = SwiGLUMLP(cfg)
        if cfg.adaln_mode == "per_block":
            self.adaLN_modulation = _adaln_head(d, 9)

    def forward(self, x, context, context_mask, modulation, rope,
                v_first=None):
        m = modulation[:, :, None, :].to(x.dtype).unbind(1)
        (shift_sa, scale_sa, gate_sa, shift_ca, scale_ca, gate_ca,
         shift_mlp, scale_mlp, gate_mlp) = m

        norm_x = self.norm1(x) * (1 + scale_sa) + shift_sa
        attn_out, v_first = self.self_attn(norm_x, rope=rope, v_first=v_first)
        x = x + attn_out * gate_sa
        if self.do_cross_attn:
            norm_x = self.norm2(x) * (1 + scale_ca) + shift_ca
            ca, _ = self.cross_attn(norm_x, context=context,
                                    context_mask=context_mask)
            x = x + ca * gate_ca
        norm_x = self.norm3(x) * (1 + scale_mlp) + shift_mlp
        x = x + self.mlp(norm_x) * gate_mlp
        return x, v_first


class PatchEmbed(nn.Module):
    """The reference's Conv2d patch embed, computed as patchify + matmul:
    the conv weight (D, C, p, p) read in the patches' (ki, kj, c) order."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        p, c, d = cfg.patch_size, cfg.in_channels, cfg.hidden_size
        self.patch_proj = nn.Conv2d(c, d, kernel_size=p, stride=p)

    def forward(self, tokens):
        w = self.patch_proj.weight.to(tokens.dtype)  # (D, C, p, p)
        w = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)
        return F.linear(tokens, w, self.patch_proj.bias.to(tokens.dtype))


class DiT(nn.Module):
    """The denoiser: forward(x (B,H,W,C), context (B,S,Ctx), context_mask
    (B,S) bool or None, t (B,)) -> velocity (B,H,W,C), all NHWC."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.config = cfg
        d = cfg.hidden_size
        self.context_proj = Dense(cfg.cross_attn_input_size, d)
        self.context_norm = RMSNormModule(d)
        self.patch_embed = PatchEmbed(cfg)
        self.register_tokens = nn.Parameter(
            torch.zeros(1, cfg.n_register_tokens, d)
        )
        if not cfg.use_rope:
            self.positional_embedding = nn.Parameter(
                torch.zeros(1, cfg.pos_embed_max_len, d)
            )
        self.time_embed = nn.Sequential(
            Dense(d, 4 * d), nn.SiLU(), Dense(4 * d, d)
        )
        if cfg.adaln_mode == "shared":
            self.adaLN_modulation = _adaln_head(d, 9)
        self.blocks = nn.ModuleList(DiTBlock(cfg, i) for i in range(cfg.depth))
        self.final_modulation = _adaln_head(d, 2)
        if cfg.train_bias_and_rms:
            self.final_norm = RMSNormModule(d)
        self.final_proj = Dense(d, cfg.patch_size**2 * cfg.in_channels)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: `config.dtype`, else the parameters'."""
        return self.config.dtype or self.context_proj.weight.dtype

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DiT":
        """The JAX package's initializers, drawn from `generator` (on the
        parameters' device): lecun_normal kernels (truncated normal,
        fan_in = in_features) with zero biases; zero AdaLN heads and
        final_proj, so a fresh DiT outputs exactly 0; N(0, 1) registers;
        zero positional table; lambda_v 0.5; norm weights 1."""
        zero_heads = {"adaLN_modulation", "final_modulation", "final_proj"}
        for name, mod in self.named_modules():
            if isinstance(mod, RMSNormModule):
                mod.weight.fill_(1.0)
            elif isinstance(mod, (nn.Linear, nn.Conv2d)):
                w = mod.weight
                if zero_heads & set(name.split(".")):
                    w.zero_()
                else:
                    std = math.sqrt(1.0 / math.prod(w.shape[1:])) / _TRUNC_STD
                    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                          generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, Attention) and hasattr(mod, "lambda_v"):
                mod.lambda_v.fill_(0.5)
        self.register_tokens.normal_(0.0, 1.0, generator=generator)
        if not self.config.use_rope:
            self.positional_embedding.zero_()
        return self

    def forward(self, x, context, context_mask, t):
        cfg = self.config
        dtype = self.dtype
        b, height, width, _ = x.shape
        gh, gw = height // cfg.patch_size, width // cfg.patch_size
        d = cfg.hidden_size

        if context_mask is not None:
            context, context_mask = compact_context(context, context_mask)
        context = self.context_norm(self.context_proj(context.to(dtype)))

        tokens = self.patch_embed(patchify(x.to(dtype), cfg.patch_size))
        reg = self.register_tokens.to(dtype).expand(b, -1, -1)
        tokens = torch.cat([reg, tokens], dim=1)

        if cfg.use_rope:
            rope = rope_2d_freqs(
                cfg.head_dim, gh, gw, base=cfg.rope_base,
                n_register_tokens=cfg.n_register_tokens, device=x.device,
            )
        else:
            pos = self.positional_embedding[:, : tokens.shape[1], :]
            tokens = tokens + pos.to(dtype)
            rope = None

        emb = timestep_embedding(t * 1000.0, d).to(dtype)
        t_emb = self.time_embed(emb)
        if cfg.adaln_mode == "shared":
            modulation = self.adaLN_modulation(t_emb).reshape(b, 9, d)

        remat = cfg.gradient_checkpoint and torch.is_grad_enabled()
        if remat and cfg.remat_policy != "full":
            raise NotImplementedError(
                f"remat_policy {cfg.remat_policy!r} is not ported yet")
        v_first = None
        for idx, block in enumerate(self.blocks):
            if cfg.adaln_mode == "per_block":
                modulation = block.adaLN_modulation(t_emb).reshape(b, 9, d)
            args = (tokens, context, context_mask, modulation, rope, v_first)
            if remat and idx >= cfg.gradient_checkpoint_from:
                # keep the block's inputs only; the backward runs the block
                # again under grad mode (so attention saves its lse again)
                tokens, v_first = checkpoint(block, *args, use_reentrant=False)
            else:
                tokens, v_first = block(*args)

        # drop registers; final modulation + projection
        tokens = tokens[:, cfg.n_register_tokens:, :]
        final_mod = self.final_modulation(t_emb).reshape(b, 2, d)
        shift = final_mod[:, 0][:, None, :].to(dtype)
        scale = final_mod[:, 1][:, None, :].to(dtype)
        if cfg.train_bias_and_rms:
            tokens = self.final_norm(tokens)
        else:
            tokens = rms_norm(tokens)
        tokens = self.final_proj(tokens * (1 + scale) + shift)
        return unpatchify(tokens, gh, gw, cfg.patch_size, cfg.in_channels)
