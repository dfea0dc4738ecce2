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
`remat_policy` "dots" also keeps the blocks' weight products and recomputes
the rest (JAX's `dots_with_no_batch_dims_saveable`, through selective
checkpointing); `token_indices` runs a subset of the patch tokens (sequence
dropout); `init_weights` draws the JAX initializers.

Int8 serving (`quantized=True`, `f_lite_tpu_torch/quant.py`): the
`QUANT_TARGETS` projections are `QuantDense` layers (int8 weights, fp32
scales, per-token activation quantization; the Hopper int8 kernels on the
card); every other layer stays as it is.

Head padding (`padded_heads`, JAX's `DiTConfig.padded_heads`): attention
computes with `compute_heads` heads, the extra ones zero (their q/k/v rows
and bias and their `proj` input columns are zero: `convert.heads`), so a
tensor-parallel degree that does not divide `num_heads` still splits the
heads evenly. `head_dim` and the softmax scale stay those of `num_heads`.

Tensor and sequence parallelism (`parallel/tensor.py` `parallelize_dit`):
the parameters become DTensors on the tp mesh, and every layer computes on
its local shard (`parallel.sharding.local`), so no DTensor reaches a
kernel. `Attention` reshapes by its local head count, read from the
projection's output width. The collectives sit where JAX's `_constrain`
hints sit: the modules call `parallel.tensor` on entering the
column-parallel products and on leaving the row-parallel ones, and the DiT
splits the residual stream over the tp ranks along L under sequence
parallelism (`seq`) and gathers it whole for the final layer.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from f_lite_tpu_torch.ops.attention import attention, compact_context
from f_lite_tpu_torch.ops.norms import rms_norm
from f_lite_tpu_torch.ops.patching import patchify, unpatchify
from f_lite_tpu_torch.ops.rope import apply_rotary, rope_2d_freqs
from f_lite_tpu_torch.ops.timesteps import timestep_embedding
from f_lite_tpu_torch.parallel import tensor as tpar
from f_lite_tpu_torch.parallel.sharding import local as _local
from f_lite_tpu_torch.quant import QUANT_TARGETS, quant_matmul
from f_lite_tpu_torch.utils.random_weights import lecun_normal_
from f_lite_tpu_torch.utils.trace import span


# `dit/config.json` fields that shape only the JAX program or the saved
# parameter layout (scan-stacked, pipeline-parallel, head-padded; undone at
# load by `convert.from_jax.state_dict_from_jax`): ignored when a saved
# config is read, and written at these values (`padded_heads` is set at
# load, `FLitePipeline.from_pretrained(pad_heads_to=)`)
_PROGRAM_ONLY = {"pipeline_microbatches": 1, "use_pallas_attention": None,
                 "scan_layers": False, "pipeline_stages": 1,
                 "padded_heads": None}


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
    remat_policy: str = "full"  # "full": keep block inputs; "dots": + products
    quantized: bool = False  # int8 W8A8 projections (inference)
    padded_heads: int | None = None  # attention heads computed (>= num_heads)
    dtype: torch.dtype | None = None  # compute dtype; None = param dtype

    def __post_init__(self):
        if self.adaln_mode not in ("shared", "per_block"):
            raise ValueError(f"adaln_mode {self.adaln_mode!r}")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy {self.remat_policy!r}")
        if self.padded_heads is not None and self.padded_heads < self.num_heads:
            raise ValueError("padded_heads must be >= num_heads")

    @classmethod
    def from_json_dict(cls, d: dict) -> "DiTConfig":
        """Parse a saved `dit/config.json`; the parameter layout fields are
        accepted (the port runs unrolled blocks at `num_heads`)."""
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields - set(_PROGRAM_ONLY)
        if unknown:
            raise ValueError(f"DiTConfig: unknown fields {sorted(unknown)}")
        return cls(**{k: v for k, v in d.items()
                      if k in fields and k not in _PROGRAM_ONLY})

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

    @property
    def compute_heads(self) -> int:
        """The heads attention computes with: `padded_heads`, else
        `num_heads`."""
        return self.padded_heads or self.num_heads

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
        bias = None if self.bias is None else _local(self.bias).to(x.dtype)
        return F.linear(x, _local(self.weight).to(x.dtype), bias)


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

    # set by `parallel.tensor.parallelize_dit` on the row-parallel layers:
    # their K is split over the tp ranks, and each row's amax is the whole
    # K's (taken over the group)
    tp_amax = None

    def forward(self, x):
        return quant_matmul(x, _local(self.w8), _local(self.scale),
                            None if self.bias is None else _local(self.bias),
                            amax_group=self.tp_amax)


def _linear(cfg: "DiTConfig", name: str, d_in: int, d_out: int,
            bias: bool) -> nn.Module:
    """The projection `name`: QuantDense where the config is quantized and
    `name` is one of QUANT_TARGETS, else Dense."""
    if cfg.quantized and name in QUANT_TARGETS:
        return QuantDense(d_in, d_out, bias=bias)
    return Dense(d_in, d_out, bias=bias)


class RMSNormModule(nn.Module):
    """RMSNorm with a learnable weight, fp32 statistics. `tp`: the rows are
    this rank's share of the sequence, so the weight's gradient is summed
    over the tp group (`parallel.tensor.copy_to_tp`)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x, tp=None):
        w = _local(self.weight)
        return rms_norm(x, w if tp is None else tpar.copy_to_tp(w, tp))


class Attention(nn.Module):
    """Self- or cross-attention. Order of ops as in the JAX package: rope,
    then the dynamic temperature on k, then the non-trainable QK-RMSNorm,
    then the attention kernel, then the bias-free out projection."""

    tp = None  # parallel.tensor.TPContext, set by parallelize_dit

    def __init__(self, cfg: DiTConfig, *, is_self_attn: bool,
                 has_lambda_v: bool = False):
        super().__init__()
        self.cfg = cfg
        self.is_self_attn = is_self_attn
        d, bias = cfg.hidden_size, cfg.train_bias_and_rms
        hd = cfg.compute_heads * cfg.head_dim  # d, or wider with padded heads
        if is_self_attn:
            self.qkv = _linear(cfg, "qkv", d, 3 * hd, bias)
        else:
            self.q = _linear(cfg, "q", d, hd, bias)
            self.context_kv = _linear(cfg, "context_kv", d, 2 * hd, bias)
        self.proj = _linear(cfg, "proj", hd, d, False)
        if has_lambda_v:
            self.lambda_v = nn.Parameter(torch.full((1,), 0.5))

    def forward(self, x, *, context=None, context_mask=None, rope=None,
                v_first=None, seq=False):
        """`seq`: x is this rank's share of the sequence (sequence
        parallelism); the output is too."""
        cfg, tp = self.cfg, self.tp
        d = cfg.head_dim
        if tp is not None:
            x = tpar.enter_columns(x, tp, seq)
        b, lq = x.shape[:2]
        if self.is_self_attn:
            qkv = self.qkv(x)
            h = qkv.shape[-1] // (3 * d)  # this rank's heads
            qkv = qkv.reshape(b, lq, 3, h, d).permute(2, 0, 3, 1, 4)
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
            if tp is not None:
                context = tpar.copy_to_tp(context, tp)
            q = self.q(x)
            h = q.shape[-1] // d
            q = q.reshape(b, lq, h, d).transpose(1, 2)
            kv = self.context_kv(context).reshape(b, lk, 2, h, d)
            kv = kv.permute(2, 0, 3, 1, 4)
            k, v = kv[0], kv[1]
            kv_mask = context_mask

        v_first_out = v_first
        if cfg.residual_v and self.is_self_attn:
            if v_first is None:
                v_first_out = v
            else:
                lamb = _local(self.lambda_v)
                if tp is not None:  # it mixes this rank's heads only
                    lamb = tpar.copy_to_tp(lamb, tp)
                lamb = lamb.to(v.dtype)
                v = lamb * v + (1.0 - lamb) * v_first

        q = rms_norm(q)
        k = rms_norm(k)
        out = attention(q, k, v, kv_mask=kv_mask, scale=d**-0.5)
        out = self.proj(out.transpose(1, 2).reshape(b, lq, h * d))
        if tp is not None:
            out = tpar.exit_rows(out, tp, seq)
        return out, v_first_out


class SwiGLUMLP(nn.Module):
    tp = None  # parallel.tensor.TPContext, set by parallelize_dit

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        d, inter = cfg.hidden_size, int(cfg.hidden_size * cfg.mlp_ratio)
        self.gate_proj = _linear(cfg, "gate_proj", d, inter, False)
        self.up_proj = _linear(cfg, "up_proj", d, inter, False)
        self.down_proj = _linear(cfg, "down_proj", inter, d, False)

    def forward(self, x, seq=False):
        if self.tp is not None:
            x = tpar.enter_columns(x, self.tp, seq)
        # silu(gate) * up in span op.swiglu, the three GEMMs outside it; each
        # product is freed where the single expression freed it
        h = self.gate_proj(x)
        with span("op.swiglu"):
            h = F.silu(h)
        up = self.up_proj(x)
        with span("op.swiglu"):
            h = h * up
        del up
        y = self.down_proj(h)
        if self.tp is not None:
            y = tpar.exit_rows(y, self.tp, seq)
        return y


def _adaln_head(d: int, n: int) -> nn.Sequential:
    """SiLU -> Linear(d, n*d); keys `<name>.1.weight/bias`."""
    return nn.Sequential(nn.SiLU(), Dense(d, n * d))


class DiTBlock(nn.Module):
    """Pre-RMSNorm AdaLN block: self-attention, optional cross-attention,
    SwiGLU MLP. `modulation` (B, 9, D) holds (shift, scale, gate) for
    (self-attention, cross-attention, MLP). `seq`: x is this rank's share
    of the sequence (sequence parallelism), and so is the output."""

    tp = None  # parallel.tensor.TPContext, set by parallelize_dit

    def __init__(self, cfg: DiTConfig, idx: int):
        super().__init__()
        self.cfg = cfg
        self.index = idx
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
                v_first=None, seq=False):
        """Span `dit.block` (with the block's index; again when a checkpointed
        block runs in the backward), `block.adaln` around each modulation
        and each gated residual add."""
        with span("dit.block", index=self.index):
            return self._forward(x, context, context_mask, modulation, rope,
                                 v_first, seq)

    def _forward(self, x, context, context_mask, modulation, rope, v_first, seq):
        # on a share of the sequence, the replicated modulation and norm
        # weights see a share of the rows: their gradients sum over tp
        tp = self.tp if seq else None
        if tp is not None:
            modulation = tpar.copy_to_tp(modulation, tp)
        m = modulation[:, :, None, :].to(x.dtype).unbind(1)
        (shift_sa, scale_sa, gate_sa, shift_ca, scale_ca, gate_ca,
         shift_mlp, scale_mlp, gate_mlp) = m

        norm_x = self.norm1(x, tp)
        with span("block.adaln"):
            norm_x = norm_x * (1 + scale_sa) + shift_sa
        attn_out, v_first = self.self_attn(norm_x, rope=rope, v_first=v_first,
                                           seq=seq)
        with span("block.adaln"):
            x = x + attn_out * gate_sa
        if self.do_cross_attn:
            norm_x = self.norm2(x, tp)
            with span("block.adaln"):
                norm_x = norm_x * (1 + scale_ca) + shift_ca
            ca, _ = self.cross_attn(norm_x, context=context,
                                    context_mask=context_mask, seq=seq)
            with span("block.adaln"):
                x = x + ca * gate_ca
        norm_x = self.norm3(x, tp)
        with span("block.adaln"):
            norm_x = norm_x * (1 + scale_mlp) + shift_mlp
        mlp_out = self.mlp(norm_x, seq)
        with span("block.adaln"):
            x = x + mlp_out * gate_mlp
        return x, v_first


class PatchEmbed(nn.Module):
    """The reference's Conv2d patch embed, computed as patchify + matmul:
    the conv weight (D, C, p, p) read in the patches' (ki, kj, c) order."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        p, c, d = cfg.patch_size, cfg.in_channels, cfg.hidden_size
        self.patch_proj = nn.Conv2d(c, d, kernel_size=p, stride=p)

    def forward(self, tokens):
        w = _local(self.patch_proj.weight).to(tokens.dtype)  # (D, C, p, p)
        w = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)
        return F.linear(tokens, w, _local(self.patch_proj.bias).to(tokens.dtype))


# the weight products, which "dots" keeps (JAX's
# dots_with_no_batch_dims_saveable): nn.Linear's GEMMs, and F.linear where a
# backend does not decompose it; a batched product (bmm) is recomputed
_SAVED_PRODUCTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.linear.default}


def _drawn_into(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """`t`, or for a meta tensor a throwaway one of its shape and dtype on
    the generator's device (its draws still advance the generator)."""
    return torch.empty(t.shape, dtype=t.dtype, device=generator.device) if t.is_meta else t


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_saveable_contexts():
    """Selective checkpointing's pair of dispatch modes for "dots". Every
    other op, the attention's output allocations among them, runs again in
    the recomputation, so a kernel writes into fresh tensors there."""
    return create_selective_checkpoint_contexts(_dots_policy)


@dataclasses.dataclass
class Stream:
    """What flows through the DiT's parts (`DiT.embed` -> `DiT.run_blocks`
    -> `DiT.head`), and so between pipeline stages
    (`parallel/pipeline.py`): the residual stream (this rank's share of
    it under sequence parallelism, `seq`), the projected context and its
    prefix mask, the timestep embedding, the shared modulation, the rope
    tables of the patch grid, residual_v's block-0 values and sequence
    dropout's kept tokens."""

    tokens: torch.Tensor
    context: torch.Tensor
    context_mask: torch.Tensor | None
    t_emb: torch.Tensor
    modulation: torch.Tensor | None
    rope: tuple | None
    grid: tuple
    seq: bool
    v_first: torch.Tensor | None = None
    token_indices: torch.Tensor | None = None


class DiT(nn.Module):
    """The denoiser: forward(x (B,H,W,C), context (B,S,Ctx), context_mask
    (B,S) bool or None, t (B,)) -> velocity (B,H,W,C), all NHWC."""

    tp = None  # parallel.tensor.TPContext, set by parallelize_dit

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
        """The compute dtype: `config.dtype`, else the parameters' (the
        first one's: `context_proj`'s where this module holds it)."""
        return self.config.dtype or next(self.parameters()).dtype

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DiT":
        """The JAX package's initializers, drawn from `generator` (on the
        parameters' device): lecun_normal kernels (truncated normal,
        fan_in = in_features) with zero biases; zero AdaLN heads and
        final_proj, so a fresh DiT outputs exactly 0; N(0, 1) registers;
        zero positional table; lambda_v 0.5; norm weights 1. The draws go
        in the whole DiT's order: a module this one lacks (another
        pipeline stage's) draws into a throwaway tensor, so each stage
        gets the values one whole DiT would."""
        zero_heads = {"adaLN_modulation", "final_modulation", "final_proj"}
        with torch.device("meta"):
            whole = DiT(self.config)
        mine = dict(self.named_modules())
        for name, mod in whole.named_modules():
            mod = mine.get(name, mod)
            if isinstance(mod, RMSNormModule):
                mod.weight.fill_(1.0)
            elif isinstance(mod, (nn.Linear, nn.Conv2d)):
                w = mod.weight
                if zero_heads & set(name.split(".")):
                    w.zero_()
                else:
                    lecun_normal_(_drawn_into(w, generator), generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, Attention) and hasattr(mod, "lambda_v"):
                mod.lambda_v.fill_(0.5)
        reg = getattr(self, "register_tokens", whole.register_tokens)
        _drawn_into(reg, generator).normal_(0.0, 1.0, generator=generator)
        if not self.config.use_rope and hasattr(self, "positional_embedding"):
            self.positional_embedding.zero_()
        return self

    def forward(self, x, context, context_mask, t, token_indices=None):
        """`token_indices` (B, K) int64, sequence dropout: only these patch
        positions run through the blocks (with the 16 register tokens
        prepended), with their own rope rows (or positional rows), and the
        output is token-space (B, K, p*p*C) instead of an image."""
        with span("dit.embed"):
            s = self.embed(x, context, context_mask, t, token_indices)
        s = self.run_blocks(s, 0, self.config.depth)
        with span("dit.head"):
            return self.head(s)

    def rope(self, grid, device):
        """The rope tables (cos, sin) of a (gh, gw) patch grid behind the
        registers' identity rows; None without rope."""
        cfg = self.config
        if not cfg.use_rope:
            return None
        return rope_2d_freqs(cfg.head_dim, *grid, base=cfg.rope_base,
                             n_register_tokens=cfg.n_register_tokens, device=device)

    def splits_sequence(self, length: int) -> bool:
        """Whether the blocks carry this rank's share of a stream of `length`
        tokens (sequence parallelism, where `length` divides over tp)."""
        return self.tp is not None and tpar.shards_sequence(self.tp, length)

    def embed(self, x, context, context_mask, t, token_indices=None) -> "Stream":
        """The part before the blocks: the context projected and normed, the
        patch tokens behind the registers (positional rows added without
        rope), the timestep embedding and the shared modulation; under
        sequence parallelism the stream is split here."""
        cfg = self.config
        dtype = self.dtype
        b, height, width, _ = x.shape
        grid = (height // cfg.patch_size, width // cfg.patch_size)
        d = cfg.hidden_size
        nreg = cfg.n_register_tokens

        if context_mask is not None:
            context, context_mask = compact_context(context, context_mask)
        context = self.context_norm(self.context_proj(context.to(dtype)))

        patches = patchify(x.to(dtype), cfg.patch_size)
        if token_indices is not None:
            patches = torch.take_along_dim(patches, token_indices[..., None], dim=1)
        tokens = self.patch_embed(patches)
        reg = _local(self.register_tokens).to(dtype).expand(b, -1, -1)
        tokens = torch.cat([reg, tokens], dim=1)

        rope = self.rope(grid, x.device)
        if rope is not None and token_indices is not None:
            # per-row tables: the kept patches' rows behind the registers'
            # identity rows
            rope = tuple(
                torch.cat([tab[None, :nreg].expand(b, -1, -1),
                           tab[nreg:][token_indices]], dim=1)
                for tab in rope)
        if not cfg.use_rope:
            pos = _local(self.positional_embedding)
            if token_indices is None:
                pos = pos[:, : tokens.shape[1], :]
            else:
                pos = torch.cat([pos[:, :nreg].expand(b, -1, -1),
                                 pos[0, nreg: nreg + grid[0] * grid[1]][token_indices]],
                                dim=1)
            tokens = tokens + pos.to(dtype)

        emb = timestep_embedding(t * 1000.0, d).to(dtype)
        t_emb = self.time_embed(emb)
        modulation = None
        if cfg.adaln_mode == "shared":
            modulation = self.adaLN_modulation(t_emb).reshape(b, 9, d)

        # sequence parallelism: each tp rank carries its share of the
        # sequence through the blocks, where L divides over the ranks
        seq = self.splits_sequence(tokens.shape[1])
        if seq:
            tokens = tpar.split_sequence(tokens, self.tp)
        return Stream(tokens, context, context_mask, t_emb, modulation, rope, grid,
                      seq, token_indices=token_indices)

    def run_blocks(self, s: "Stream", lo: int, hi: int) -> "Stream":
        """Blocks lo..hi-1 (global indices: `gradient_checkpoint_from` and
        residual_v's block 0 read them) on the stream `s`, in place."""
        cfg = self.config
        b, d = s.t_emb.shape[0], cfg.hidden_size
        remat = cfg.gradient_checkpoint and torch.is_grad_enabled()
        context_fn = (_dots_saveable_contexts if cfg.remat_policy == "dots"
                      else noop_context_fn)
        modulation = s.modulation
        for idx in range(lo, hi):
            block = self.blocks[idx]
            if cfg.adaln_mode == "per_block":
                modulation = block.adaLN_modulation(s.t_emb).reshape(b, 9, d)
            args = (s.tokens, s.context, s.context_mask, modulation, s.rope, s.v_first,
                    s.seq)
            if remat and idx >= cfg.gradient_checkpoint_from:
                # "full" keeps the block's inputs only; "dots" also the
                # weight products. The backward runs the rest of the block
                # again under grad mode, attention included (its kernel
                # launches again and saves its lse again)
                s.tokens, s.v_first = checkpoint(block, *args, use_reentrant=False,
                                                 context_fn=context_fn)
            else:
                s.tokens, s.v_first = block(*args)
        return s

    def head(self, s: "Stream"):
        """The final layer: the stream whole again, the registers dropped,
        the final modulation, norm and projection; an image (B, H, W, C),
        or token-space rows under sequence dropout."""
        cfg = self.config
        dtype = self.dtype
        b, d = s.t_emb.shape[0], cfg.hidden_size
        tokens = s.tokens
        if s.seq:  # the final layer sees whole tokens
            tokens = tpar.gather_sequence(tokens, self.tp)
        # drop registers; final modulation + projection
        tokens = tokens[:, cfg.n_register_tokens:, :]
        final_mod = self.final_modulation(s.t_emb).reshape(b, 2, d)
        shift = final_mod[:, 0][:, None, :].to(dtype)
        scale = final_mod[:, 1][:, None, :].to(dtype)
        if cfg.train_bias_and_rms:
            tokens = self.final_norm(tokens)
        else:
            tokens = rms_norm(tokens)
        tokens = self.final_proj(tokens * (1 + scale) + shift)
        if s.token_indices is not None:
            return tokens
        return unpatchify(tokens, *s.grid, cfg.patch_size, cfg.in_channels)
