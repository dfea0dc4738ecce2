"""The T5 encoder stack in PyTorch (counterpart of `f_lite_tpu/text/t5.py`):
the released F-Lite checkpoints condition on hidden layer -8 of T5-XXL.

HF `T5EncoderModel` semantics, and its parameter names, so a `text_encoder/`
folder loads as it is:
- T5LayerNorm is RMSNorm (no mean, no bias, statistics in fp32);
- attention scores are not scaled by 1/sqrt(d); the inner width
  num_heads * d_kv may differ from d_model;
- one learned relative-position bias (bidirectional buckets) lives in block
  0 and is shared by every block;
- the feed-forward is `relu` (wi -> relu -> wo) or gated (`gated-gelu`:
  wo(gelu_tanh(wi_0(x)) * wi_1(x)); T5 v1.1, T5-XXL);
- hidden_states = [embeddings, block_0, ..., block_{N-2},
  final_layer_norm(block_{N-1})]: index -8 is a block's output before any
  norm.

Weights stay in their dtype (bf16 as loaded); every activation is fp32
(`text/layers.py`). In particular the scores: T5 does not scale them and
they reach 50-100, where bf16's steps of 0.25-0.5 would change the softmax;
the fp32 position bias holds the -1e30 key mask. The stack stops at the
block `return_index` needs and returns fp32.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import torch
import torch.nn.functional as F
from torch import nn

from f_lite_tpu_torch.convert.hf_weights import empty_module, load_hf_weights_into
from f_lite_tpu_torch.text.layers import RMSNorm, linear32, resolve_index
from f_lite_tpu_torch.utils.device import resolve_device

_ACTIVATIONS = {
    "relu": F.relu,
    "gelu": F.gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
}


@dataclasses.dataclass(frozen=True)
class T5Config:
    """T5-XXL (v1.1) by default."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"

    @property
    def is_gated(self) -> bool:
        return self.feed_forward_proj.startswith("gated-")

    @property
    def act_fn(self):
        act = self.feed_forward_proj.removeprefix("gated-")
        if self.is_gated and act == "gelu":
            # HF maps only the "gated-gelu" spelling to the tanh GELU; a
            # plain "gelu" stays the exact erf GELU
            act = "gelu_new"
        return _ACTIVATIONS[act]

    @classmethod
    def from_hf(cls, d: dict, **overrides) -> "T5Config":
        kw = dict(
            vocab_size=d.get("vocab_size", 32128),
            d_model=d["d_model"],
            d_kv=d.get("d_kv", 64),
            d_ff=d["d_ff"],
            num_layers=d["num_layers"],
            num_heads=d["num_heads"],
            relative_attention_num_buckets=d.get(
                "relative_attention_num_buckets", 32),
            relative_attention_max_distance=d.get(
                "relative_attention_max_distance", 128),
            layer_norm_epsilon=d.get("layer_norm_epsilon", 1e-6),
            feed_forward_proj=d.get("feed_forward_proj", "relu"),
        )
        kw.update(overrides)
        return cls(**kw)


def relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """Bidirectional buckets of key - query offsets, as the JAX stack
    computes them (fp32 log with + 1e-9, truncated toward zero): half the
    buckets for positive offsets, exact up to num_buckets // 4, log-spaced
    out to max_distance."""
    num_buckets //= 2
    ret = (rel_pos > 0).to(torch.int32) * num_buckets
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    scale = torch.tensor(math.log(max_distance / max_exact), dtype=torch.float32)
    val_if_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact + 1e-9) / scale
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n.to(torch.int32), val_if_large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_attention_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.num_heads, self.d_kv = cfg.num_heads, cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_relative_attention_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads)

    def forward(self, y, position_bias):
        b, s, _ = y.shape
        h, dk = self.num_heads, self.d_kv
        q, k, v = (linear32(y, proj).view(b, s, h, dk).transpose(1, 2)
                   for proj in (self.q, self.k, self.v))
        scores = torch.matmul(q, k.transpose(-1, -2))  # no 1/sqrt(d) scale
        probs = torch.softmax(scores + position_bias, dim=-1)
        o = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, h * dk)
        return linear32(o, self.o)


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_attention_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_attention_bias)
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x, position_bias):
        return x + self.SelfAttention(self.layer_norm(x), position_bias)


class T5DenseActDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.act = cfg.act_fn
        self.gated = cfg.is_gated
        if self.gated:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, y):
        if self.gated:
            h = self.act(linear32(y, self.wi_0)) * linear32(y, self.wi_1)
        else:
            h = self.act(linear32(y, self.wi))
        return linear32(h, self.wo)


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseActDense(cfg)
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_attention_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([
            T5LayerSelfAttention(cfg, has_relative_attention_bias),
            T5LayerFF(cfg),
        ])

    def forward(self, x, position_bias):
        return self.layer[1](self.layer[0](x, position_bias))


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList(
            [T5Block(cfg, i == 0) for i in range(cfg.num_layers)])
        self.final_layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5EncoderStack(nn.Module):
    """`forward(input_ids, attention_mask, return_index)` returns
    hidden_states[return_index] in fp32 (0 = embeddings, -1 = the final
    norm's output), running only the blocks that index needs."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.config = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = T5Stack(cfg)

    @property
    def embed_dim(self) -> int:
        return self.config.d_model

    def position_bias(self, s: int, attention_mask=None) -> torch.Tensor:
        """(1 or B, H, S, S) fp32: the shared relative-position bias, with
        -1e30 at masked keys."""
        cfg = self.config
        emb = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias
        pos = torch.arange(s, device=emb.weight.device)
        buckets = relative_position_bucket(
            pos[None, :] - pos[:, None], cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance)
        bias = emb(buckets).permute(2, 0, 1)[None].float()
        if attention_mask is not None:
            # bias - 1e30 rounds to -1e30 in fp32
            bias = torch.where(attention_mask[:, None, None, :].bool(), bias, -1e30)
        return bias

    def forward(self, input_ids, attention_mask=None, *, return_index: int = -8):
        n = self.config.num_layers
        idx = resolve_index(return_index, n + 1)
        x = self.shared(input_ids).float()
        if idx == 0:
            return x
        bias = self.position_bias(input_ids.shape[1], attention_mask)
        for blk in self.encoder.block[:idx]:
            x = blk(x, bias)
        return self.encoder.final_layer_norm(x) if idx == n else x


# checkpoint keys that are the embedding, and parts of a T5 checkpoint
# outside the encoder
_EMBED_KEYS = ("shared.weight", "encoder.embed_tokens.weight",
               "embed_tokens.weight")
_OUTSIDE = ("decoder.", "lm_head.")


def t5_checkpoint_key(name: str) -> str | None:
    """An HF T5 checkpoint key -> the stack's parameter name (None outside
    the encoder). Takes `encoder.` keys, bare ones and `text_encoder.`
    prefixed ones, as the JAX package's converter does."""
    if name in _EMBED_KEYS:
        return "shared.weight"
    if name.startswith(_OUTSIDE):
        return None
    name = name.removeprefix("text_encoder.")
    return name if name.startswith("encoder.") else "encoder." + name


def load_t5_encoder(model_path: str | Path, *, dtype=torch.bfloat16,
                    device="cuda") -> T5EncoderStack:
    """The stack of an HF T5 folder (config.json + weights), its parameters
    allocated once at `dtype` on `device` and filled file by file."""
    device = resolve_device(device)
    model_path = Path(model_path)
    cfg = T5Config.from_hf(json.loads((model_path / "config.json").read_text()))
    stack = empty_module(lambda: T5EncoderStack(cfg), dtype, device)
    load_hf_weights_into(stack, model_path, t5_checkpoint_key)
    return stack.eval()
