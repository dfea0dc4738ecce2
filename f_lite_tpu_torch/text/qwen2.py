"""The Qwen2-family text encoder in PyTorch (counterpart of
`f_lite_tpu/text/qwen2.py`): the HEAD pipeline's Qwen2.5-VL conditioning,
chat-template-wrapped captions -> hidden_states[-8].

Only the language tower matters (text-only prompts). For text alone,
Qwen2.5-VL's multimodal RoPE (three equal position streams) is the 1D RoPE
below, which rotates contiguous halves of each head (HF's `rotate_half`;
the DiT's `ops/rope.py` pairs adjacent lanes instead). Attention is causal
with right padding: a padded query row computes values the DiT's mask never
reads. q, k and v carry biases, o and the MLP do not; k and v heads repeat
for grouped-query attention (`repeat_interleave`). Weights stay in their
dtype and every activation is fp32 (`text/layers.py`), the causal and key
masks folded into one -1e30 fp32 bias on the scores. The parameter
names are HF `Qwen2Model`'s; checkpoints of the plain model, a causal LM
and the VL language tower load through their prefixes. The stack stops at
the layer `return_index` needs.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch
import torch.nn.functional as F
from torch import nn

from f_lite_tpu_torch.convert.hf_weights import empty_module, load_hf_weights_into
from f_lite_tpu_torch.text.encoder import TokenizedTextEncoder
from f_lite_tpu_torch.text.layers import RMSNorm, linear32, resolve_index
from f_lite_tpu_torch.text.templates import inference_chat_messages
from f_lite_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Qwen2Config:
    """The Qwen2.5-VL-7B language tower by default."""

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    head_dim: int | None = None
    rope_theta: float = 1e6
    rms_norm_eps: float = 1e-6

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf(cls, d: dict, **overrides) -> "Qwen2Config":
        # Qwen2.5-VL nests the language model's config under text_config
        if "text_config" in d:
            d = d["text_config"]
        kw = dict(
            vocab_size=d.get("vocab_size", 152064),
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            num_key_value_heads=d.get(
                "num_key_value_heads", d["num_attention_heads"]),
            head_dim=d.get("head_dim"),
            rope_theta=d.get("rope_theta", 1e6),
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
        )
        kw.update(overrides)
        return cls(**kw)


def rope_1d(head_dim: int, positions: torch.Tensor, theta: float):
    """(cos, sin) of positions (..., S) at the head's half-width
    frequencies, fp32 (..., S, head_dim // 2)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=positions.device) / head_dim
    inv = 1.0 / (theta ** exponents)
    freqs = positions.to(torch.float32)[..., None] * inv
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (B, H, S, D) rotated by (cos, sin) (S, D/2) over its contiguous
    halves (HF `rotate_half`)."""
    d = x.shape[-1] // 2
    x1, x2 = x[..., :d], x[..., d:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Qwen2Attention(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        h, kvh, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim_)
        self.heads, self.kv_heads, self.head_dim = h, kvh, d
        self.q_proj = nn.Linear(cfg.hidden_size, h * d, bias=True)
        self.k_proj = nn.Linear(cfg.hidden_size, kvh * d, bias=True)
        self.v_proj = nn.Linear(cfg.hidden_size, kvh * d, bias=True)
        self.o_proj = nn.Linear(h * d, cfg.hidden_size, bias=False)

    def forward(self, y, cos, sin, attn_bias):
        b, s, _ = y.shape
        h, kvh, d = self.heads, self.kv_heads, self.head_dim
        q = linear32(y, self.q_proj).view(b, s, h, d).transpose(1, 2)
        k = linear32(y, self.k_proj).view(b, s, kvh, d).transpose(1, 2)
        v = linear32(y, self.v_proj).view(b, s, kvh, d).transpose(1, 2)
        q = apply_rope_half(q, cos, sin)
        k = apply_rope_half(k, cos, sin).repeat_interleave(h // kvh, dim=1)
        v = v.repeat_interleave(h // kvh, dim=1)
        logits = torch.matmul(q, k.transpose(-1, -2)) * (d ** -0.5)
        probs = torch.softmax(logits + attn_bias, dim=-1)
        o = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, h * d)
        return linear32(o, self.o_proj)


class Qwen2MLP(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, bias=False)

    def forward(self, y):
        h = F.silu(linear32(y, self.gate_proj)) * linear32(y, self.up_proj)
        return linear32(h, self.down_proj)


class Qwen2DecoderLayer(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.self_attn = Qwen2Attention(cfg)
        self.mlp = Qwen2MLP(cfg)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, x, cos, sin, attn_bias):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, attn_bias)
        return x + self.mlp(self.post_attention_layernorm(x))


class Qwen2Encoder(nn.Module):
    """`forward(input_ids, attention_mask, return_index)` returns
    hidden_states[return_index] in fp32 (0 = embeddings, i = layer i's
    output, the last one after the final norm), running only the layers it
    needs."""

    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(
            [Qwen2DecoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    @property
    def embed_dim(self) -> int:
        return self.config.hidden_size

    def forward(self, input_ids, attention_mask=None, *, return_index: int = -8):
        cfg = self.config
        n = cfg.num_hidden_layers
        idx = resolve_index(return_index, n + 1)
        x = self.embed_tokens(input_ids).float()
        if idx == 0:
            return x
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        cos, sin = rope_1d(cfg.head_dim_, pos, cfg.rope_theta)
        keep = (pos[None, :] <= pos[:, None])[None, None]  # causal
        if attention_mask is not None:
            keep = keep & attention_mask[:, None, None, :].bool()
        attn_bias = torch.zeros(keep.shape, dtype=torch.float32,
                                device=keep.device).masked_fill_(~keep, -1e30)
        for layer in self.layers[:idx]:
            x = layer(x, cos, sin, attn_bias)
        return self.norm(x) if idx == n else x


# language-tower prefixes: VL checkpoints (new and old layouts), a causal
# LM, the bare model
_PREFIXES = ("model.language_model.", "language_model.model.",
             "language_model.", "model.", "")
_TOWER = ("embed_tokens.", "layers.", "norm.")


def qwen2_checkpoint_key(name: str) -> str | None:
    """A Qwen2 / Qwen2.5-VL checkpoint key -> the tower's parameter name;
    None for what lies outside the tower (`lm_head`, `visual`)."""
    for p in _PREFIXES:
        if name.startswith(p) and name[len(p):].startswith(_TOWER):
            return name[len(p):]
    return None


def load_qwen2_encoder(model_path: str | Path, *, dtype=torch.bfloat16,
                       device="cuda") -> Qwen2Encoder:
    """The language tower of an HF Qwen2 / Qwen2.5-VL folder, its
    parameters allocated once at `dtype` on `device`, filled file by
    file."""
    device = resolve_device(device)
    model_path = Path(model_path)
    cfg = Qwen2Config.from_hf(json.loads((model_path / "config.json").read_text()))
    stack = empty_module(lambda: Qwen2Encoder(cfg), dtype, device)
    load_hf_weights_into(stack, model_path, qwen2_checkpoint_key)
    return stack.eval()


class Qwen2TextEncoder(TokenizedTextEncoder):
    """TextEncoder-protocol wrapper: tokenize (chat template when the
    tokenizer has one) -> Qwen2 tower -> hidden_states[return_index].

    `Qwen2TextEncoder(model_path, processor_path)` loads the tower in
    `dtype` on `device` and the tokenizer (`transformers`);
    `Qwen2TextEncoder.from_stack(stack, tokenizer)` takes built ones.
    `message_fn(caption)` builds the chat messages."""

    message_fn = staticmethod(inference_chat_messages)

    def __init__(self, model_path: str, processor_path: str | None = None, *,
                 return_index: int = -8, max_sequence_length: int = 512,
                 pad_to_multiple_of: int = 8, dtype=torch.bfloat16,
                 device="cuda", message_fn=None):
        stack = load_qwen2_encoder(model_path, dtype=dtype, device=device)
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(processor_path or model_path)
        super().__init__(stack, tokenizer, return_index=return_index,
                         max_sequence_length=max_sequence_length,
                         pad_to_multiple_of=pad_to_multiple_of)
        if message_fn is not None:
            self.message_fn = message_fn

    def render(self, prompt: str) -> str:
        if getattr(self.tokenizer, "chat_template", None):
            return self.tokenizer.apply_chat_template(
                self.message_fn(prompt), tokenize=False,
                add_generation_prompt=True)
        return prompt
