"""The text towers' bf16 recipes against fp32 at full width, on one NVIDIA
GPU:

    python -m f_lite_tpu_torch.tools.text_precision

Builds T5-XXL (`T5Config()`) and the Qwen2.5-VL-7B language tower
(`Qwen2Config()`) with seeded bf16 weights (`randomize_`, seed 7) and the
same weights in fp32, and computes hidden state -8 of seeded ids (one
prompt of 77 or 160 ids, and a batch of lengths 5, 40, 77 or 160, 300)
in two recipes:
- "port": the towers as they run (`text/layers.py`): bf16 weights and
  GEMM inputs, products returned in fp32, every activation fp32;
- "jax": every activation rounded to bf16, as the JAX package's stacks
  compute with dtype bf16 (`f_lite_tpu/text/t5.py`, `qwen2.py`): the
  embeddings, norms, projections, probabilities, attention outputs,
  activations and the residual stream; scores in fp32 (`jax_recipe`).
For each it prints the largest abs error on the real rows over 5% of the
fp32 result's rms (err/tol, the bf16 bar of `flash_attention.tolerance`),
the rms error over the rms, and the encode ms (CUDA events, median of 10
after a warm-up), then the card's name and power limit and last one JSON
line {"precision": [...]}. TF32 is off. Exits non-zero without a card
("needs an NVIDIA GPU").
"""

from __future__ import annotations

import json
import statistics
import sys

import numpy as np
import torch
import torch.nn.functional as F

from f_lite_tpu_torch.convert.hf_weights import empty_module
from f_lite_tpu_torch.ops.cuda.flash_attention import tolerance
from f_lite_tpu_torch.ops.norms import rms_norm
from f_lite_tpu_torch.text import qwen2, t5
from f_lite_tpu_torch.text.encoder import _pad_to_multiple
from f_lite_tpu_torch.text.layers import resolve_index
from f_lite_tpu_torch.utils.random_weights import randomize_

TOWERS = {"t5": (t5.T5EncoderStack, t5.T5Config),
          "qwen2": (qwen2.Qwen2Encoder, qwen2.Qwen2Config)}
# real ids of one prompt: 77 (T5's usual length), 160 (about the Qwen
# inference template's)
SINGLE = {"t5": 77, "qwen2": 160}


def _t5_jax(stack, ids, mask, n_run):
    cfg, dt = stack.config, stack.shared.weight.dtype
    x = stack.shared(ids)
    bias = stack.position_bias(ids.shape[1], mask)
    for blk in stack.encoder.block[:n_run]:
        sa, ff = blk.layer[0], blk.layer[1]
        att = sa.SelfAttention
        b, s, _ = x.shape
        y = rms_norm(x, sa.layer_norm.weight, eps=cfg.layer_norm_epsilon)
        q, k, v = (F.linear(y, w.weight).view(b, s, att.num_heads, att.d_kv).transpose(1, 2)
                   for w in (att.q, att.k, att.v))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias
        probs = torch.softmax(scores, dim=-1).to(dt)
        o = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, -1)
        x = x + F.linear(o, att.o.weight)
        d = ff.DenseReluDense
        y = rms_norm(x, ff.layer_norm.weight, eps=cfg.layer_norm_epsilon)
        if d.gated:
            h = d.act(F.linear(y, d.wi_0.weight)) * F.linear(y, d.wi_1.weight)
        else:
            h = d.act(F.linear(y, d.wi.weight))
        x = x + F.linear(h, d.wo.weight)
    if n_run == cfg.num_layers:
        x = rms_norm(x, stack.encoder.final_layer_norm.weight, eps=cfg.layer_norm_epsilon)
    return x


def _qwen2_jax(stack, ids, mask, n_run):
    cfg, dt = stack.config, stack.embed_tokens.weight.dtype
    x = stack.embed_tokens(ids)
    s = ids.shape[1]
    pos = torch.arange(s, device=ids.device)
    cos, sin = qwen2.rope_1d(cfg.head_dim_, pos, cfg.rope_theta)
    keep = (pos[None, :] <= pos[:, None])[None, None] & mask[:, None, None, :].bool()
    bias = torch.zeros(keep.shape, dtype=torch.float32,
                       device=ids.device).masked_fill_(~keep, -1e30)
    for layer in stack.layers[:n_run]:
        att, mlp = layer.self_attn, layer.mlp
        b = x.shape[0]
        h, kvh, d = att.heads, att.kv_heads, att.head_dim
        y = rms_norm(x, layer.input_layernorm.weight, eps=cfg.rms_norm_eps)
        q = att.q_proj(y).view(b, s, h, d).transpose(1, 2)
        k = att.k_proj(y).view(b, s, kvh, d).transpose(1, 2)
        v = att.v_proj(y).view(b, s, kvh, d).transpose(1, 2)
        q = qwen2.apply_rope_half(q.float(), cos, sin).to(dt)
        k = qwen2.apply_rope_half(k.float(), cos, sin).to(dt).repeat_interleave(h // kvh, dim=1)
        v = v.repeat_interleave(h // kvh, dim=1)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d ** -0.5)
        probs = torch.softmax(logits + bias, dim=-1).to(dt)
        o = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, h * d)
        x = x + att.o_proj(o)
        y = rms_norm(x, layer.post_attention_layernorm.weight, eps=cfg.rms_norm_eps)
        x = x + mlp.down_proj(F.silu(mlp.gate_proj(y)) * mlp.up_proj(y))
    if n_run == cfg.num_hidden_layers:
        x = rms_norm(x, stack.norm.weight, eps=cfg.rms_norm_eps)
    return x


@torch.no_grad()
def jax_recipe(stack, ids, mask, return_index: int = -8) -> torch.Tensor:
    """hidden_states[return_index] of `stack` (T5 or Qwen2) with every
    activation in the weights' dtype, as the JAX package computes; fp32
    out."""
    if isinstance(stack, t5.T5EncoderStack):
        n_run = resolve_index(return_index, stack.config.num_layers + 1)
        return _t5_jax(stack, ids, mask, n_run).float()
    n_run = resolve_index(return_index, stack.config.num_hidden_layers + 1)
    return _qwen2_jax(stack, ids, mask, n_run).float()


def errors(got, want, mask) -> dict:
    """err/tol (largest abs error on the real rows over the bf16 bar,
    `flash_attention.tolerance`: 5% of the reference's rms there) and the
    rms error over the rms."""
    d, w = (got - want)[mask], want[mask]
    return dict(err_over_tol=float(d.abs().max()) / tolerance(w, torch.bfloat16),
                rms_err_over_rms=float(d.pow(2).mean().sqrt() / w.pow(2).mean().sqrt()))


def seeded_ids(lengths, vocab, seed, multiple=8):
    """Rows of `lengths` seeded ids in [2, vocab), right-padded with 0 to a
    multiple of `multiple`: (ids, mask) numpy."""
    rs = np.random.RandomState(seed)
    return _pad_to_multiple([list(rs.randint(2, vocab, n)) for n in lengths], 0,
                            multiple, max(lengths))


def tower_pair(kind: str, device):
    """(the tower at its default, full-width config with seeded bf16
    weights, the same weights in fp32), both on `device`, each allocated
    once at its dtype."""
    cls, cfg_cls = TOWERS[kind]
    cfg = cfg_cls()
    stack = randomize_(empty_module(lambda: cls(cfg), torch.bfloat16, device), seed=7)
    ref = empty_module(lambda: cls(cfg), torch.float32, device)
    ref.load_state_dict(stack.state_dict())
    return stack.eval(), ref.eval()


def median_ms(fn, n=10) -> float:
    """Median device ms of fn() over n runs after a warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@torch.no_grad()
def measure(kind: str, device) -> list[dict]:
    stack, ref = tower_pair(kind, device)
    rows = []
    for label, lengths in (("single", [SINGLE[kind]]), ("batch", [5, 40, SINGLE[kind], 300])):
        ids, mask = (torch.from_numpy(a).to(device) for a in
                     seeded_ids(lengths, stack.config.vocab_size, 8))
        ids = ids.long()
        want = ref(ids, mask)
        recipes = {"port": lambda: stack(ids, mask),
                   "jax": lambda: jax_recipe(stack, ids, mask)}
        for name, fn in recipes.items():
            row = dict(tower=kind, input=label, shape=list(ids.shape), recipe=name,
                       **errors(fn().float(), want, mask), ms=median_ms(fn))
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("text_precision: needs an NVIDIA GPU")
    from f_lite_tpu_torch.tools.forward_tiles import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for kind in TOWERS:
        rows += measure(kind, torch.device("cuda"))
        torch.cuda.empty_cache()
    print(card_line())
    print(json.dumps({"precision": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
