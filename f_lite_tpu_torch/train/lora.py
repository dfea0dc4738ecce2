"""LoRA: the merge at load (`apply_lora`, `load_lora_weights`) and LoRA
training (`init_lora_params`, `attach_lora`, `save_lora_weights`);
counterparts of `f_lite_tpu/train/lora.py`.

The factors form the framework's tree, `blocks_{i}/{self_attn|cross_attn}/
{target}` -> {"lora_a": (in, r), "lora_b": (r, out_flat)}, on the
reference's targets `qkv, q, context_kv, proj`. The port's weights are
torch's (out, in), the fused targets' rows in the (split, H, D) C order the
factors' flattened out dims use (`convert/lora_torch.py`), so the merged
weight is `W + scale * alpha / rank * (a @ b)^T`.

Training merges inside the step, with autograd: `attach_lora` puts a
parametrization on each target weight that returns `W + alpha / rank *
(a @ b)^T` in fp32 (the JAX order: the product in fp32, cast to the
weight's dtype, then the scaled add) and freezes the DiT, so only the
factors train. `detach_lora` takes the parametrizations off again. Under
FSDP2 the parametrization is attached first: `fully_shard` then shards the
frozen base and the factors with their block, and its all-gather hands the
parametrization whole tensors inside the block's forward, so the merge is
the one-card merge; `attached_factors` finds the factors again after
`fully_shard` has replaced the Parameters with sharded ones. Under tensor
parallelism `parallel.tensor.parallelize_dit` splits the factors like
their weight (a column layer's `lora_b` by output columns, head-aligned
for qkv and context_kv; a row layer's `lora_a` by input rows), and the
merge runs on DTensors, which sum the replicated factor's partial
gradient over the tp group.
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn
from torch.nn.utils import parametrize

DEFAULT_TARGETS = ("qkv", "q", "context_kv", "proj")


def target_layers(dit, targets=DEFAULT_TARGETS) -> dict:
    """{(f"blocks_{i}", "self_attn" | "cross_attn", target): layer} for the
    DiT's layers named in `targets`, in sorted path order."""
    found = {}
    for name, module in dit.named_modules():
        parts = name.split(".")
        if len(parts) == 4 and parts[0] == "blocks" and parts[3] in targets:
            found[(f"blocks_{parts[1]}", parts[2], parts[3])] = module
    return dict(sorted(found.items()))


def _nodes(tree: dict, depth: int) -> list:
    """The dicts `depth` levels down the tree."""
    if depth == 0:
        return [tree]
    return [n for v in tree.values() if isinstance(v, dict) for n in _nodes(v, depth - 1)]


def _node(tree: dict, path) -> dict:
    for p in path:
        tree = tree.setdefault(p, {})
    return tree


def init_lora_params(dit, *, rank: int = 64, targets=DEFAULT_TARGETS,
                     generator: torch.Generator, stddev: float = 0.02) -> dict:
    """The factor tree of `f_lite_tpu.train.lora.init_lora_params`: for each
    target layer, lora_a (in, rank) normal * stddev and lora_b (rank, out)
    zeros, fp32, drawn from `generator` (on its device) in sorted path
    order."""
    tree: dict = {}
    device = generator.device
    for path, layer in target_layers(dit, targets).items():
        d_out, d_in = layer.weight.shape
        _node(tree, path)["lora_a"] = torch.randn(
            (d_in, rank), generator=generator, device=device) * stddev
        _node(tree, path)["lora_b"] = torch.zeros((rank, d_out), device=device)
    if not tree:
        raise ValueError(f"no LoRA target among {tuple(targets)} in the DiT")
    return tree


def flatten_lora(tree: dict, prefix: str = "") -> dict:
    """{"blocks_0.self_attn.qkv.lora_a": tensor, ...}: the keys of
    `lora_weights.safetensors`."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        flat.update(flatten_lora(v, key) if isinstance(v, dict) else {key: v})
    return flat


class _LoRAMerge(nn.Module):
    def __init__(self, a: torch.Tensor, b: torch.Tensor, factor: float):
        super().__init__()
        self.lora_a = nn.Parameter(a)
        self.lora_b = nn.Parameter(b)
        self.factor = factor

    def forward(self, w):
        delta = (self.lora_a @ self.lora_b).t().to(w.dtype)
        return w + self.factor * delta


def attach_lora(dit, tree: dict, *, alpha: float, rank: int) -> dict:
    """Freeze `dit` and merge the factors of `tree` into their weights on
    every access (a parametrization), so the forward trains them. Returns
    the factor tree of the trainable Parameters (fp32, on the weights'
    device)."""
    tree = tree.get("params", tree)
    targets = {t for attn in _nodes(tree, 2) for t in attn}
    dit.requires_grad_(False)
    trained: dict = {}
    for path, layer in target_layers(dit, targets).items():
        node = tree.get(path[0], {}).get(path[1], {}).get(path[2])
        if node is None:
            continue
        dev = layer.weight.device
        merge = _LoRAMerge(*(torch.as_tensor(node[k]).to(dev, torch.float32).clone()
                             for k in ("lora_a", "lora_b")), alpha / rank)
        parametrize.register_parametrization(layer, "weight", merge)
        _node(trained, path).update(lora_a=merge.lora_a, lora_b=merge.lora_b)
    if not trained:
        raise ValueError("LoRA factors matched no layer of the DiT")
    return trained


def attached_factors(dit) -> dict:
    """The factor tree of the Parameters `attach_lora` put on `dit` (as
    they are now: DTensors under FSDP2)."""
    found = {}
    for name, layer in dit.named_modules():
        parts = name.split(".")
        if len(parts) == 4 and parts[0] == "blocks" \
                and parametrize.is_parametrized(layer, "weight"):
            found[(f"blocks_{parts[1]}", parts[2], parts[3])] = \
                layer.parametrizations.weight[0]
    tree: dict = {}
    for path, merge in sorted(found.items()):
        _node(tree, path).update(lora_a=merge.lora_a, lora_b=merge.lora_b)
    return tree


def detach_lora(dit) -> None:
    """Take `attach_lora`'s parametrizations off: the base weights again."""
    for layer in dit.modules():
        if parametrize.is_parametrized(layer, "weight"):
            parametrize.remove_parametrizations(layer, "weight",
                                                leave_parametrized=False)


def save_lora_weights(tree: dict, directory) -> None:
    """`{directory}/lora_weights.safetensors` with the JAX package's keys,
    fp32 (the port's writer); both packages' `load_lora_weights` read it."""
    from f_lite_tpu_torch.utils.safetensors import save_file

    save_file({k: torch.as_tensor(v).float() for k, v in flatten_lora(tree).items()},
              Path(directory) / "lora_weights.safetensors")


def lora_rank(lora: dict) -> int:
    """The rank of the tree's first `lora_a` factor, 0 without one (the
    JAX pipeline's `_find_rank`)."""
    for k, v in lora.items():
        if isinstance(v, dict):
            r = lora_rank(v)
            if r:
                return r
        elif k == "lora_a":
            return int(v.shape[1])
    return 0


@torch.no_grad()
def apply_lora(dit, lora: dict, *, alpha: float = 64.0, rank: int = 64,
               scale: float = 1.0) -> int:
    """Merge the factors into the DiT's weights in place, in the weights'
    dtype and on their device, in the JAX order: delta = (a @ b) in fp32,
    cast to the weight's dtype, then W + factor * delta with the factor
    scale * alpha / rank in that dtype too. Returns the number of weights
    changed. A factor whose layer is not in the DiT is skipped, as the JAX
    merge skips it."""
    tree = lora.get("params", lora)
    targets = {t for attn in _nodes(tree, 2) for t in attn}
    factor = scale * alpha / rank
    merged = 0
    for name, module in dit.named_modules():
        parts = name.split(".")
        if len(parts) != 4 or parts[0] != "blocks" or parts[3] not in targets:
            continue
        node = tree.get(f"blocks_{parts[1]}", {}).get(parts[2], {}).get(parts[3])
        if node is None or "lora_a" not in node:
            continue
        if not hasattr(module, "weight") or module.weight is None:
            raise ValueError(f"{name}: LoRA factors cannot merge into int8 "
                             "weights; merge before quantizing")
        w = module.weight
        a, b = (torch.as_tensor(node[k]).to(w.device, torch.float32)
                for k in ("lora_a", "lora_b"))
        delta = (a @ b).t()
        if tuple(delta.shape) != tuple(w.shape):
            raise ValueError(f"{name}: LoRA delta {tuple(delta.shape)} does not "
                             f"fit the weight {tuple(w.shape)}")
        delta = delta.to(w.dtype)
        w.copy_(w + torch.tensor(factor, dtype=w.dtype, device=w.device) * delta)
        merged += 1
    return merged


def load_lora_weights(directory) -> dict:
    """The factor tree of a LoRA checkpoint: `directory` may be the
    checkpoint dir, the framework's `lora_weights.safetensors`, or a
    reference peft `lora_weights.pt` (converted by
    `convert.lora_torch.lora_from_peft_state_dict`). Factors are numpy
    arrays, read by the port's own safetensors reader."""
    from f_lite_tpu_torch.convert.from_jax import unflatten
    from f_lite_tpu_torch.utils.safetensors import load_file

    p = Path(directory)
    if p.is_dir():
        st = p / "lora_weights.safetensors"
        pt = p / "lora_weights.pt"
        if not st.exists() and not pt.exists():
            raise FileNotFoundError(
                f"no LoRA weights in {p}: expected {st.name} (framework "
                f"format) or {pt.name} (reference peft format)")
        p = st if st.exists() else pt
    if p.suffix == ".pt":
        from f_lite_tpu_torch.convert.lora_torch import lora_from_peft_state_dict

        sd = torch.load(str(p), map_location="cpu", weights_only=True)
        return lora_from_peft_state_dict(sd)
    return unflatten(load_file(p))
