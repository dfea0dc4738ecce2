"""LoRA at load: the port's `apply_lora` and `load_lora_weights`
(counterparts of `f_lite_tpu/train/lora.py`).

The factors form the framework's tree, `blocks_{i}/{self_attn|cross_attn}/
{target}` -> {"lora_a": (in, r), "lora_b": (r, out_flat)}, on the
reference's targets `qkv, q, context_kv, proj`. The port's weights are
torch's (out, in), the fused targets' rows in the (split, H, D) C order the
factors' flattened out dims use (`convert/lora_torch.py`), so the merged
weight is `W + scale * alpha / rank * (a @ b)^T`. Training the factors
(`init_lora_params`, `save_lora_weights`) is not ported yet.
"""

from __future__ import annotations

from pathlib import Path

import torch

DEFAULT_TARGETS = ("qkv", "q", "context_kv", "proj")


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
    factor = scale * alpha / rank
    merged = 0
    for name, module in dit.named_modules():
        parts = name.split(".")
        if len(parts) != 4 or parts[0] != "blocks" or parts[3] not in DEFAULT_TARGETS:
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
