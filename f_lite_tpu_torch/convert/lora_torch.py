"""LoRA factors: the framework's tree <-> peft state dicts (the port's copy
of `f_lite_tpu/convert/lora_torch.py`).

The reference injects peft adapters onto `qkv, q, context_kv, proj`,
saves them with `get_peft_model_state_dict` (`lora_weights.pt`) and loads
them again at inference. The keys are

    blocks.{i}.{self_attn|cross_attn}.{target}.lora_{A|B}.weight

with torch-Linear factor shapes A (r, in) / B (out, r). The framework's
factors (`train/lora.py`) live at `blocks_{i}/{self_attn|cross_attn}/
{target}` as `lora_a` (in, r) / `lora_b` (r, out_flat), the fused targets'
out dims flattened in the (split, H, D) C order that is torch's fused
Linear out order. The merged delta `(alpha/r) * a @ b` is peft's
`(alpha/r) * (B @ A)^T`, so the conversion is a rename and a transpose,
bitwise in both directions.

Factors are never head-padded: LoRA attaches at training time and head
padding is a serving-time transform.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

_ATTNS = ("self_attn", "cross_attn")
_TARGETS = ("qkv", "q", "context_kv", "proj")
# a peft state dict saved through a full PeftModel wrapper (rather than
# the reference's bare-module `get_peft_model_state_dict`) prefixes every
# key; accept both on ingest
_PEFT_PREFIX = "base_model.model."


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def lora_to_peft_state_dict(lora: Mapping[str, Any]) -> dict:
    """Framework LoRA factor pytree -> peft state dict (numpy values).

    Accepts the tree with or without the outer `params` wrapper. Output
    keys/shapes match `get_peft_model_state_dict` on the reference DiT
    exactly; `torch.save` of the tensor-ified dict is a drop-in
    `lora_weights.pt` for the reference's `pt.py:127-129` /
    `model.py:493-495` load paths.
    """
    tree = lora.get("params", lora)
    out: dict[str, np.ndarray] = {}
    for block, attns in sorted(tree.items()):
        if not (block.startswith("blocks_") and isinstance(attns, dict)):
            raise ValueError(
                f"unexpected LoRA tree node {block!r} — LoRA factors "
                "attach only to attention projections under blocks_N "
                "(train/lora.py DEFAULT_TARGETS)"
            )
        idx = int(block.split("_", 1)[1])
        for attn, targets in sorted(attns.items()):
            if attn not in _ATTNS:
                raise ValueError(f"unexpected node {block}/{attn}")
            for target, factors in sorted(targets.items()):
                if target not in _TARGETS or not {"lora_a", "lora_b"} <= set(
                    factors
                ):
                    raise ValueError(
                        f"unexpected node {block}/{attn}/{target} — expected "
                        "both lora_a and lora_b factors on a known target"
                    )
                base = f"blocks.{idx}.{attn}.{target}"
                out[f"{base}.lora_A.weight"] = _t(factors["lora_a"])
                out[f"{base}.lora_B.weight"] = _t(factors["lora_b"])
    if not out:
        raise ValueError("empty LoRA tree")
    return out


def lora_from_peft_state_dict(sd: Mapping[str, Any]) -> dict:
    """peft state dict (reference `lora_weights.pt`) -> framework tree.

    The exact inverse of `lora_to_peft_state_dict`; values may be torch
    tensors or arrays. Unknown keys raise (a truncated or off-target
    checkpoint should fail loudly, not merge partially).
    """
    tree: dict[str, Any] = {}
    for key, val in sd.items():
        k = key.removeprefix(_PEFT_PREFIX)
        parts = k.split(".")
        # tolerate an explicit adapter-name segment (peft "default")
        if len(parts) == 7 and parts[5] == "default":
            parts = parts[:5] + parts[6:]
        if (
            len(parts) != 6
            or parts[0] != "blocks"
            or not parts[1].isdigit()
            or parts[2] not in _ATTNS
            or parts[3] not in _TARGETS
            or parts[4] not in ("lora_A", "lora_B")
            or parts[5] != "weight"
        ):
            raise ValueError(
                f"unrecognized peft LoRA key {key!r} — expected "
                "blocks.N.{self_attn|cross_attn}.{qkv|q|context_kv|proj}"
                ".lora_{A|B}.weight (reference model.py:487-490 format)"
            )
        v = np.asarray(
            val.detach().cpu().numpy() if hasattr(val, "detach") else val
        )
        node = tree.setdefault(f"blocks_{parts[1]}", {}).setdefault(
            parts[2], {}
        ).setdefault(parts[3], {})
        node["lora_a" if parts[4] == "lora_A" else "lora_b"] = _t(v)
    ranks: dict[str, int] = {}
    for block, attns in tree.items():
        for attn, targets in attns.items():
            for target, factors in targets.items():
                missing = {"lora_a", "lora_b"} - set(factors)
                if missing:
                    raise ValueError(
                        f"{block}/{attn}/{target}: missing {missing} factor"
                    )
                if factors["lora_a"].shape[1] != factors["lora_b"].shape[0]:
                    raise ValueError(
                        f"{block}/{attn}/{target}: rank mismatch between "
                        f"A {factors['lora_a'].shape} and "
                        f"B {factors['lora_b'].shape}"
                    )
                ranks[f"{block}/{attn}/{target}"] = factors["lora_a"].shape[1]
    # The pipeline scales every target with one alpha/rank (train/lora.py
    # merge); a peft adapter built with `rank_pattern` (per-module ranks)
    # would silently mis-scale everything but the first target found.
    if len(set(ranks.values())) > 1:
        by_rank: dict[int, str] = {}
        for path, r in ranks.items():
            by_rank.setdefault(r, path)
        raise ValueError(
            "mixed-rank peft adapters are unsupported: a single alpha/rank "
            "scale is applied to every target at merge time, but this "
            "adapter uses per-module ranks "
            + ", ".join(f"r={r} (e.g. {p})" for r, p in sorted(by_rank.items()))
        )
    return tree
