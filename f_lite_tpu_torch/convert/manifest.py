"""Expected torch-key manifests of reference checkpoints and the coverage
checks of ingest (the port's copy of `f_lite_tpu/convert/manifest.py`).

The reference loads released weights with `strict=False`, so a key it does
not use, or one it lacks, is dropped without a word. Here that is loud:

- `expected_torch_keys(config)` is the full torch state-dict key set a
  `DiTConfig` implies (the key set of the port's own `DiT(config)`).
- `coverage_report(present, consumed, config)` diffs what a conversion
  read against what the source shipped and what the config implies.
- `check_coverage(...)` turns the report into a warning or a raised
  `KeyCoverageError` (mode off | warn | error, default warn; env
  `F_LITE_STRICT_INGEST`).
- `manifests/*.json` are the expected-key manifests of the three released
  repos (copies of the JAX package's, held byte-equal by a test), so a
  local snapshot can be matched to its repo offline (`match_manifest`).

residual_v: the released 10B/7B checkpoints carry a value-residual mix
parameter that exists only in the HF-side model code. Its name and place
here, `blocks.{i}.self_attn.lambda_v` for i >= 1, shape (1,), is the JAX
package's reconstruction; if real weights differ, the coverage report
names their keys instead of dropping them.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Mapping

MANIFEST_DIR = Path(__file__).parent / "manifests"

#: repo id -> checked-in manifest filename (released checkpoints,
#: the reference's `comfyui.py:31-35`)
REPO_MANIFESTS = {
    "Freepik/F-Lite": "freepik-f-lite.json",
    "Freepik/F-Lite-Texture": "freepik-f-lite-texture.json",
    "Freepik/F-Lite-7B": "freepik-f-lite-7b.json",
}


class KeyCoverageError(RuntimeError):
    """A checkpoint's torch keys don't line up with the model config."""


def expected_torch_keys(config) -> set[str]:
    """Full torch state-dict key set implied by a DiTConfig.

    Derived from the reference module tree — every inclusion rule cites
    the line that creates (or omits) the parameter:
    - `context_proj` is a default nn.Linear -> weight+bias (`model.py:436`);
      `context_norm` is a LigerRMSNorm -> weight (`model.py:437`).
    - rope buffers are registered persistent=False (`model.py:352-353`) so
      they never appear; without rope there is a `positional_embedding`
      (`model.py:444`).
    - qkv/q/context_kv biases exist iff train_bias_and_rms
      (`model.py:465` passes it as qkv_bias); attention out-proj is always
      bias-free (`model.py:156`); QK-norms are non-trainable -> no keys
      (`model.py:158`, QKNorm default trainable=False).
    - the SwiGLU MLP is bias-free gate/up/down (LigerSwiGLUMLP,
      `model.py:256-267`).
    - `final_norm.weight` exists iff train_bias_and_rms (`model.py:474`).
    - v2 per-block AdaLN heads replace the shared one
      (`model_v2.py:269-271` vs `model.py:454`).
    - residual_v -> `blocks.{i}.self_attn.lambda_v` for i >= 1 (informed
      reconstruction — see module docstring).
    """
    keys = {
        "context_proj.weight", "context_proj.bias",
        "context_norm.weight",
        "patch_embed.patch_proj.weight", "patch_embed.patch_proj.bias",
        "register_tokens",
        "time_embed.0.weight", "time_embed.0.bias",
        "time_embed.2.weight", "time_embed.2.bias",
        "final_modulation.1.weight", "final_modulation.1.bias",
        "final_proj.weight", "final_proj.bias",
    }
    if not config.use_rope:
        keys.add("positional_embedding")
    if config.train_bias_and_rms:
        keys.add("final_norm.weight")
    per_block_adaln = config.adaln_mode == "per_block"
    if not per_block_adaln:
        keys.update({"adaLN_modulation.1.weight", "adaLN_modulation.1.bias"})
    qkv_bias = config.train_bias_and_rms
    for i in range(config.depth):
        b = f"blocks.{i}"
        keys.update({
            f"{b}.norm1.weight", f"{b}.norm3.weight",
            f"{b}.self_attn.qkv.weight",
            f"{b}.self_attn.proj.weight",
            f"{b}.mlp.gate_proj.weight",
            f"{b}.mlp.up_proj.weight",
            f"{b}.mlp.down_proj.weight",
        })
        if qkv_bias:
            keys.add(f"{b}.self_attn.qkv.bias")
        if config.residual_v and i > 0:
            keys.add(f"{b}.self_attn.lambda_v")
        if per_block_adaln:
            keys.update({f"{b}.adaLN_modulation.1.weight",
                         f"{b}.adaLN_modulation.1.bias"})
        if config.block_has_cross_attn(i):
            keys.update({
                f"{b}.norm2.weight",
                f"{b}.cross_attn.q.weight",
                f"{b}.cross_attn.context_kv.weight",
                f"{b}.cross_attn.proj.weight",
            })
            if qkv_bias:
                keys.update({f"{b}.cross_attn.q.bias",
                             f"{b}.cross_attn.context_kv.bias"})
    return keys


@dataclass
class CoverageReport:
    """Diff of a conversion's key consumption against source + config."""

    unconsumed: list[str]  # shipped in the source, silently dropped
    missing: list[str]  # config-implied, absent from the source
    extra_consumed: list[str]  # consumed but not in the config manifest

    @property
    def clean(self) -> bool:
        return not (self.unconsumed or self.missing or self.extra_consumed)

    def render(self, source: str = "") -> str:
        def block(title, keys):
            if not keys:
                return ""
            shown = keys[:24]
            more = f"\n    ... and {len(keys) - 24} more" if len(keys) > 24 else ""
            return (f"\n  {title} ({len(keys)}):\n    "
                    + "\n    ".join(shown) + more)

        head = f"key-coverage mismatch{f' for {source}' if source else ''}:"
        return (
            head
            + block("UNCONSUMED source keys (would be silently dropped)",
                    self.unconsumed)
            + block("MISSING expected keys (config implies, source lacks)",
                    self.missing)
            + block("consumed keys OUTSIDE the expected manifest "
                    "(manifest may be stale)", self.extra_consumed)
        )


def coverage_report(
    present: Iterable[str], consumed: Iterable[str], config
) -> CoverageReport:
    present, consumed = set(present), set(consumed)
    expected = expected_torch_keys(config)
    return CoverageReport(
        unconsumed=sorted(present - consumed),
        missing=sorted(expected - present),
        extra_consumed=sorted(consumed - expected),
    )


def strict_mode(override: str | None = None) -> str:
    """Resolve the coverage mode: off | warn (default) | error."""
    mode = override or os.environ.get("F_LITE_STRICT_INGEST", "warn")
    if mode not in ("off", "warn", "error"):
        raise ValueError(
            f"F_LITE_STRICT_INGEST={mode!r}: expected off|warn|error")
    return mode


def check_coverage(
    present: Iterable[str],
    consumed: Iterable[str],
    config,
    *,
    mode: str | None = None,
    source: str = "",
    logger=None,
) -> CoverageReport:
    """Diff + act: warn loudly or raise per `mode` (see strict_mode)."""
    mode = strict_mode(mode)
    report = coverage_report(present, consumed, config)
    if mode == "off" or report.clean:
        return report
    msg = report.render(source)
    if mode == "error":
        raise KeyCoverageError(msg)
    if logger is not None:
        logger.warning("%s", msg)
    return report


# --------------------------------------------------------------------------
# checked-in manifests for the released repos
# --------------------------------------------------------------------------

def manifest_for_repo(repo_id: str) -> dict:
    """Load the checked-in manifest for a released repo id."""
    try:
        name = REPO_MANIFESTS[repo_id]
    except KeyError:
        raise KeyError(f"no checked-in manifest for {repo_id!r}") from None
    return json.loads((MANIFEST_DIR / name).read_text())


def match_manifest(present: Iterable[str]) -> tuple[str, dict] | None:
    """Find the checked-in manifest whose key set a source dir matches
    closest (by |intersection| / |union|), if any is a plausible match
    (>50% overlap). Lets ingest name the released repo a local snapshot
    came from even though the repo id is lost by download time."""
    present = set(present)
    best = None
    for repo_id in REPO_MANIFESTS:
        m = manifest_for_repo(repo_id)
        keys = set(m["keys"])
        score = len(present & keys) / max(len(present | keys), 1)
        if best is None or score > best[0]:
            best = (score, repo_id, m)
    if best and best[0] > 0.5:
        return best[1], best[2]
    return None


def validate_against_manifest(
    present: Iterable[str], manifest: Mapping
) -> tuple[list[str], list[str]]:
    """(missing_from_source, unexpected_in_source) vs a manifest."""
    present = set(present)
    keys = set(manifest["keys"])
    return sorted(keys - present), sorted(present - keys)
