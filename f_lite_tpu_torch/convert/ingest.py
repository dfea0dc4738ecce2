"""Local loading of reference-format checkpoints (the port's copy of
`f_lite_tpu/convert/ingest.py`):

    resolve_pretrained("/path/to/hf_snapshot")    # diffusers dir -> convert
    resolve_pretrained("/path/to/converted_dir")  # already native -> passthrough

A diffusers-layout snapshot (the reference's `save_pretrained`, a hub
snapshot) is converted once to the native layout and cached next to it
(`<dir>/f_lite_tpu_converted/`, or `~/.cache/f_lite_tpu/converted/<digest>`
when the snapshot is read-only; env `F_LITE_TPU_CACHE`), with a
fingerprint of the source files that invalidates the cache when the
snapshot changes. The location, the fingerprint and the native files are
the JAX package's, so a cache either package wrote is valid for the other.

The conversion loads the reference state dict straight into the port's
`DiT` (the reference key names) and `AutoencoderKL` (diffusers names),
strictly, and writes the native layout from them (`convert.to_jax`). Hub
repo ids are not resolved: nothing is downloaded, so a repo id that is no
local path raises with the advice to pass a local snapshot directory.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
import uuid
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)

_REPO_ID_RE = re.compile(r"^[A-Za-z0-9][\w.\-]*/[\w.\-]+$")

# diffusers puts the DiT under one of these subdir names depending on the
# exporter (`f_lite_to_hf.py` writes dit_model/)
_DIT_SUBDIRS = ("dit_model", "transformer", "dit")


# --------------------------------------------------------------------------
# layout detection
# --------------------------------------------------------------------------

def detect_layout(path: Path) -> str | None:
    """"native" (dit/flax_params.safetensors), "diffusers" (a DiT component
    dir with torch weights) or None."""
    path = Path(path)
    if not path.is_dir():
        return None
    if (path / "dit" / "flax_params.safetensors").exists():
        return "native"
    for name in _DIT_SUBDIRS:
        d = path / name
        if d.is_dir() and (
            any(d.glob("*.safetensors")) or any(d.glob("*.bin"))
            or any(d.glob("*.pt"))
            or (d / "diffusion_pytorch_model.safetensors.index.json").exists()
        ):
            return "diffusers"
    return None


def looks_like_repo_id(model: str) -> bool:
    """True for `org/name` strings that are not local paths (an existing
    local path always wins)."""
    return (
        not Path(model).exists()
        and bool(_REPO_ID_RE.match(model))
        and not model.startswith(".")
    )


# --------------------------------------------------------------------------
# torch -> native conversion
# --------------------------------------------------------------------------

def load_torch_state_dict(path: str | Path) -> dict[str, np.ndarray]:
    """A `.pt`/`.bin` (torch.load, weights only) or `.safetensors` file as
    numpy arrays (fp32 for torch files)."""
    from f_lite_tpu_torch.utils.safetensors import load_file

    path = Path(path)
    if path.suffix == ".safetensors":
        return load_file(path)
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.float().numpy() for k, v in sd.items()}


def strip_prefixes(sd: dict) -> dict:
    """Strip `module.` / `_orig_mod.` as the reference's loader does."""
    return {k.replace("module.", "").replace("_orig_mod.", ""): v
            for k, v in sd.items()}


def infer_depth(sd) -> int:
    """Max block index + 1."""
    idxs = [int(m.group(1)) for k in sd if (m := re.match(r"blocks\.(\d+)\.", k))]
    if not idxs:
        raise ValueError("no `blocks.N.` keys in state dict")
    return max(idxs) + 1


def merge_sharded_safetensors(d: Path, prefix="diffusion_pytorch_model"):
    """The weights of a diffusers component dir: sharded or single
    safetensors, else legacy `.bin` / `.pt` files."""
    from f_lite_tpu_torch.utils.safetensors import load_file

    idx = d / f"{prefix}.safetensors.index.json"
    if idx.exists():
        index = json.loads(idx.read_text())
        sd = {}
        for f in sorted(set(index["weight_map"].values())):
            sd.update(load_file(d / f))
        return sd
    single = d / f"{prefix}.safetensors"
    if single.exists():
        return load_file(single)
    cands = sorted(d.glob("*.safetensors"))
    if cands:
        sd = {}
        for f in cands:
            sd.update(load_file(f))
        return sd
    bins = sorted(d.glob("*.bin")) + sorted(d.glob("*.pt"))
    if bins:
        sd = {}
        for f in bins:
            sd.update(load_torch_state_dict(f))
        return sd
    raise FileNotFoundError(f"no weights found in {d}")


def dit_config_from_state_dict(
    sd,
    hf_config=None,
    *,
    width: int = 3072,
    head_dim: int = 256,
    patch_size: int = 2,
    mlp_ratio: float = 4.0,
    cross_attn_input_size: int = 4096,
    residual_v: bool = True,
    train_bias_and_rms: bool = False,
):
    """A `DiTConfig` from a reference torch state dict and, where given, the
    HF `config.json` dict. What the weights show is read from them; the
    keyword flags are fallbacks for what they do not pin."""
    from f_lite_tpu_torch.models.dit import DiTConfig

    if hf_config:
        w = hf_config.get("hidden_size", width)
        return DiTConfig(
            in_channels=hf_config.get("in_channels", 16),
            patch_size=hf_config.get("patch_size", patch_size),
            hidden_size=w,
            depth=hf_config.get("depth", infer_depth(sd)),
            num_heads=hf_config.get("num_heads", w // head_dim),
            mlp_ratio=hf_config.get("mlp_ratio") or (
                sd["blocks.0.mlp.gate_proj.weight"].shape[0] / w
                if "blocks.0.mlp.gate_proj.weight" in sd else 4.0),
            cross_attn_input_size=hf_config.get("cross_attn_input_size",
                                                cross_attn_input_size),
            train_bias_and_rms=hf_config.get("train_bias_and_rms", False),
            use_rope=hf_config.get("use_rope", True),
            rope_base=hf_config.get("rope_base", 10000),
            dynamic_softmax_temperature=hf_config.get(
                "dynamic_softmax_temperature", False),
            residual_v=hf_config.get("residual_v", residual_v),
            adaln_mode=hf_config.get("adaln_mode", "shared"),
            cross_attn_all=hf_config.get("cross_attn_all", False),
            cross_attn_first_n=hf_config.get("cross_attn_first_n", 8),
            cross_attn_period=hf_config.get("cross_attn_period", 4),
        )
    w = sd["context_proj.weight"].shape[0]
    depth = infer_depth(sd)
    return DiTConfig(
        in_channels=sd["patch_embed.patch_proj.weight"].shape[1],
        patch_size=sd["patch_embed.patch_proj.weight"].shape[-1],
        hidden_size=w,
        depth=depth,
        num_heads=w // head_dim,
        mlp_ratio=(sd["blocks.0.mlp.gate_proj.weight"].shape[0] / w
                   if "blocks.0.mlp.gate_proj.weight" in sd else mlp_ratio),
        cross_attn_input_size=sd["context_proj.weight"].shape[1],
        train_bias_and_rms="final_norm.weight" in sd,
        residual_v=residual_v or any(".lambda_v" in k for k in sd),
        adaln_mode=("per_block" if "blocks.0.adaLN_modulation.1.weight" in sd
                    and "adaLN_modulation.1.weight" not in sd else "shared"),
        cross_attn_all=any(f"blocks.{i}.cross_attn.q.weight" in sd
                           for i in range(8, depth) if i % 4 != 0),
    )


def _load_strict(model: torch.nn.Module, sd: dict, consumed: set) -> None:
    """Load the keys of `model` from `sd` (numpy), strictly, as fp32
    tensors that become the model's own (sharing an fp32 array's memory:
    a 7B's weights are 19 GB); record them in `consumed`."""
    keys = set(model.state_dict())
    consumed.update(keys & set(sd))
    model.load_state_dict({k: torch.from_numpy(np.asarray(sd[k], np.float32))
                           for k in keys if k in sd}, strict=True, assign=True)


def _vae_config(vcfg_d: dict):
    from f_lite_tpu_torch.models.vae import VAEConfig

    return VAEConfig(
        latent_channels=vcfg_d.get("latent_channels", 16),
        block_out_channels=tuple(vcfg_d.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=vcfg_d.get("layers_per_block", 2),
        norm_num_groups=vcfg_d.get("norm_num_groups", 32),
        scaling_factor=vcfg_d.get("scaling_factor", 0.3611),
        shift_factor=vcfg_d.get("shift_factor", 0.1159),
        mid_block_add_attention=vcfg_d.get("mid_block_add_attention", True),
    )


def convert_reference_checkpoint(
    output_dir: Path | str,
    *,
    pt: str | Path | None = None,
    hf_dir: str | Path | None = None,
    vae_dir: str | Path | None = None,
    text_encoder_dir: str | Path | None = None,
    tokenizer_dir: str | Path | None = None,
    strict: str | None = None,
    **arch,
) -> Path:
    """Reference torch checkpoint (a raw `.pt` or a diffusers-layout dir) ->
    the native layout `FLitePipeline.from_pretrained` reads.

    `arch` carries the architecture fallbacks (width, head_dim, ...) to
    `dit_config_from_state_dict`; they matter only for a raw `.pt` whose
    shapes do not pin them. `strict` (off | warn | error; default env
    `F_LITE_STRICT_INGEST`, else warn): a source key the DiT does not take
    is logged or raises `KeyCoverageError`; a key the config implies and
    the source lacks always raises it, with the full diff."""
    from f_lite_tpu_torch.convert.manifest import (
        KeyCoverageError,
        check_coverage,
        coverage_report,
        strict_mode,
    )
    from f_lite_tpu_torch.convert.to_jax import (
        state_dict_to_jax,
        vae_state_dict_to_jax,
    )
    from f_lite_tpu_torch.models.dit import DiT
    from f_lite_tpu_torch.models.vae import AutoencoderKL
    from f_lite_tpu_torch.utils.safetensors import save_file

    if (pt is None) == (hf_dir is None):
        raise ValueError("pass exactly one of pt= / hf_dir=")

    out = Path(output_dir)
    (out / "dit").mkdir(parents=True, exist_ok=True)
    vae_src = Path(vae_dir) if vae_dir else None
    te_src = Path(text_encoder_dir) if text_encoder_dir else None
    tok_src = Path(tokenizer_dir) if tokenizer_dir else None
    hf_dit_config = None

    if pt:
        sd = strip_prefixes(load_torch_state_dict(pt))
    else:
        hf = Path(hf_dir)
        dit_dir = next((hf / n for n in _DIT_SUBDIRS if (hf / n).exists()), None)
        if dit_dir is None:
            raise FileNotFoundError(f"no dit_model/ under {hf}")
        sd = strip_prefixes(merge_sharded_safetensors(dit_dir))
        cfg_file = dit_dir / "config.json"
        if cfg_file.exists():
            hf_dit_config = json.loads(cfg_file.read_text())
        vae_src = vae_src or ((hf / "vae") if (hf / "vae").exists() else None)
        te_src = te_src or ((hf / "text_encoder")
                            if (hf / "text_encoder").exists() else None)
        tok_src = tok_src or ((hf / "tokenizer") if (hf / "tokenizer").exists() else None)

    dit_cfg = dit_config_from_state_dict(sd, hf_dit_config, **arch)
    logger.info("DiT: width=%d depth=%d heads=%d cross=%d residual_v=%s",
                dit_cfg.hidden_size, dit_cfg.depth, dit_cfg.num_heads,
                dit_cfg.cross_attn_input_size, dit_cfg.residual_v)
    src_name = str(pt or hf_dir)
    with torch.device("meta"):
        dit = DiT(dit_cfg)
    consumed: set[str] = set()
    report = coverage_report(sd, set(dit.state_dict()) & set(sd), dit_cfg)
    if report.missing:
        raise KeyCoverageError(
            f"conversion of {src_name} failed on missing key "
            f"{report.missing[0]!r}; " + report.render(src_name))
    _load_strict(dit, sd, consumed)
    check_coverage(sd, consumed, dit_cfg, mode=strict, source=src_name,
                   logger=logger)
    (out / "dit" / "config.json").write_text(
        json.dumps(dit_cfg.to_json_dict(), indent=2))
    flat = state_dict_to_jax(dit.state_dict(), dit_cfg)
    del dit, sd  # the source's copy goes before the native one is written
    save_file(flat, out / "dit" / "flax_params.safetensors")
    del flat

    index = {"_class_name": "FLitePipeline", "framework": "f-lite-tpu",
             "return_index": -8}

    if vae_src:
        vae_cfg = _vae_config(json.loads((vae_src / "config.json").read_text()))
        vsd = merge_sharded_safetensors(vae_src)
        with torch.device("meta"):
            vae = AutoencoderKL(vae_cfg)
        v_consumed: set[str] = set()
        _load_strict(vae, vsd, v_consumed)
        v_unconsumed = sorted(set(vsd) - v_consumed)
        if v_unconsumed:
            msg = (f"VAE conversion from {vae_src} dropped "
                   f"{len(v_unconsumed)} source keys: "
                   + ", ".join(v_unconsumed[:16])
                   + (" ..." if len(v_unconsumed) > 16 else ""))
            if strict_mode(strict) == "error":
                raise KeyCoverageError(msg)
            if strict_mode(strict) == "warn":
                logger.warning("%s", msg)
        (out / "vae").mkdir(exist_ok=True)
        (out / "vae" / "config.json").write_text(
            json.dumps(vae_cfg.to_json_dict(), indent=2))
        save_file(vae_state_dict_to_jax(vae.state_dict(), vae_cfg),
                  out / "vae" / "flax_params.safetensors")
        logger.info("converted VAE from %s", vae_src)

    if te_src:
        shutil.copytree(te_src, out / "text_encoder", dirs_exist_ok=True)
        index["text_encoder_type"] = _text_encoder_type(te_src)
        if tok_src:
            shutil.copytree(tok_src, out / "tokenizer", dirs_exist_ok=True)

    (out / "model_index.json").write_text(json.dumps(index, indent=2))
    logger.info("converted checkpoint written to %s", out)
    return out


def _text_encoder_type(te_src: Path) -> str:
    model_type = json.loads((te_src / "config.json").read_text()).get("model_type", "t5")
    if "t5" in model_type:
        return "t5"
    if "qwen2" in model_type:
        return "qwen2"
    return "torch"


# --------------------------------------------------------------------------
# cache + resolution
# --------------------------------------------------------------------------

_CACHE_SUBDIR = "f_lite_tpu_converted"
_FINGERPRINT_FILE = "source_fingerprint.json"


def _source_fingerprint(hf_dir: Path) -> dict:
    """(relpath -> [size, mtime_ns]) of every weight, config and tokenizer
    file the conversion reads or copies."""
    fp = {}
    for pat in ("*.safetensors", "*.bin", "*.pt", "*.json", "*.model", "*.txt"):
        for sub in (".",) + _DIT_SUBDIRS + ("vae", "text_encoder", "tokenizer"):
            d = hf_dir / sub
            if not d.is_dir():
                continue
            for f in sorted(d.glob(pat)):
                st = f.stat()
                fp[str(f.relative_to(hf_dir))] = [st.st_size, st.st_mtime_ns]
    return fp


def _default_cache_root() -> Path:
    env = os.environ.get("F_LITE_TPU_CACHE")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "f_lite_tpu" / "converted"


def _cache_dir_for(hf_dir: Path) -> Path:
    """Next to the snapshot when it is writable, else the user cache."""
    local = hf_dir / _CACHE_SUBDIR
    if os.access(hf_dir, os.W_OK):
        return local
    digest = hashlib.sha1(str(hf_dir.resolve()).encode()).hexdigest()[:16]
    return _default_cache_root() / f"{hf_dir.name}-{digest}"


def _cache_valid(cache: Path, fp: dict) -> bool:
    fp_file = cache / _FINGERPRINT_FILE
    if detect_layout(cache) != "native" or not fp_file.exists():
        return False
    try:
        return json.loads(fp_file.read_text()) == fp
    except (json.JSONDecodeError, OSError):
        return False


def _convert_with_cache(hf_dir: Path) -> Path:
    cache = _cache_dir_for(hf_dir)
    fp = _source_fingerprint(hf_dir)
    if _cache_valid(cache, fp):
        logger.info("using cached conversion at %s", cache)
        return cache
    # convert into a temp sibling of our own, then rename into place: a
    # crashed conversion leaves no half-written native dir, and concurrent
    # first-use converters never delete each other's work; a stale cache
    # is moved aside atomically (open readers keep their files)
    tmp = cache.with_name(f"{cache.name}.tmp-{uuid.uuid4().hex[:8]}")
    try:
        convert_reference_checkpoint(tmp, hf_dir=hf_dir)
        (tmp / _FINGERPRINT_FILE).write_text(json.dumps(fp, indent=2))
        for _ in range(8):  # bounded: alternating racers are pathological
            try:
                tmp.rename(cache)
                logger.info("conversion cached at %s", cache)
                return cache
            except OSError:
                pass
            # the target exists: a concurrent converter won (use theirs) or
            # it converts an older snapshot (move it aside and retry)
            if _cache_valid(cache, fp):
                shutil.rmtree(tmp, ignore_errors=True)
                logger.info("using concurrently-built cache at %s", cache)
                return cache
            stale = cache.with_name(f"{cache.name}.stale-{uuid.uuid4().hex[:8]}")
            try:
                cache.rename(stale)
            except OSError:
                continue
            shutil.rmtree(stale, ignore_errors=True)
        raise OSError(f"could not install converted checkpoint at {cache}: "
                      "persistent contention from concurrent converters")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def resolve_pretrained(model: str | Path) -> Path:
    """A native layout dir for `model`: a native dir as it is, a
    diffusers-layout snapshot dir converted on first use and cached. A hub
    repo id raises `FileNotFoundError`: the port downloads nothing."""
    p = Path(model)
    if p.exists():
        layout = detect_layout(p)
        if layout == "native":
            return p
        if layout == "diffusers":
            return _convert_with_cache(p)
        raise FileNotFoundError(
            f"{p} is neither a native f-lite-tpu checkpoint "
            "(dit/flax_params.safetensors) nor a diffusers-layout "
            "snapshot (dit_model|transformer/ with torch weights)")
    if looks_like_repo_id(str(model)):
        raise FileNotFoundError(
            f"{str(model)!r} looks like a Hugging Face repo id, but this "
            "package downloads nothing: fetch the snapshot elsewhere and "
            "pass the local directory (or a dir already converted to the "
            "native layout)")
    raise FileNotFoundError(
        f"model {str(model)!r}: no such local path, and it does not look "
        "like a Hugging Face repo id")
