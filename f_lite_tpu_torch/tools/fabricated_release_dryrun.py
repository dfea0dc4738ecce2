"""Day-one check that a released checkpoint loads and serves, at full size
(counterpart of the repo tool `tools/fabricated_release_dryrun.py`).

The port downloads nothing, and the released `Freepik/F-Lite*` weights
need not be at hand. What can be shown without them is that the whole
day-one path works at the release's true size and layout:

1. `fabricate_snapshot` writes a random checkpoint in the released
   diffusers layout: the DiT under the reference's key names, drawn as the
   reference fabricator `make_random_state_dict` draws them (one generator
   seeded with `seed`, its key order; std 0.5/sqrt(fan_in) for matrices and
   convolutions, norm weights 1 + N(0, 0.05^2), other vectors N(0, 0.05^2),
   register tokens N(0, 1), `lambda_v` U(0, 1)), and a Flux-shaped VAE in
   diffusers naming (a second generator seeded `seed + 1`, every tensor
   N(0, 1) x 0.05, in the reference's diffusers key order). The shapes are
   the port's meta-device `DiT` and `AutoencoderKL`'s, and the DiT's key
   set is matched against the checked-in manifest before anything is drawn
   or written;
2. the snapshot is ingested by `resolve_pretrained` with strict key
   coverage (`F_LITE_STRICT_INGEST=error`: a dropped or missing key
   raises; the caller's value comes back afterwards);
3. the converted directory is loaded in bf16 with int8 W8A8 projections
   (`quantize=True`, the serving mode) and renders a 30-step 1024 px image
   `--repeats` times from seeded embeddings (the JAX tool's);
4. the report records the fabricate, convert and load seconds, p50
   seconds per image after the first, and device memory.

With a CPU generator (`--device cpu`) the fabricated tensors are bit-equal
to the JAX tool's. On the card (the default) they are drawn there: another
random stream, equally valid for the check, and seconds instead of the
minutes 4.75B draws take on a host. Files go through the port's own
safetensors writer and PNG codec; nothing here needs JAX, `safetensors` or
PIL. Without a card and without `--device cpu` the tool raises.

    python -m f_lite_tpu_torch.tools.fabricated_release_dryrun \\
        --manifest freepik-f-lite-7b --workdir /dev/shm/release

The 7B snapshot and its conversion take about 19 GB each (fp32).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import resource
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from f_lite_tpu_torch.convert.manifest import MANIFEST_DIR

DEFAULT_OUT = "FABRICATED_RELEASE_DRYRUN_TORCH.json"
SAMPLE_PNG = "fabricated_release_sample_torch.png"

_NORM_WEIGHT = re.compile(r"(^|\.)(context_norm|final_norm|norm[123])\.weight$")


def dit_config(manifest: dict):
    """The `DiTConfig` a manifest's `config` names (the other fields at
    their defaults, as in the JAX tool)."""
    from f_lite_tpu_torch.models.dit import DiTConfig

    mc = manifest["config"]
    return DiTConfig(
        hidden_size=mc["hidden_size"], depth=mc["depth"],
        num_heads=mc["num_heads"],
        cross_attn_input_size=mc["cross_attn_input_size"],
        residual_v=mc["residual_v"],
        train_bias_and_rms=mc["train_bias_and_rms"],
    )


def dit_draw_order(cfg) -> list[str]:
    """The DiT's reference key names in the order the reference fabricator
    (`make_random_state_dict`) draws them."""
    bias = cfg.train_bias_and_rms
    names = ["context_proj.weight", "context_proj.bias", "context_norm.weight",
             "patch_embed.patch_proj.weight", "patch_embed.patch_proj.bias",
             "register_tokens", "time_embed.0.weight", "time_embed.0.bias",
             "time_embed.2.weight", "time_embed.2.bias",
             "final_modulation.1.weight", "final_modulation.1.bias",
             "final_proj.weight", "final_proj.bias"]
    if cfg.adaln_mode == "shared":
        names += ["adaLN_modulation.1.weight", "adaLN_modulation.1.bias"]
    if bias:
        names.append("final_norm.weight")
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        names += [f"{b}.norm1.weight", f"{b}.norm3.weight",
                  f"{b}.self_attn.qkv.weight", f"{b}.self_attn.proj.weight"]
        if bias:
            names.append(f"{b}.self_attn.qkv.bias")
        if cfg.residual_v and i > 0:
            names.append(f"{b}.self_attn.lambda_v")
        names += [f"{b}.mlp.gate_proj.weight", f"{b}.mlp.up_proj.weight",
                  f"{b}.mlp.down_proj.weight"]
        if cfg.adaln_mode == "per_block":
            names += [f"{b}.adaLN_modulation.1.weight", f"{b}.adaLN_modulation.1.bias"]
        if cfg.block_has_cross_attn(i):
            names += [f"{b}.norm2.weight", f"{b}.cross_attn.q.weight",
                      f"{b}.cross_attn.context_kv.weight", f"{b}.cross_attn.proj.weight"]
            if bias:
                names += [f"{b}.cross_attn.q.bias", f"{b}.cross_attn.context_kv.bias"]
    return names


def vae_draw_order(cfg) -> list[str]:
    """The VAE's diffusers `AutoencoderKL` key names in the reference's
    order (encoder, then decoder; each resnet's norm1, conv1, norm2, conv2,
    shortcut; each attention's group_norm, to_q, to_k, to_v, to_out.0)."""
    names: list[str] = []

    def pair(name):
        names.extend((f"{name}.weight", f"{name}.bias"))

    def resnet(base, cin, cout):
        for part in ("norm1", "conv1", "norm2", "conv2"):
            pair(f"{base}.{part}")
        if cin != cout:
            pair(f"{base}.conv_shortcut")

    def attn(base):
        for part in ("group_norm", "to_q", "to_k", "to_v", "to_out.0"):
            pair(f"{base}.{part}")

    chans = list(cfg.block_out_channels)
    pair("encoder.conv_in")
    prev = chans[0]
    for i, ch in enumerate(chans):
        for j in range(cfg.layers_per_block):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", prev if j == 0 else ch, ch)
        prev = ch
        if i < len(chans) - 1:
            pair(f"encoder.down_blocks.{i}.downsamplers.0.conv")
    resnet("encoder.mid_block.resnets.0", chans[-1], chans[-1])
    attn("encoder.mid_block.attentions.0")
    resnet("encoder.mid_block.resnets.1", chans[-1], chans[-1])
    pair("encoder.conv_norm_out")
    pair("encoder.conv_out")
    rchans = chans[::-1]
    pair("decoder.conv_in")
    resnet("decoder.mid_block.resnets.0", rchans[0], rchans[0])
    attn("decoder.mid_block.attentions.0")
    resnet("decoder.mid_block.resnets.1", rchans[0], rchans[0])
    prev = rchans[0]
    for i, ch in enumerate(rchans):
        for j in range(cfg.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", prev if j == 0 else ch, ch)
        prev = ch
        if i < len(rchans) - 1:
            pair(f"decoder.up_blocks.{i}.upsamplers.0.conv")
    pair("decoder.conv_norm_out")
    pair("decoder.conv_out")
    return names


def _shapes(module, order: list[str], what: str) -> dict[str, tuple]:
    """{name: shape} of a meta-device module's state dict, in `order`; a
    module whose key set is not `order`'s raises."""
    sd = module.state_dict()
    if set(sd) != set(order) or len(order) != len(sd):
        raise RuntimeError(f"the port's {what} keys differ from the release's: "
                           f"{sorted(set(sd) ^ set(order))[:5]}")
    return {k: tuple(sd[k].shape) for k in order}


def snapshot_shapes(manifest: dict) -> tuple[dict, dict]:
    """({DiT name: shape}, {VAE name: shape}) in draw order, from the port's
    meta-device `DiT` and `AutoencoderKL`, after the DiT's key set is
    matched against the manifest's (a divergence raises `SystemExit` with
    the JAX tool's message). Draws nothing."""
    from f_lite_tpu_torch.models.dit import DiT
    from f_lite_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    cfg = dit_config(manifest)
    order = dit_draw_order(cfg)
    fabricated = sorted(order)
    expected = sorted(manifest["keys"])
    if fabricated != expected:
        missing = sorted(set(expected) - set(fabricated))
        extra = sorted(set(fabricated) - set(expected))
        raise SystemExit(
            f"fabricated key set diverges from manifest: "
            f"missing={missing[:5]} extra={extra[:5]}"
        )
    vae_cfg = VAEConfig.flux()
    with torch.device("meta"):
        dit_shapes = _shapes(DiT(cfg), order, "DiT")
        vae_shapes = _shapes(AutoencoderKL(vae_cfg), vae_draw_order(vae_cfg), "VAE")
    return dit_shapes, vae_shapes


def _draw_dit(shapes: dict, generator, device) -> dict[str, torch.Tensor]:
    def r(shape, scale=None):
        if scale is None:
            fan_in = 1
            for s in shape[1:]:
                fan_in *= s
            scale = 0.5 / fan_in ** 0.5 if fan_in > 1 else 0.05
        return torch.randn(shape, generator=generator, device=device) * scale

    sd = {}
    for name, shape in shapes.items():
        if name == "register_tokens":
            sd[name] = r(shape, scale=1.0)
        elif name.endswith(".lambda_v"):
            sd[name] = torch.rand(shape, generator=generator, device=device)
        elif _NORM_WEIGHT.search(name):
            sd[name] = 1 + r(shape)
        else:
            sd[name] = r(shape)
    return sd


def _host_peak_gb() -> float:
    """The process's peak resident memory so far (getrusage), GB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def fabricate_snapshot(manifest: dict, out: Path, seed: int, device="cpu") -> dict:
    """Write a diffusers-layout snapshot with random full-size weights to
    `out` (`dit_model/diffusion_pytorch_model.safetensors`, `vae/` with its
    `config.json`, `model_index.json`), drawn on `device` (a CPU generator
    gives the JAX tool's tensors bit for bit). Returns the DiT's parameter
    and key counts, the seconds, the GB written and the process's peak host
    memory."""
    from f_lite_tpu_torch.models.vae import VAEConfig
    from f_lite_tpu_torch.utils.safetensors import writer

    device = torch.device(device)
    out = Path(out)
    t0 = time.perf_counter()
    dit_shapes, vae_shapes = snapshot_shapes(manifest)
    files = [out / sub / "diffusion_pytorch_model.safetensors" for sub in ("dit_model", "vae")]

    def write(sd, path):
        # the file holds the tensors in name order, each copied to the host
        # and freed in turn
        path.parent.mkdir(parents=True, exist_ok=True)
        with writer(sd, path) as put:
            for name in sorted(sd):
                put(name, sd.pop(name))

    write(_draw_dit(dit_shapes, torch.Generator(device).manual_seed(seed), device),
          files[0])
    g = torch.Generator(device).manual_seed(seed + 1)
    write({k: torch.randn(shape, generator=g, device=device) * 0.05
           for k, shape in vae_shapes.items()}, files[1])
    (out / "vae" / "config.json").write_text(
        json.dumps(VAEConfig.flux().to_json_dict(), indent=2))
    (out / "model_index.json").write_text(json.dumps({
        "_class_name": "FLitePipeline", "fabricated": True, "seed": seed,
    }, indent=2))
    return {
        "dit_params": sum(int(np.prod(s)) for s in dit_shapes.values()),
        "dit_keys": len(dit_shapes),
        "vae_keys": len(vae_shapes),
        "fabricate_seconds": time.perf_counter() - t0,
        "fabricated_on": str(device),
        "gb_written": sum(f.stat().st_size for f in files) / 1e9,
        "peak_host_rss_gb": _host_peak_gb(),
    }


@contextlib.contextmanager
def strict_ingest():
    """`F_LITE_STRICT_INGEST=error` inside the block; the earlier value (or
    its absence) after it."""
    before = os.environ.get("F_LITE_STRICT_INGEST")
    os.environ["F_LITE_STRICT_INGEST"] = "error"
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("F_LITE_STRICT_INGEST", None)
        else:
            os.environ["F_LITE_STRICT_INGEST"] = before


def convert(snapshot: Path) -> tuple[Path, float]:
    """(the native dir, seconds): `resolve_pretrained` under strict ingest;
    the first call converts and caches, a later one takes the cache."""
    from f_lite_tpu_torch.convert.ingest import resolve_pretrained

    with strict_ingest():
        t0 = time.perf_counter()
        converted = resolve_pretrained(snapshot)
        return converted, time.perf_counter() - t0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def release_embeds(seed: int, width: int) -> np.ndarray:
    """The JAX tool's text embeddings: 128 seeded rows x 0.02, all real."""
    return np.random.RandomState(seed).randn(1, 128, width).astype(np.float32) * 0.02


def serve(pipe, *, size=1024, steps=30, seed=0, repeats=3, png=None) -> dict:
    """`repeats` images of `size` px in `steps` steps from `release_embeds`
    with a `seed` generator on the pipeline's device (JAX's `seed=`):
    seconds of each (the device synchronised), p50 over the runs after the
    first, whether every image is finite; the last image's first sample
    written to `png` (the port's PNG writer) where given."""
    from f_lite_tpu_torch.pipeline import to_uint8
    from f_lite_tpu_torch.utils.image import png_bytes_with_metadata

    device = pipe.device
    embeds = release_embeds(seed, pipe.dit.config.cross_attn_input_size)
    times, finite = [], True
    for i in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        out = pipe(prompt=None, prompt_embeds=embeds, height=size, width=size,
                   num_inference_steps=steps,
                   generator=torch.Generator(device).manual_seed(seed),
                   output_type="np")
        _sync(device)
        times.append(time.perf_counter() - t0)
        finite = finite and bool(np.isfinite(out.images).all())
        print(f"run {i}: {times[-1]:.1f}s", flush=True)
    rest = sorted(times[1:]) or times
    report = {"compile_plus_first_s": times[0],
              "p50_seconds_per_image": rest[len(rest) // 2],
              "seconds_per_image": times, "finite": finite}
    if png is not None:
        image = to_uint8(torch.from_numpy(out.images[0])).numpy()
        Path(png).write_bytes(png_bytes_with_metadata(image, {
            "seed": seed, "steps": steps, "size": size}))
        report["sample_png"] = str(png)
    return report


def device_memory(device: torch.device) -> dict | str:
    """The card's allocator counters in GiB (`torch.cuda.memory_stats`,
    current and peak) and `max_memory_allocated` in GB."""
    if device.type != "cuda":
        return "not measured: the pipeline ran on the CPU"
    stats = torch.cuda.memory_stats(device)
    out = {k: v / 2**30 for k, v in stats.items()
           if "bytes" in k and k.endswith((".all.current", ".all.peak"))}
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Fabricate a full-size random checkpoint in a released "
                    "layout, ingest it strictly and serve it (int8, bf16)")
    ap.add_argument("--manifest", default="freepik-f-lite-7b",
                    help="name under f_lite_tpu_torch/convert/manifests/")
    ap.add_argument("--workdir", default=str(Path(tempfile.gettempdir())
                                             / "fabricated_release_torch"))
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--keep", action="store_true",
                    help="keep the fabricated snapshot + converted dir")
    ap.add_argument("--convert_only", action="store_true",
                    help="stop after fabricate + strict ingest; record a "
                         "partial report. A run without this flag then "
                         "reuses the snapshot and its conversion (implies "
                         "--keep).")
    ap.add_argument("--device", default="cuda",
                    help="where the weights are drawn and the pipeline runs "
                         "(cuda, or cpu)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from f_lite_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    manifest = json.loads((MANIFEST_DIR / f"{args.manifest}.json").read_text())
    work = Path(args.workdir)
    snapshot = work / "snapshot"
    reuse = (snapshot / "model_index.json").exists() and not args.convert_only
    if work.exists() and not reuse:
        shutil.rmtree(work)

    report: dict = {
        "manifest": args.manifest,
        "repo_id": manifest.get("repo_id"),
        "config": manifest["config"],
        "strict_ingest": "error",
        "device": str(device),
    }
    out_path = Path(args.out)
    if reuse:
        # a serving run after a --convert_only one: the snapshot and its
        # converted cache are already there
        print(f"reusing fabricated snapshot at {snapshot}", flush=True)
    else:
        print(f"fabricating {args.manifest} at full size ...", flush=True)
        report.update(fabricate_snapshot(manifest, snapshot, args.seed, device))
        print(f"fabricated in {report['fabricate_seconds']:.1f}s "
              f"({report['dit_params'] / 1e9:.2f}B params)", flush=True)

    converted, report["convert_seconds"] = convert(snapshot)
    print(f"converted (strict) in {report['convert_seconds']:.1f}s "
          f"-> {converted}", flush=True)

    if args.convert_only:
        report["status"] = "converted (serve phase pending)"
        out_path.write_text(json.dumps(report, indent=1))
        print(json.dumps(report, indent=1))
        return report

    from f_lite_tpu_torch.pipeline import FLitePipeline

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    pipe = FLitePipeline.from_pretrained(
        converted, dtype=torch.bfloat16, quantize=True,
        load_text_encoder=False, device=device,
    )
    _sync(device)
    report["load_seconds"] = time.perf_counter() - t0

    report.update(serve(pipe, size=args.size, steps=args.steps, seed=args.seed,
                        repeats=args.repeats,
                        png=out_path.resolve().with_name(SAMPLE_PNG)))
    report["hbm"] = device_memory(device)
    report["status"] = "ok"
    out_path.write_text(json.dumps(report, indent=1))
    print(json.dumps(report, indent=1))

    if not args.keep:
        shutil.rmtree(work, ignore_errors=True)
    return report


if __name__ == "__main__":
    main()
