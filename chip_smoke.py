#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`f_lite_tpu_torch`) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failed check raises and the run exits non-zero):
1. the card's name and power limit; TF32 off, so fp32 means fp32;
2. build the CUDA kernel of the serving path from `f_lite_tpu_torch/csrc`;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, in bf16 and fp32, timed beside the
   plain version, one PyTorch library call of the same function
   (`scaled_dot_product_attention`, a yardstick the port never calls) and
   the card's bound for the work; the largest abs error allowed is 1e-5 in
   fp32 and 5% of the plain fp32 result's rms in bf16
   (`flash_attention.tolerance`), printed with each shape;
4. the committed trained fixture (`artifacts/fixture_run/pipeline`): 4
   requests of the 24 shape captions, 64x64 px, 30 steps, g=6; the images
   must be classified right (both_acc >= 0.95) and the attention kernel
   must have been launched exactly 4 * 30 * 12 times;
5. one 7B-width request (DiT f_lite_7b + Flux VAE decoder, seeded random
   weights on the card): 1024x1024, 30 steps, g=6, 128 text tokens of which
   77 are real; finite output, exactly 30 * 56 kernel launches;
6. a `{"kernels": [...]}` line, then the card line, then the last line
   `{"ok": true, "device": {...}}`.

Exits non-zero, printing no result, where `torch.cuda.is_available()` is
false or the package is missing.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "artifacts" / "fixture_run" / "pipeline"

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# fixture classes (own copy of tools/make_shapes_dataset.py constants)
COLORS = {
    "red": (220, 40, 40),
    "green": (40, 180, 60),
    "blue": (50, 80, 220),
    "yellow": (230, 210, 50),
    "purple": (150, 60, 200),
    "cyan": (60, 200, 210),
    "orange": (235, 140, 40),
    "white": (245, 245, 245),
}
SHAPES = ("circle", "square", "triangle")
BACKGROUND = (110, 110, 110)


def classify(img):
    """img (H, W, 3) float in [-1, 1] -> (color_name, shape_name): nearest
    colour anchor of the non-background pixels, and the shape whose
    bounding-box fill ratio is nearest (own copy of the fixture audit's
    geometric classifier)."""
    import numpy as np

    rgb = (np.clip(img, -1, 1) + 1.0) * 127.5
    bg = np.asarray(BACKGROUND, np.float32)
    mask = np.linalg.norm(rgb - bg, axis=-1) > 60.0
    if mask.mean() < 0.02:
        return None, None
    mean_rgb = rgb[mask].mean(axis=0)
    color = min(
        COLORS, key=lambda c: np.linalg.norm(mean_rgb - np.asarray(COLORS[c]))
    )
    ys, xs = np.nonzero(mask)
    fill = mask.sum() / float((ys.max() - ys.min() + 1) * (xs.max() - xs.min() + 1))
    ratios = {"triangle": 0.5, "circle": np.pi / 4, "square": 0.97}
    shape = min(ratios, key=lambda s: abs(fill - ratios[s]))
    return color, shape


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Mean device time of fn() in ms, with CUDA events, after warm-up;
    as many launches (3 to 50) as fit in about 0.2 s."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(3, min(50, int(0.2 / max(time.perf_counter() - t0, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 3: the flash-attention kernel against its plain version
# ---------------------------------------------------------------------------

# (label, B, H, Lq, Lk, D, kv_lens or None)
ATTN_SHAPES = [
    ("fixture_self", 48, 4, 1040, 1040, 64, None),
    ("fixture_cross", 48, 4, 1040, 32, 64, [32] * 48),
    ("7b_self", 2, 10, 4112, 4112, 256, None),
    ("7b_cross", 2, 10, 4112, 128, 256, [77, 128]),
    ("odd_d64", 3, 2, 333, 77, 64, [77, 0, 41]),
    ("odd_d256", 2, 3, 130, 93, 256, [0, 93]),
]


def attention_bound_ms(b, h, lq, lk, d, kv_lens, dtype_name) -> tuple:
    keys = sum(kv_lens) if kv_lens is not None else b * lk
    item = 2 if dtype_name == "bfloat16" else 4
    flops = 4.0 * h * lq * d * keys
    nbytes = item * (2 * b * h * lq * d + 2 * h * d * keys)
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_attention() -> list[dict]:
    import torch
    import torch.nn.functional as F

    from f_lite_tpu_torch.ops.cuda import flash_attention as fa

    rows = []
    gen = torch.Generator("cuda").manual_seed(0)
    for label, b, h, lq, lk, d, kv in ATTN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).removeprefix("torch.")
            q, k, v = (
                torch.randn((b, h, n, d), generator=gen, device="cuda",
                            dtype=dtype)
                for n in (lq, lk, lk)
            )
            lens = None if kv is None else torch.tensor(
                kv, dtype=torch.int32, device="cuda")
            got = fa.flash_attention(q, k, v, lens)
            torch.cuda.synchronize()
            ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), lens)
            err = float((got.float() - ref).abs().max())
            tol = fa.tolerance(ref, dtype)
            if not math.isfinite(err) or err > tol:
                raise AssertionError(
                    f"flash_attention {label} {name}: max abs err {err} > {tol}"
                )
            mask = None if lens is None else (
                torch.arange(lk, device="cuda")[None, :] < lens[:, None]
            )[:, None, None, :]
            ms = time_ms(lambda: fa.flash_attention(q, k, v, lens))
            plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, lens))
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask))
            bound, bound_by = attention_bound_ms(b, h, lq, lk, d, kv, name)
            row = dict(shape=label, dtype=name, q=[b, h, lq, d],
                       kv=[b, h, lk, d], kv_lens=kv, max_abs_err=err,
                       tolerance=tol, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound, bound_by=bound_by)
            log("attention", json.dumps(row))
            rows.append(row)
            del q, k, v, got, ref
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 4: the trained fixture
# ---------------------------------------------------------------------------

def run_fixture(n_requests=4, steps=30, guidance=6.0) -> dict:
    import numpy as np
    import torch

    from f_lite_tpu_torch.ops.cuda.flash_attention import LAUNCHES
    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.text.encoder import ZeroTextEncoder

    pipe = FLitePipeline.from_pretrained(FIXTURE, dtype=torch.bfloat16)
    cfg = pipe.dit.config
    classes = [(c, s) for c in COLORS for s in SHAPES]
    embeds, mask = ZeroTextEncoder(cfg.cross_attn_input_size, seq_len=32).encode(
        [f"a {c} {s}" for c, s in classes]
    )
    n_blocks = cfg.depth + sum(cfg.block_has_cross_attn(i) for i in range(cfg.depth))
    expected = n_requests * steps * n_blocks

    both = 0
    seconds = []
    LAUNCHES.reset()
    for seed in range(n_requests):
        latents = np.random.RandomState(seed).randn(
            len(classes), 64, 64, cfg.in_channels).astype(np.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe(prompt_embeds=embeds, context_mask=mask, latents=latents,
                   num_inference_steps=steps, guidance_scale=guidance,
                   output_type="np")
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        imgs = out.images
        if imgs.shape != (len(classes), 64, 64, 3) or not np.isfinite(imgs).all():
            raise AssertionError(f"fixture images: shape {imgs.shape} or non-finite")
        both += sum(classify(img) == cls for img, cls in zip(imgs, classes))
    launches = LAUNCHES.count
    n = n_requests * len(classes)
    res = dict(requests=n_requests, images=n, both_acc=both / n,
               s_per_request=seconds, launches=launches,
               expected_launches=expected)
    log("fixture", json.dumps(res))
    if launches != expected:
        raise AssertionError(f"fixture: {launches} kernel launches, expected {expected}")
    if both / n < 0.95:
        raise AssertionError(f"fixture: both_acc {both / n} < 0.95")
    del pipe
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 5: one 7B-width request at 1024 px
# ---------------------------------------------------------------------------

def run_7b(steps=30, guidance=6.0, size=1024, text_len=128, real_len=77) -> dict:
    import numpy as np
    import torch

    from f_lite_tpu_torch.models.dit import DiT, DiTConfig
    from f_lite_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from f_lite_tpu_torch.ops.cuda.flash_attention import LAUNCHES
    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.utils.random_weights import randomize_

    cfg = DiTConfig.f_lite_7b()
    with torch.device("cuda"):
        prev = torch.get_default_dtype()
        torch.set_default_dtype(torch.bfloat16)
        try:
            dit = DiT(cfg).eval()
        finally:
            torch.set_default_dtype(prev)
        vae = AutoencoderKL(VAEConfig.flux()).eval()
    randomize_(dit, seed=1)
    randomize_(vae, seed=2)
    n_params = sum(p.numel() for p in dit.parameters())
    pipe = FLitePipeline(dit, vae)

    rs = np.random.RandomState(3)
    embeds = (rs.randn(1, text_len, cfg.cross_attn_input_size) * 0.02).astype(np.float32)
    mask = np.arange(text_len)[None, :] < real_len
    n_blocks = cfg.depth + sum(cfg.block_has_cross_attn(i) for i in range(cfg.depth))
    expected = steps * n_blocks

    marks = {}
    finite = []

    def pre_decode(_m, _inp):
        torch.cuda.synchronize()
        marks["decode_start"] = time.perf_counter()

    def post_decode(_m, _inp, out):
        finite.append(bool(torch.isfinite(out).all()))
        torch.cuda.synchronize()
        marks["decode_end"] = time.perf_counter()

    hooks = [vae.decoder.register_forward_pre_hook(pre_decode),
             vae.decoder.register_forward_hook(post_decode)]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    LAUNCHES.reset()
    t0 = time.perf_counter()
    out = pipe(prompt_embeds=embeds, context_mask=mask, height=size, width=size,
               num_inference_steps=steps, guidance_scale=guidance,
               generator=torch.Generator("cuda").manual_seed(4),
               output_type="uint8")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = LAUNCHES.count
    for hk in hooks:
        hk.remove()

    img = out.images
    denoise_s = marks["decode_start"] - t0
    res = dict(params=n_params, image=list(img.shape), dtype=str(img.dtype),
               s_per_step=denoise_s / steps, decode_s=marks["decode_end"] - marks["decode_start"],
               s_per_image=total, max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches, expected_launches=expected,
               decoded_finite=finite == [True])
    log("7b", json.dumps(res))
    if img.shape != (1, size, size, 3) or img.dtype != np.uint8:
        raise AssertionError(f"7B image {img.shape} {img.dtype}")
    if finite != [True]:
        raise AssertionError("7B decoded image holds NaN or Inf")
    if launches != expected:
        raise AssertionError(f"7B: {launches} kernel launches, expected {expected}")
    res["step_profile"] = profile_step(
        lambda: pipe(prompt_embeds=embeds, context_mask=mask, height=size,
                     width=size, num_inference_steps=1,
                     guidance_scale=guidance, output_type="latent"))
    del pipe, dit, vae
    torch.cuda.empty_cache()
    return res


def profile_step(run_one_step) -> dict:
    """Device time of one denoise step by kernel class, from torch.profiler
    (launches here come after the counts were read)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run_one_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_one_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    def dev_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) / 1e3
    busy = sum(dev_ms(e) for e in kernels)
    classes = {"flash_attention_fwd": 0.0, "matmul": 0.0, "other": 0.0}
    for e in kernels:
        n = e.key.lower()
        if "flash_fwd" in n:
            classes["flash_attention_fwd"] += dev_ms(e)
        elif any(w in n for w in ("gemm", "nvjet", "xmma", "cutlass", "sm90")):
            classes["matmul"] += dev_ms(e)
        else:
            classes["other"] += dev_ms(e)
    top = sorted(kernels, key=dev_ms, reverse=True)[:12]
    res = dict(wall_ms=wall_ms, device_busy_ms=busy,
               idle_share=(1.0 - busy / wall_ms) if busy else None,
               by_class_ms=classes,
               top=[dict(name=e.key[:90], ms=dev_ms(e), count=e.count) for e in top])
    log("step_profile", json.dumps(res))
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from f_lite_tpu_torch.ops.cuda.build import library_path, load

    card = card_line()
    log("card:", card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    load("flash_attention_fwd")
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for line in library_path("flash_attention_fwd").with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")

    rows = check_attention()
    fixture = run_fixture()
    big = run_7b()

    main_row = next(r for r in rows if r["shape"] == "7b_self" and r["dtype"] == "bfloat16")
    kernel = dict(
        name="flash_attention_fwd",
        route="cuda",
        source="f_lite_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="f_lite_tpu/ops/pallas/flash_attention.py:92",
        replaces_function="_fa_fwd_kernel",
        launches=big["launches"],
        launches_fixture=fixture["launches"],
        max_abs_err=max(r["max_abs_err"] for r in rows),
        max_err_over_tolerance=max(r["max_abs_err"] / r["tolerance"] for r in rows),
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"],
        at="7b_self bfloat16",
        shapes=rows,
    )
    log(json.dumps({"kernels": [kernel]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
