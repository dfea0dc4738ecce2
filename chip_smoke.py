#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`f_lite_tpu_torch`) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failed check raises and the run exits non-zero):
1. the card's name and power limit; TF32 off, so fp32 means fp32;
2. build the CUDA kernels (`f_lite_tpu_torch/csrc/*.cu`, one nvcc each, in
   parallel) and print ptxas' register, spill and warning lines and each
   source's nvcc seconds;
3. the forward kernel (bf16: TMA + wgmma, warp-specialised) against its
   plain PyTorch version on the card, at the shapes the serving and
   training paths give it (7B self and cross at 1024 px, 4112 tokens, and
   at 1280 px, 6416 tokens; the fixture's; training's 1040 tokens; ragged
   tails), in bf16 and fp32, timed beside the plain version, one PyTorch
   library call of the same function (`scaled_dot_product_attention`, a
   yardstick the port never calls) and the card's bound for the work; the
   largest abs error allowed is 1e-5 in fp32 and 5% of the plain fp32
   result's rms in bf16 (`flash_attention.tolerance`), printed with each
   shape; ptxas' lines of its bf16 instances, none of which may spill or
   have its wgmma serialised (C7512);
4. the dq and dkv kernels (bf16: TMA + wgmma, warp-specialised) against
   `flash_attention_bwd_plain` at the training path's shapes and at a head
   dim the wrapper pads (128 -> 256), in bf16 and fp32 (`grad_tolerance`:
   5% of the plain gradient's rms in bf16, with P and dS rounded to bf16
   where the kernels round them, 1e-5 of its largest magnitude in fp32),
   with exact zeros at masked keys and kv_len 0 rows, timed beside the
   plain version, SDPA forward + backward minus forward, and the bound;
   ptxas' register, spill and C7512 lines of the bf16 backward kernels,
   none of which may spill or have its wgmma serialised;
5. the perf lab's variant kernel (`csrc/flash_attention_variants.cu`, on
   the forward's mainloop) against `flash_fwd_plain`: ptxas' lines of its
   42 instances (no spill, no C7512); its seven variants at every block
   pair of `flash_variants.blocks(d)`, at 2x10x4112x256, at 333 keys
   (ragged tiles) with D 256 and 64, and at a head dim the wrapper pads
   (128 -> 256), within `flash_attention.tolerance`, condmask equal to its
   twin bit for bit, each flag's `flag_step` within 0.25 of 1, with the
   plain version's, SDPA's and the bound's ms; then the lab as a user runs
   it (`python -m f_lite_tpu_torch.tools.flash_variants`), its launches
   counted against `blocks(256)`, and its sweep at the other shapes;
6. one 7B-width DiT block with cross-attention and residual_v (bf16
   compute, fp32 weights, 512 px, batch 4): every parameter and input
   gradient through the kernels within 2e-2 (relative norm) of the same
   block through the plain attention;
6a. the int8 kernels (`csrc/int8_gemm.cu`: the per-token quantize and the
   persistent int8 product with its dequant epilogue) against their plain
   versions, bit for bit, at every projection shape of the 7B's and the
   fixture's int8 paths and at the product's grid edges (SMs - 1, SMs,
   SMs + 1 m-tiles and a partial last round at K 144, 2576 and 5136,
   `int8_tiles.edge_shapes`) (bf16 and fp32 input, with and without bias,
   the int32 accumulators too); the path shapes timed beside the plain
   versions, `torch._int_mm` plus the dequant (a yardstick the port never
   calls), bf16 `F.linear` at the same shape (what int8 replaces) and the
   bound; for each of the product's two designs its fixed cost a tile and
   cost a k-tile, fitted with their residual to its times at M 8224, N 7680
   and three K at which the wrapper picks it (`int8_tiles.fit_k_sweep`);
   ptxas' lines of both kernels, none of which may spill or have its wgmma
   serialised;
7. serving, the committed trained fixture (`artifacts/fixture_run/
   pipeline`): 4 requests of the 24 shape captions, 64x64 px, 30 steps,
   g=6; both_acc >= 0.95 and exactly 4 * 30 * 12 forward launches;
8. the fixture again with limited-interval guidance (0.1, 0.9), both_acc
   >= 0.95, and at 15 steps with Euler and with ab2, each one's MSE to
   Euler@30 printed;
8a. int8 serving, the fixture loaded with `quantize=True` (bf16), the
   requests of phase 7: both_acc >= 0.95 and PSNR >= 30 dB against phase
   7's bf16 images (10 log10(4 / MSE) on [-1, 1]); exactly 4 * 30 * 12
   forward and 4 * 30 * 48 launches of each int8 kernel;
9. serving, one 7B-width request (DiT f_lite_7b + Flux VAE, seeded random
   weights): 1024x1024, 30 steps, g=6, 128 text tokens of which 77 are
   real; finite output, exactly 30 * 56 forward launches;
10. image to image with a mask at 1280 px on the same pipeline: strength
   0.5 (15 of 30 steps), the left half repainted, encode and decode tiled
   (9 tiles each); finite output, exactly 15 * 56 forward launches, the
   kept region of the final latents equal to the encoded image's;
11. strength 1.0 without a mask equals text to image bit for bit (256 px);
11a. int8 serving at 7B width: the pipeline of phases 9-11 quantized in
   place (`quant.quantize_dit`), the request of phase 9: finite output,
   exactly 30 * 56 forward and 30 * 248 launches of each int8 kernel,
   s/step, s/image, peak GB and a step profile beside phase 9's;
12. training, the fixture's recipe from scratch through the port's trainer
   (`f_lite_tpu_torch.train`): a precomputed cache of 24 classes x 128
   shapes images (64 px, pixel space) written here, 300 steps at batch 32,
   bf16; the mean logged loss over steps 260-300 must be <= 0.15 (the JAX
   run's `artifacts/fixture_run/train.log` reads 0.073); exactly 12
   launches of each kernel per step; the exported pipeline reloads with
   the same DiT output;
13. training, `f_lite_7b_width_d20_train512`: the 7B's widths at depth 20,
   512 px latents (1040 tokens), batch 4, bf16 with fp32 master weights,
   checkpointing from block 8, 10 steps; finite loss and grad norm,
   exactly 46 forward, 31 dq and 31 dkv launches per step, peak memory
   under 80 GB, and a profile of one step;
14. a `{"kernels": [...]}` line, then the card line, then the last line
   `{"ok": true, "device": {...}}`.
Every path runs with the launch counts set to 0 just before it and read
just after; a kernel of another path launched there fails the run.

Exits non-zero, printing no result, where `torch.cuda.is_available()` is
false or the package is missing.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "artifacts" / "fixture_run" / "pipeline"

# every entry of the {"kernels": [...]} line carries these
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
               "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
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


def reset_counts():
    from f_lite_tpu_torch.ops.cuda import flash_attention as fa
    from f_lite_tpu_torch.ops.cuda import flash_variants as fv
    from f_lite_tpu_torch.ops.cuda import int8_gemm as ig

    for counter in (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES, fv.LAUNCHES,
                    ig.QUANTIZE_LAUNCHES, ig.GEMM_LAUNCHES):
        counter.reset()


def read_counts() -> dict:
    from f_lite_tpu_torch.ops.cuda import flash_attention as fa
    from f_lite_tpu_torch.ops.cuda import flash_variants as fv
    from f_lite_tpu_torch.ops.cuda import int8_gemm as ig

    return dict(fwd=fa.LAUNCHES.count, dq=fa.DQ_LAUNCHES.count,
                dkv=fa.DKV_LAUNCHES.count, variants=fv.LAUNCHES.count,
                quantize=ig.QUANTIZE_LAUNCHES.count, gemm=ig.GEMM_LAUNCHES.count)


def launches(fwd=0, dq=0, dkv=0, variants=0, quantize=0, gemm=0) -> dict:
    """The counts `read_counts` should give."""
    return dict(fwd=fwd, dq=dq, dkv=dkv, variants=variants, quantize=quantize,
                gemm=gemm)


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
    ("train_7b_self", 4, 10, 1040, 1040, 256, None),
    ("train_7b_cross", 4, 10, 1040, 128, 256, [77, 128, 77, 128]),
    ("7b1280_self", 2, 10, 6416, 6416, 256, None),
    ("7b1280_cross", 2, 10, 6416, 128, 256, [77, 128]),
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

    ptxas_check(("flash_attention_fwd",), ("flash_fwd_bf16_kernel",), "forward")
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
# phase 4: the backward kernels against their plain version
# ---------------------------------------------------------------------------

# (label, B, H, Lq, Lk, D, kv_lens or None): the training path's calls
BWD_SHAPES = [
    ("fixture_self", 32, 4, 1040, 1040, 64, None),
    ("fixture_cross", 32, 4, 1040, 32, 64, [32] * 32),
    ("7b_self", 4, 10, 1040, 1040, 256, None),
    ("7b_cross", 4, 10, 1040, 128, 256, [77, 128, 77, 128]),
    ("odd_d64", 3, 2, 333, 77, 64, [77, 0, 41]),
    ("odd_d256", 2, 3, 130, 93, 256, [0, 93]),
    # a head dim with no compiled instance: zero-padded to 256
    ("7b_d128", 4, 10, 1040, 1040, 128, None),
]


def kernel_label(mangled: str, name: str) -> str:
    """`name<template arguments>` of a mangled kernel name, e.g.
    flash_variant_kernel<256,80,1,1,0,0> (D, BK, then the flags)."""
    import re

    args = re.findall(r"L[ib](\d+)E", mangled.split(name, 1)[-1])
    return f"{name}<{','.join(args)}>"


def ptxas_check(sources, names, what) -> list[str]:
    """ptxas' register, spill and warning lines of the kernels named by
    one of `names` in the build logs of `sources`; raises where one spills
    or has its wgmma serialised (C7512)."""
    import re

    from f_lite_tpu_torch.ops.cuda.build import library_path

    lines, bad = [], []
    for source in sources:
        report = library_path(source).with_suffix(".log").read_text()
        kernel = None
        for line in map(str.strip, report.splitlines()):
            if "Compiling entry" in line:
                name = next((n for n in names if n in line), None)
                kernel = name and kernel_label(line, name)
            elif "C7512" in line and any(n in line for n in names):
                lines.append(line)
                bad.append(line)
            elif kernel and ("registers" in line or "spill" in line):
                lines.append(f"{kernel}: {line}")
                spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if spills and spills.groups() != ("0", "0"):
                    bad.append(f"{kernel}: {line}")
    for line in lines:
        log(f"  ptxas {what}: {line}")
    if bad:
        raise AssertionError(f"{what} kernels spill or serialise: {bad}")
    return lines


def backward_ptxas() -> list[str]:
    """ptxas' lines of the bf16 backward kernels; raises where one spills
    or has its wgmma serialised (C7512)."""
    return ptxas_check(("flash_attention_bwd",),
                       ("flash_bwd_dq_bf16", "flash_bwd_dkv_bf16"), "backward")


def backward_bound_ms(b, h, lq, lk, d, kv_lens, dtype_name, which) -> tuple:
    """The least time of the work on an H100 SXM: products over the real
    keys (dq: 3 -> 6*H*Lq*D*keys flops, dkv: 4 -> 8*..., the pair: 14, a
    fused design's least: 5 -> 10*...), against the bytes read and written
    once (k, v over the real keys; lse and D fp32)."""
    keys = sum(kv_lens) if kv_lens is not None else b * lk
    item = 2 if dtype_name == "bfloat16" else 4
    q_rows = b * h * lq * d * item      # q, dO, O or dq
    kv_real = h * keys * d * item      # k or v, real keys only
    kv_all = b * h * lk * d * item     # dk or dv, every key written
    stats = b * h * lq * 4             # lse or D
    products, nbytes = {
        "dq": (3, 2 * q_rows + 2 * kv_real + 2 * stats + q_rows),
        "dkv": (4, 2 * q_rows + 2 * kv_real + 2 * stats + 2 * kv_all),
        "pair": (7, 3 * q_rows + 2 * kv_real + 2 * stats + q_rows + 2 * kv_all),
        "fused": (5, 3 * q_rows + 2 * kv_real + 2 * stats + q_rows + 2 * kv_all),
    }[which]
    t_ops = 2.0 * products * h * lq * d * keys / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def sdpa_backward_ms(q, k, v, dout, mask):
    """SDPA forward + backward minus forward (a yardstick the port never
    calls); None where no SDPA backend takes the shape."""
    import torch
    import torch.nn.functional as F

    qq, kk, vv = (x.detach().clone().requires_grad_() for x in (q, k, v))

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)

    def fwd_bwd():
        F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask).backward(dout)

    try:
        return time_ms(fwd_bwd) - time_ms(fwd)
    except RuntimeError as err:  # no backend for this shape and dtype
        log(f"  sdpa backward: none ({str(err).splitlines()[0][:120]})")
        return None


def check_backward() -> list[dict]:
    import torch

    from f_lite_tpu_torch.ops.cuda import flash_attention as fa

    backward_ptxas()
    rows = []
    gen = torch.Generator("cuda").manual_seed(1)
    for label, b, h, lq, lk, d, kv in BWD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).removeprefix("torch.")
            q, k, v, dout = (
                torch.randn((b, h, n, d), generator=gen, device="cuda",
                            dtype=dtype)
                for n in (lq, lk, lk, lq)
            )
            lens = None if kv is None else torch.tensor(
                kv, dtype=torch.int32, device="cuda")
            qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
            lse = fa.flash_attention_lse_plain(qf, kf, lens)
            delta = fa.attention_delta(fa.flash_attention_plain(qf, kf, vf, lens), dof)
            got = fa.flash_attention_bwd(q, k, v, dout, lse, delta, lens)
            torch.cuda.synchronize()
            # the plain version rounds P and dS to bf16 where the kernels do
            want = fa.flash_attention_bwd_plain(q, k, v, dout, lse, delta, lens,
                                                out_dtype=torch.float32)
            errs, tols = {}, {}
            for gname, g, w in zip(("dq", "dk", "dv"), got, want):
                errs[gname] = float((g.float() - w).abs().max())
                tols[gname] = fa.grad_tolerance(w, dtype)
                if not math.isfinite(errs[gname]) or errs[gname] > tols[gname]:
                    raise AssertionError(
                        f"backward {label} {name} {gname}: max abs err "
                        f"{errs[gname]} > {tols[gname]}")
            if kv is not None:
                if got[0][lens == 0].any():
                    raise AssertionError(f"backward {label} {name}: dq != 0 at kv_len 0")
                masked = torch.arange(lk, device="cuda")[None, :] >= lens[:, None]
                if any(g.transpose(1, 2)[masked].any() for g in got[1:]):
                    raise AssertionError(f"backward {label} {name}: dk/dv != 0 at masked keys")
            del got, want
            args = (q, k, v, dout, lse, delta, lens)
            dq_ms = time_ms(lambda: fa.flash_attention_bwd_dq(*args))
            dkv_ms = time_ms(lambda: fa.flash_attention_bwd_dkv(*args))
            plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(*args))
            mask = None if lens is None else (
                torch.arange(lk, device="cuda")[None, :] < lens[:, None]
            )[:, None, None, :]
            lib_ms = sdpa_backward_ms(q, k, v, dout, mask)
            bounds = {w: backward_bound_ms(b, h, lq, lk, d, kv, name, w)
                      for w in ("dq", "dkv", "pair", "fused")}
            row = dict(shape=label, dtype=name, q=[b, h, lq, d],
                       kv=[b, h, lk, d], kv_lens=kv, max_abs_err=errs,
                       tolerance=tols, dq_ms=dq_ms, dkv_ms=dkv_ms,
                       pair_ms=dq_ms + dkv_ms, plain_ms=plain_ms,
                       library_ms=lib_ms,
                       bound_ms={w: bd[0] for w, bd in bounds.items()},
                       bound_by={w: bd[1] for w, bd in bounds.items()})
            log("backward", json.dumps(row))
            rows.append(row)
            del q, k, v, dout, qf, kf, vf, dof, lse, delta
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 5: the perf lab's variant kernel against its plain version, then the
# lab itself
# ---------------------------------------------------------------------------

# (label, B, H, L, D): the lab's default shape, ragged key tails, and a
# head dim the wrapper pads (128 -> 256)
VARIANT_SHAPES = [
    ("7b_serving", 2, 10, 4112, 256),
    ("ragged_d256", 1, 2, 333, 256),
    ("ragged_d64", 1, 2, 333, 64),
    ("padded_d128", 1, 2, 333, 128),
]


def variants_ptxas() -> list[str]:
    """ptxas' lines of every variant kernel instance; raises where one
    spills or has its wgmma serialised."""
    return ptxas_check(("flash_attention_variants",), ("flash_variant_kernel",),
                       "variants")


def check_variants() -> list[dict]:
    """Every variant of `flash_variants.VARIANTS` at every block pair of
    `blocks(d)` against `flash_fwd_plain` at the same block_k (plain in fp32
    on the same bf16 inputs), within `flash_attention.tolerance`; `condmask`
    equal to its unmasked twin bit for bit; each other flag's branch at the
    full step from its twin (`flag_step` near 1). Per shape: the plain
    version's ms (base, block_k 64), SDPA's ms on the same q, k, v and the
    bound. First, ptxas' lines of every instance (no spill, no C7512)."""
    import torch
    import torch.nn.functional as F

    from f_lite_tpu_torch.ops.cuda import flash_attention as fa
    from f_lite_tpu_torch.ops.cuda import flash_variants as fv

    variants_ptxas()
    rows = []
    gen = torch.Generator("cuda").manual_seed(2)
    for label, b, h, l, d in VARIANT_SHAPES:
        q, k, v = (torch.randn((b, h, l, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        errs, ratios, steps = [], [], []
        for bq, bk in fv.blocks(d):
            outs, wants = {}, {}
            for name, kw in fv.VARIANTS.items():
                got = fv.flash_fwd(q, k, v, block_q=bq, block_k=bk, **kw)
                torch.cuda.synchronize()
                want = fv.flash_fwd_plain(q, k, v, block_k=bk,
                                          out_dtype=torch.float32, **kw)
                err = float((got.float() - want).abs().max())
                tol = fa.tolerance(want, torch.bfloat16)
                if not math.isfinite(err) or err > tol:
                    raise AssertionError(f"variant {name} {label} ({bq}, {bk}): "
                                         f"max abs err {err} > {tol}")
                errs.append(err)
                ratios.append(err / tol)
                outs[name], wants[name] = got, want
            for twin, masked in (("base", "condmask-e"), ("exp2", "condmask")):
                if not torch.equal(outs[twin], outs[masked]):
                    raise AssertionError(f"variant {masked} {label} ({bq}, {bk}) "
                                         f"differs from {twin}")
            # the twins differ by less than the tolerance: each flag branch
            # must also move the output from its twin's plain result to its own
            for own, twin in fv.FLAG_TWINS:
                c = fv.flag_step(outs[own], wants[own], wants[twin])
                if not abs(c - 1) < fv.FLAG_STEP_TOLERANCE:
                    raise AssertionError(f"variant {own} {label} ({bq}, {bk}): "
                                         f"flag step {c} from {twin}, expected 1")
                steps.append(c)
            del outs, wants
        bound, bound_by = attention_bound_ms(b, h, l, l, d, None, "bfloat16")
        row = dict(shape=label, q=[b, h, l, d], blocks=fv.blocks(d),
                   max_abs_err=max(errs), max_err_over_tolerance=max(ratios),
                   flag_step=[min(steps), max(steps)],
                   plain_ms=time_ms(lambda: fv.flash_fwd_plain(q, k, v, block_k=64)),
                   library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                   bound_ms=bound, bound_by=bound_by)
        log("variants", json.dumps(row))
        rows.append(row)
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return rows


def run_lab() -> dict:
    """The lab's entry point as a user runs it (`python -m
    f_lite_tpu_torch.tools.flash_variants`: every variant at every pair of
    `blocks(d)` at 2x10x4112x256 bf16, 20 timed launches each), its launch
    counts, and its sweep at the other shapes of VARIANT_SHAPES."""
    from f_lite_tpu_torch.ops.cuda import flash_variants as fv
    from f_lite_tpu_torch.tools import flash_variants as lab

    reset_counts()
    rows = lab.main([])
    counts = read_counts()
    per_row = 1 + 1 + lab.REPS  # checked call, warm-up, timed launches
    n_rows = len(fv.blocks(lab.lab_shape()[3])) * len(fv.VARIANTS)
    expected = launches(variants=n_rows * per_row)
    if counts != expected or len(rows) != n_rows:
        raise AssertionError(f"lab: launches {counts} and {len(rows)} rows, "
                             f"expected {expected} and {n_rows}")
    ragged = {label: lab.sweep((b, h, l, d))
              for label, b, h, l, d in VARIANT_SHAPES[1:]}
    for label, rs in ragged.items():
        for r in rs:
            log("lab", label, lab.format_row(r))
    res = dict(launches=counts, rows=rows, ragged=ragged)
    log("lab_sweep", json.dumps(dict(launches=counts, rows=rows)))
    return res


# ---------------------------------------------------------------------------
# phase 6: one 7B-width block's gradients, kernels against plain attention
# ---------------------------------------------------------------------------

def check_block_grads(batch=4, size=512, text_len=128) -> dict:
    """Block 1 of f_lite_7b (self-attention mixing block 0's V through
    lambda_v, cross-attention), fp32 weights computing in bf16 at 512 px
    (64x64 latents, 1040 tokens): every parameter and input gradient through
    the kernels within 2e-2 (relative norm) of the plain attention's.

    The loss is sum(w * out), w a random tensor plus, at the same norm, the
    output's response to lambda_v (out at lambda_v + 0.1 minus out at
    lambda_v - 0.1). lambda_v's gradient is one number summing 10.6M
    products; with a random w alone it sums to near zero and its relative
    error is a ratio of two near-zero sums."""
    import numpy as np
    import torch

    import f_lite_tpu_torch.ops.attention as attn_mod
    from f_lite_tpu_torch.models.dit import DiTBlock, DiTConfig
    from f_lite_tpu_torch.ops.cuda import flash_attention as fa
    from f_lite_tpu_torch.ops.rope import rope_2d_freqs
    from f_lite_tpu_torch.utils.random_weights import randomize_

    cfg = DiTConfig.f_lite_7b(dtype=torch.bfloat16)
    with torch.device("cuda"):
        block = randomize_(DiTBlock(cfg, 1), seed=5)
    assert block.do_cross_attn and hasattr(block.self_attn, "lambda_v")
    g = torch.Generator("cuda").manual_seed(6)
    tokens = cfg.n_register_tokens + (size // 8 // cfg.patch_size) ** 2
    d, h, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    inputs = dict(x=rand(batch, tokens, d), context=rand(batch, text_len, d),
                  modulation=rand(batch, 9, d, scale=0.1),
                  v_first=rand(batch, h, tokens, hd))
    mask = torch.from_numpy(
        np.arange(text_len)[None, :] < np.asarray([77, 128, 77, 128])[:batch, None]
    ).cuda()
    rope = rope_2d_freqs(hd, size // 16, size // 16, base=cfg.rope_base,
                         n_register_tokens=cfg.n_register_tokens, device="cuda")
    weight = torch.randn((batch, tokens, d), generator=g, device="cuda")
    with torch.no_grad():
        lam = block.self_attn.lambda_v
        saved = lam.clone()
        outs = []
        for shift in (0.1, -0.1):
            lam.copy_(saved + shift)
            outs.append(block(inputs["x"], inputs["context"], mask,
                              inputs["modulation"], rope, inputs["v_first"])[0].float())
        lam.copy_(saved)
        response = outs[0] - outs[1]
        weight += response * (weight.norm() / response.norm())

    def grads(attention_fn):
        attn_mod.flash_attention = attention_fn
        try:
            block.zero_grad(set_to_none=True)
            leaves = {n: t.detach().clone().requires_grad_() for n, t in inputs.items()}
            out, _ = block(leaves["x"], leaves["context"], mask,
                           leaves["modulation"], rope, leaves["v_first"])
            (out.float() * weight).sum().backward()
            res = {f"param:{n}": p.grad.float().clone() for n, p in block.named_parameters()}
            res.update({f"input:{n}": t.grad.float() for n, t in leaves.items()})
            return res
        finally:
            attn_mod.flash_attention = fa.flash_attention

    reset_counts()
    kernel = grads(fa.flash_attention)
    counts = read_counts()
    plain = grads(fa.flash_attention_plain)
    if counts != launches(fwd=2, dq=2, dkv=2):
        raise AssertionError(f"block gradients: launches {counts}, expected 2 of each")
    rel = {n: float((kernel[n] - plain[n]).norm() / plain[n].norm()) for n in plain}
    res = dict(config="f_lite_7b block 1", batch=batch, tokens=tokens,
               text_len=text_len, launches=counts, max_rel=max(rel.values()),
               rel=rel)
    log("block_grads", json.dumps(res))
    bad = {n: r for n, r in rel.items() if not r <= 2e-2}
    if bad:
        raise AssertionError(f"block gradients off by more than 2e-2: {bad}")
    del block, kernel, plain
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 6a: the int8 kernels against their plain versions
# ---------------------------------------------------------------------------

# (label, M, N, K): every projection of the int8 serving paths. 7B at 1024
# px: M = 2 x 4112 tokens (CFG batch), context_kv over 2 x 128 text rows;
# the fixture: M = 48 x 1040, context_kv over 48 x 32 rows.
INT8_SHAPES = [
    ("7b_qkv", 8224, 7680, 2560),
    ("7b_proj_q", 8224, 2560, 2560),
    ("7b_gate_up", 8224, 10240, 2560),
    ("7b_down", 8224, 2560, 10240),
    ("7b_context_kv", 256, 5120, 2560),
    ("fixture_qkv", 49920, 768, 256),
    ("fixture_proj_q", 49920, 256, 256),
    ("fixture_gate_up", 49920, 1024, 256),
    ("fixture_down", 49920, 256, 1024),
    ("fixture_context_kv", 1536, 512, 256),
]


def int8_bounds_ms(m, n, k, item) -> dict:
    """The least times on an H100 SXM: the quantize pass by bytes (x read
    once in `item` bytes a value, x8 and sx written once), the product by
    the larger of its int8 operations and its bytes (x8, w8, sx, scale read
    once, the output written once in `item` bytes)."""
    q_bytes = m * k * item + m * k + 4 * m
    g_ops = 2.0 * m * n * k
    g_bytes = m * k + n * k + 4 * (m + n) + m * n * item
    t_ops = g_ops / PEAK_FLOPS["int8"] * 1e3
    t_bytes = g_bytes / PEAK_BYTES * 1e3
    return dict(quantize=(q_bytes / PEAK_BYTES * 1e3, "bytes"),
                gemm=(max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"))


def library_int8_ms(x8, sx, w8, scale, out_dtype):
    """`torch._int_mm` (int32 out) plus the dequant as separate passes, a
    yardstick the port never calls; (that, _int_mm alone), or Nones where
    _int_mm refuses the shape."""
    import torch

    def lib():
        acc = torch._int_mm(x8, w8.T)
        return ((acc.float() * sx[:, None]) * scale).to(out_dtype)

    try:
        return time_ms(lib), time_ms(lambda: torch._int_mm(x8, w8.T))
    except RuntimeError as err:
        log(f"  _int_mm: none ({str(err).splitlines()[0][:120]})")
        return None, None


# K of the in-script fit of each of the product's designs: three at which
# the wrapper picks it (`int8_gemm.gemm_design`)
INT8_FIT_K = {"pingpong": (1024, 2048, 3072), "cooperative": (4096, 6144, 10240)}


def int8_k_fit(m=8224, n=7680) -> dict:
    """{design: fit}: each design's fixed cost a tile and cost a k-tile in
    its own tiles, with the fit's residual (`int8_tiles.fit_k_sweep`),
    fitted to its times through the wrapper at (m, n) and each K of
    INT8_FIT_K (where the tiles, not the output's bytes, set the time),
    random int8 operands."""
    import torch

    from f_lite_tpu_torch.ops.cuda import int8_gemm as ig
    from f_lite_tpu_torch.tools.int8_tiles import DESIGNS, fit_k_sweep

    gen = torch.Generator("cuda").manual_seed(16)
    fits = {}
    for design, ks in INT8_FIT_K.items():
        points = []
        for k in ks:
            if ig.gemm_design(k) != DESIGNS[design]:
                raise AssertionError(f"int8 fit: the wrapper does not pick {design} at K {k}")
            x8, w8 = (torch.randint(-127, 128, (rows, k), generator=gen, device="cuda",
                                    dtype=torch.int8) for rows in (m, n))
            sx = torch.rand((m,), generator=gen, device="cuda") + 0.5
            scale = torch.rand((n,), generator=gen, device="cuda") * 1e-3
            points.append((k, time_ms(lambda: ig.int8_gemm_dequant(x8, sx, w8, scale))))
            del x8, w8
        fits[design] = dict(fit_k_sweep(points, m, n, ig.num_sms(0),
                                        ig.BLOCK_N[DESIGNS[design]]),
                            m=m, n=n, ms_by_k={k: ms for k, ms in points})
        log("int8_k_fit", json.dumps(dict(design=design, **fits[design])))
    return fits


def check_int8() -> tuple[list[dict], list[dict], dict]:
    """Both int8 kernels against their plain versions, bit for bit, at
    every shape of INT8_SHAPES and of the product's grid edges
    (`int8_tiles.edge_shapes`): bf16 input (the serving path's) with and
    without bias, fp32 input, the int32 accumulators; a zero activation row
    and two zero weight rows in each. The INT8_SHAPES timed in bf16 beside
    the plain versions, `_int_mm` + dequant, bf16 F.linear and the bounds;
    then `int8_k_fit`. First, ptxas' lines (no spill, no C7512). Returns
    (timed rows, edge rows, fit)."""
    import torch
    import torch.nn.functional as F

    from f_lite_tpu_torch.ops.cuda import int8_gemm as ig
    from f_lite_tpu_torch.quant import quantize_weight
    from f_lite_tpu_torch.tools.int8_tiles import DESIGNS, edge_shapes

    ptxas_check(("int8_gemm",), ("int8_gemm_kernel", "quantize_rows_kernel"), "int8")
    rows, edge_rows = [], []
    edges = edge_shapes(ig.num_sms(0))
    gen = torch.Generator("cuda").manual_seed(15)
    for label, m, n, k in INT8_SHAPES + edges:
        w = torch.randn((n, k), generator=gen, device="cuda") * k**-0.5
        w[3] = 0.0
        w[-1] = 0.0
        w8, scale = quantize_weight(w.to(torch.bfloat16))
        bias = torch.randn((n,), generator=gen, device="cuda") * 0.1
        x32 = torch.randn((m, k), generator=gen, device="cuda") * 3
        x32[m // 2] = 0.0
        mismatches, max_err = [], 0.0
        for dtype in (torch.bfloat16, torch.float32):
            x = x32.to(dtype)
            x8, sx = ig.quantize_rows(x)
            acc = ig.int8_gemm_int32(x8, w8)
            ys = {b: ig.int8_gemm_dequant(x8, sx, w8, scale, bias if b else None, dtype)
                  for b in (False, True)}
            torch.cuda.synchronize()
            x8_want, sx_want = ig.quantize_rows_plain(x)
            checks = {"x8": (x8, x8_want), "sx": (sx, sx_want),
                      "acc": (acc, ig.int8_matmul_plain(x8, w8))}
            for b, y in ys.items():
                checks[f"y{'+bias' if b else ''}"] = (
                    y, ig.int8_linear_plain(x8, sx, w8, scale, bias if b else None, dtype))
            for what, (got, want) in checks.items():
                err = float((got.double() - want.double()).abs().max())
                max_err = max(max_err, err)
                if not torch.equal(got, want):
                    mismatches.append(f"{what} {dtype}: max abs diff {err}")
            del acc, ys, checks
        if mismatches:
            raise AssertionError(f"int8 {label}: kernels differ from plain: {mismatches}")
        if (label, m, n, k) in edges:  # checked, not timed
            edge_rows.append(dict(shape=label, m=m, n=n, k=k, max_abs_err=max_err))
            log("int8_edge", json.dumps(edge_rows[-1]))
            del w, w8, scale, bias, x32
            continue
        x = x32.to(torch.bfloat16)
        del x32
        x8, sx = ig.quantize_rows(x)
        w_bf16 = w.to(torch.bfloat16)
        lib_ms, int_mm_ms = library_int8_ms(x8, sx, w8, scale, torch.bfloat16)
        bounds = int8_bounds_ms(m, n, k, 2)
        row = dict(
            shape=label, m=m, n=n, k=k, max_abs_err=max_err,
            quantize_ms=time_ms(lambda: ig.quantize_rows(x)),
            quantize_plain_ms=time_ms(lambda: ig.quantize_rows_plain(x)),
            gemm_design=next(d for d, code in DESIGNS.items() if code == ig.gemm_design(k)),
            gemm_ms=time_ms(lambda: ig.int8_gemm_dequant(x8, sx, w8, scale)),
            gemm_plain_ms=time_ms(lambda: ig.int8_linear_plain(x8, sx, w8, scale)),
            library_ms=lib_ms, int_mm_ms=int_mm_ms,
            bf16_linear_ms=time_ms(lambda: F.linear(x, w_bf16)),
            quantize_bound_ms=bounds["quantize"][0], quantize_bound_by=bounds["quantize"][1],
            gemm_bound_ms=bounds["gemm"][0], gemm_bound_by=bounds["gemm"][1])
        log("int8", json.dumps(row))
        rows.append(row)
        del w, w8, scale, bias, x, x8, sx, w_bf16
    torch.cuda.empty_cache()
    fit = int8_k_fit()
    torch.cuda.empty_cache()
    return rows, edge_rows, fit


# ---------------------------------------------------------------------------
# phase 12: the fixture's training recipe through the port's trainer
# ---------------------------------------------------------------------------

def draw_shape(size, rgb, shape, rng):
    """(size, size, 3) uint8: one shape on the gray background, drawn like
    tools/make_shapes_dataset.py (radius 30-45% of the image, jittered
    centre) with a pixel-centre rasteriser of its own."""
    import numpy as np

    r = size * rng.uniform(0.30, 0.45)
    margin = r + 1
    cx = rng.uniform(margin, size - margin)
    cy = rng.uniform(margin, size - margin)
    y, x = np.mgrid[0:size, 0:size] + 0.5
    if shape == "circle":
        inside = (x - cx) ** 2 + (y - cy) ** 2 <= r * r
    elif shape == "square":
        inside = (np.abs(x - cx) <= r) & (np.abs(y - cy) <= r)
    else:  # triangle, apex up
        inside = (y >= cy - r) & (y <= cy + r) & (np.abs(x - cx) <= (y - (cy - r)) / 2)
    img = np.empty((size, size, 3), np.uint8)
    img[:] = BACKGROUND
    img[inside] = rgb
    return img


def write_shapes_cache(root: Path, per_class=128, size=64, seed=0) -> int:
    """The shapes dataset as a precomputed cache: pixels in [-1, 1] NHWC as
    the latents, and each caption's ZeroTextEncoder(64, seq_len=32)
    embedding (all 32 rows real, as on the online path)."""
    import numpy as np

    from f_lite_tpu_torch.data.precomputed import PrecomputedCacheWriter
    from f_lite_tpu_torch.text.encoder import ZeroTextEncoder

    enc = ZeroTextEncoder(64, seq_len=32)
    writer = PrecomputedCacheWriter(root)
    rng = np.random.RandomState(seed)
    for color, rgb in COLORS.items():
        for shape in SHAPES:
            caption = f"a {color} {shape}"
            emb, mask = enc.encode([caption])
            emb = emb[0][mask[0]]
            for i in range(per_class):
                img = draw_shape(size, rgb, shape, rng)
                writer.add(f"{color}/{shape}/{i}", caption,
                           img.astype(np.float32) / 127.5 - 1.0, emb)
    writer.finalize()
    return len(writer.entries)


class StepLog(logging.Handler):
    """Prints the trainer's log lines and keeps the `step N loss X` ones."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.losses = {}

    def emit(self, record):
        msg = record.getMessage()
        log(f"  train: {msg}")
        parts = msg.split()
        if parts[:1] == ["step"] and parts[2:3] == ["loss"]:
            self.losses[int(parts[1])] = float(parts[3])


def run_training(argv, on_step) -> tuple:
    """`f_lite_tpu_torch.train` with `argv`, its log lines printed: (result
    dict, {step: logged loss})."""
    from f_lite_tpu_torch.train.trainer import parse_args, train

    handler = StepLog()
    train_log = logging.getLogger("f_lite_tpu_torch.train")
    train_log.setLevel(logging.INFO)
    train_log.addHandler(handler)
    try:
        result = train(parse_args(argv), on_step=on_step)
    finally:
        train_log.removeHandler(handler)
    return result, handler.losses


class StepWatch:
    """An `on_step` callback: per-step host time after a synchronise, the
    launch counts of each step, and a torch.profiler window over steps
    (start, stop]."""

    def __init__(self, profile_window=None, check=None):
        self.times, self.per_step = [], []
        self.window = profile_window
        self.check = check
        self.prof = None
        self.profile = None
        self.state = None
        self._last = None
        self._t = None

    def begin(self):
        """Call just before the run: the counts and the clock start here."""
        import torch

        torch.cuda.synchronize()
        self._last = read_counts()
        self._t = time.perf_counter()

    def __call__(self, state, metrics):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        now = time.perf_counter()
        self.times.append(now - self._t)
        self._t = now
        counts = read_counts()
        self.per_step.append({k: counts[k] - self._last[k] for k in counts})
        self._last = counts
        self.state = state
        if self.check is not None:
            self.check(state.step, metrics)
        if self.window and state.step == self.window[0]:
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            self._t_prof = time.perf_counter()
        elif self.window and state.step == self.window[1]:
            self.prof.__exit__(None, None, None)
            self.profile = profile_summary(
                self.prof, (now - self._t_prof) * 1e3,
                label=f"step_profile (steps {self.window[0] + 1}-{self.window[1]})")
            self.prof = None
            self._t = time.perf_counter()  # the profiler's own teardown


def run_fixture_training(tmp: Path, steps=300) -> dict:
    """The fixture recipe of artifacts/fixture_run/train.log from scratch."""
    import torch

    from f_lite_tpu_torch.models.dit import DiT, DiTConfig
    from f_lite_tpu_torch.pipeline import FLitePipeline

    cfg = json.loads((FIXTURE / "dit" / "config.json").read_text())
    cache = tmp / "shapes_cache"
    t0 = time.perf_counter()
    n_items = write_shapes_cache(cache)
    cache_s = time.perf_counter() - t0
    out = tmp / "fixture_train"
    argv = ["--device", "cuda", "--use_precomputed_data",
            "--precomputed_data_dir", str(cache), "--pixel_space",
            "--model_width", str(cfg["hidden_size"]),
            "--model_depth", str(cfg["depth"]),
            "--model_head_dim", str(cfg["hidden_size"] // cfg["num_heads"]),
            "--cross_attn_input_size", str(cfg["cross_attn_input_size"]),
            "--residual_v", "--train_batch_size", "32",
            "--learning_rate", "8e-4", "--num_warmup_steps", "200",
            "--lr_scheduler", "constant", "--max_steps", str(steps),
            "--num_epochs", "100", "--mixed_precision", "bf16",
            "--log_every", "10", "--seed", "0", "--output_dir", str(out),
            "--export_pipeline"]
    n_attn = cfg["depth"] + sum(
        DiTConfig.from_json_dict(cfg).block_has_cross_attn(i) for i in range(cfg["depth"]))
    watch = StepWatch(profile_window=(100, 103))
    reset_counts()
    watch.begin()
    result, losses = run_training(argv, watch)
    counts = read_counts()
    late = [losses[s] for s in range(260, steps + 1, 10)]
    step_s = statistics.median(watch.times[2:])
    res = dict(items=n_items, cache_write_s=cache_s, steps=result["global_step"],
               logged_losses=losses, mean_loss_260_300=statistics.mean(late),
               jax_mean_loss_260_300=0.073, s_per_step=step_s,
               wall_s=result["wall_s"], launches=counts,
               per_step_expected=launches(fwd=n_attn, dq=n_attn, dkv=n_attn),
               idle_share=watch.profile["idle_share"])
    log("fixture_train", json.dumps(res))
    if result["global_step"] != steps:
        raise AssertionError(f"fixture training ran {result['global_step']} steps")
    bad = [i + 1 for i, c in enumerate(watch.per_step)
           if c != launches(fwd=n_attn, dq=n_attn, dkv=n_attn)]
    if bad:
        raise AssertionError(f"fixture training: launch counts off at steps {bad[:5]}")
    if not res["mean_loss_260_300"] <= 0.15:
        raise AssertionError(f"fixture training: mean loss {res['mean_loss_260_300']} > 0.15")

    # the export reloads with the same DiT (both in fp32 on one batch)
    trained = watch.state.model
    trained.config = dataclasses.replace(trained.config, dtype=None)
    trained.eval()
    pipe = FLitePipeline.from_pretrained(out / "pipeline", dtype=torch.float32)
    g = torch.Generator("cuda").manual_seed(9)
    x = torch.randn((4, 64, 64, 3), generator=g, device="cuda")
    ctx = torch.randn((4, 32, cfg["cross_attn_input_size"]), generator=g, device="cuda") * 0.02
    t = torch.rand(4, generator=g, device="cuda")
    with torch.no_grad():
        want = trained(x, ctx, None, t)
        got = pipe.dit(x, ctx, None, t)
    diff = float((got - want).abs().max())
    res["export_max_abs_diff"] = diff
    log("fixture_export", json.dumps(dict(max_abs_diff=diff,
                                          out_abs_max=float(want.abs().max()))))
    if not isinstance(pipe.dit, DiT) or diff > 1e-5:
        raise AssertionError(f"exported DiT differs from the trained one by {diff}")
    del pipe, trained, watch
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 13: f_lite_7b_width_d20_train512
# ---------------------------------------------------------------------------

def run_7b_training(tmp: Path, steps=10, batch=4, depth=20) -> dict:
    """The 7B's widths at depth 20, 512 px (64x64x16 latents), batch 4, text
    embeddings of 77 and 128 real rows (padded to 128), bf16 compute over
    fp32 master weights, checkpointing from block 8, AdamW, 10 steps."""
    import numpy as np
    import torch

    from f_lite_tpu_torch.data.precomputed import PrecomputedCacheWriter
    from f_lite_tpu_torch.models.dit import DiTConfig

    cfg = DiTConfig.f_lite_7b(depth=depth)
    cache = tmp / "7b_cache"
    writer = PrecomputedCacheWriter(cache)
    rs = np.random.RandomState(10)
    for i, n_text in enumerate((77, 128, 77, 128)[:batch]):
        writer.add(f"item{i}", f"prompt {i}",
                   rs.randn(64, 64, cfg.in_channels).astype(np.float32),
                   (rs.randn(n_text, cfg.cross_attn_input_size) * 0.02).astype(np.float32))
    writer.finalize()
    argv = ["--device", "cuda", "--use_precomputed_data",
            "--precomputed_data_dir", str(cache),
            "--model_width", str(cfg.hidden_size), "--model_depth", str(depth),
            "--model_head_dim", str(cfg.head_dim),
            "--in_channels", str(cfg.in_channels),
            "--cross_attn_input_size", str(cfg.cross_attn_input_size),
            "--residual_v", "--train_batch_size", str(batch),
            "--num_epochs", str(steps), "--max_steps", str(steps),
            "--learning_rate", "1e-4", "--lr_scheduler", "constant",
            "--num_warmup_steps", "2", "--max_grad_norm", "1.0",
            "--mixed_precision", "bf16", "--gradient_checkpointing",
            "--log_every", "1", "--seed", "0", "--output_dir", str(tmp / "7b_out")]
    n_self = depth
    n_cross = sum(cfg.block_has_cross_attn(i) for i in range(depth))
    n_remat = sum(1 + cfg.block_has_cross_attn(i) for i in range(8, depth))
    expected = launches(fwd=n_self + n_cross + n_remat, dq=n_self + n_cross,
                        dkv=n_self + n_cross)
    finite = []

    def check(step, metrics):
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        finite.append(math.isfinite(loss) and math.isfinite(gnorm))
        log(f"  7b step {step}: loss {loss} grad_norm {gnorm}")

    watch = StepWatch(profile_window=(steps - 2, steps - 1), check=check)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    watch.begin()
    result, _ = run_training(argv, watch)
    counts = read_counts()
    n_params = sum(p.numel() for p in watch.state.model.parameters())
    res = dict(config="f_lite_7b_width_d20_train512", params=n_params,
               batch=batch, tokens=1040, steps=result["global_step"],
               s_per_step=statistics.median(watch.times[2:]),
               s_per_step_pr5=0.409, step_s=watch.times,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=counts, per_step=watch.per_step[0],
               per_step_expected=expected, all_finite=all(finite),
               step_profile=watch.profile)
    log("7b_train", json.dumps(res))
    if result["global_step"] != steps or not all(finite) or len(finite) != steps:
        raise AssertionError(f"7B training: {result['global_step']} steps, finite {finite}")
    bad = [i + 1 for i, c in enumerate(watch.per_step) if c != expected]
    if bad:
        raise AssertionError(
            f"7B training: launch counts {watch.per_step[bad[0] - 1]} at step "
            f"{bad[0]}, expected {expected}")
    if not res["max_memory_allocated_gb"] < 80:
        raise AssertionError(f"7B training peak {res['max_memory_allocated_gb']} GB")
    del watch
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 7-8: serving, the trained fixture
# ---------------------------------------------------------------------------

def fixture_requests(pipe, embeds, mask, n_requests, **kw):
    """The fixture's requests (one per seed, 24 captions each, numpy
    latents of that seed): (images (n*24, 64, 64, 3), host s per request)."""
    import numpy as np
    import torch

    images, seconds = [], []
    for seed in range(n_requests):
        latents = np.random.RandomState(seed).randn(
            embeds.shape[0], 64, 64, pipe.dit.config.in_channels).astype(np.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe(prompt_embeds=embeds, context_mask=mask, latents=latents,
                   output_type="np", **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        imgs = out.images
        if imgs.shape != (embeds.shape[0], 64, 64, 3) or not np.isfinite(imgs).all():
            raise AssertionError(f"fixture images: shape {imgs.shape} or non-finite")
        images.append(imgs)
    return np.concatenate(images), seconds


def both_acc(images, classes) -> float:
    hits = sum(classify(img) == cls
               for img, cls in zip(images, classes * (len(images) // len(classes))))
    return hits / len(images)


def load_fixture(quantize=False):
    """(pipeline in bf16, its 24 captions' embeddings and mask, the
    classes, forward launches per step)."""
    import torch

    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.text.encoder import ZeroTextEncoder

    pipe = FLitePipeline.from_pretrained(FIXTURE, dtype=torch.bfloat16,
                                         quantize=quantize)
    cfg = pipe.dit.config
    classes = [(c, s) for c in COLORS for s in SHAPES]
    embeds, mask = ZeroTextEncoder(cfg.cross_attn_input_size, seq_len=32).encode(
        [f"a {c} {s}" for c, s in classes]
    )
    n_blocks = cfg.depth + sum(cfg.block_has_cross_attn(i) for i in range(cfg.depth))
    return pipe, embeds, mask, classes, n_blocks


def run_fixture(n_requests=4, steps=30, guidance=6.0) -> tuple:
    """Phase 7: full CFG Euler@30 (res, images)."""
    import torch

    pipe, embeds, mask, classes, n_blocks = load_fixture()
    expected = n_requests * steps * n_blocks
    reset_counts()
    images, seconds = fixture_requests(pipe, embeds, mask, n_requests,
                                       num_inference_steps=steps,
                                       guidance_scale=guidance)
    counts = read_counts()
    acc = both_acc(images, classes)
    res = dict(requests=n_requests, images=len(images), both_acc=acc,
               s_per_request=seconds, launches=counts["fwd"],
               expected_launches=expected, counts=counts)
    log("fixture", json.dumps(res))
    if counts != launches(fwd=expected):
        raise AssertionError(f"fixture: launches {counts}, expected {expected} forward only")
    if acc < 0.95:
        raise AssertionError(f"fixture: both_acc {acc} < 0.95")
    del pipe
    torch.cuda.empty_cache()
    return res, images


def run_fixture_extras(full_images, n_requests=4, guidance=6.0) -> dict:
    """Phase 8: limited-interval guidance (0.1, 0.9) at 30 steps, both_acc
    >= 0.95 (JAX 0.990, QUALITY_FIXTURE.json); ab2 and Euler at 15 steps,
    each one's image MSE to Euler@30 (JAX 0.0146 and 0.0129)."""
    import numpy as np
    import torch

    pipe, embeds, mask, classes, n_blocks = load_fixture()
    runs = {"gi0.1-0.9@30": dict(num_inference_steps=30, guidance_interval=(0.1, 0.9)),
            "euler@15": dict(num_inference_steps=15),
            "ab2@15": dict(num_inference_steps=15, sampler="ab2")}
    expected = n_requests * n_blocks * sum(kw["num_inference_steps"] for kw in runs.values())
    res = {}
    reset_counts()
    for name, kw in runs.items():
        images, seconds = fixture_requests(pipe, embeds, mask, n_requests,
                                           guidance_scale=guidance, **kw)
        res[name] = dict(both_acc=both_acc(images, classes), s_per_request=seconds,
                         mse_vs_euler30=float(np.mean((images - full_images) ** 2)))
    counts = read_counts()
    res.update(launches=counts, expected_launches=expected,
               jax=dict(gi_both_acc=0.9896, ab2_15_mse=0.014558, euler_15_mse=0.012942))
    log("fixture_extras", json.dumps(res))
    if counts != launches(fwd=expected):
        raise AssertionError(f"fixture extras: launches {counts}, expected {expected}")
    if res["gi0.1-0.9@30"]["both_acc"] < 0.95:
        raise AssertionError(f"fixture gi: both_acc {res['gi0.1-0.9@30']['both_acc']} < 0.95")
    del pipe
    torch.cuda.empty_cache()
    return res


def run_fixture_int8(full_images, n_requests=4, steps=30, guidance=6.0) -> dict:
    """Phase 8a: the requests of phase 7 on the fixture loaded with
    quantize=True: both_acc >= 0.95 (JAX int8 1.000, QUALITY_FIXTURE.json)
    and PSNR >= 30 dB against phase 7's bf16 images (JAX 34.62 dB against
    its full CFG run); exact launch counts."""
    import numpy as np
    import torch

    pipe, embeds, mask, classes, n_blocks = load_fixture(quantize=True)
    per_forward = int8_layers(pipe.dit)
    expected = launches(fwd=n_requests * steps * n_blocks,
                        quantize=n_requests * steps * per_forward,
                        gemm=n_requests * steps * per_forward)
    reset_counts()
    images, seconds = fixture_requests(pipe, embeds, mask, n_requests,
                                       num_inference_steps=steps,
                                       guidance_scale=guidance)
    counts = read_counts()
    mse = float(np.mean((images - full_images) ** 2))
    psnr = 10 * math.log10(4.0 / mse) if mse > 0 else math.inf
    res = dict(requests=n_requests, images=len(images),
               both_acc=both_acc(images, classes), psnr_vs_bf16_db=psnr,
               mse_vs_bf16=mse, s_per_request=seconds, launches=counts,
               expected_launches=expected, int8_layers=per_forward,
               jax=dict(both_acc=1.0, psnr_db=34.62))
    log("fixture_int8", json.dumps(res))
    if counts != expected:
        raise AssertionError(f"fixture int8: launches {counts}, expected {expected}")
    if res["both_acc"] < 0.95:
        raise AssertionError(f"fixture int8: both_acc {res['both_acc']} < 0.95")
    if not psnr >= 30:
        raise AssertionError(f"fixture int8: PSNR {psnr} dB < 30 against bf16")
    del pipe
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 9-11: serving at 7B width (DiT f_lite_7b + the Flux VAE, seeded
# random weights)
# ---------------------------------------------------------------------------

def build_7b_pipe():
    import torch

    from f_lite_tpu_torch.models.dit import DiT, DiTConfig
    from f_lite_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.utils.random_weights import randomize_

    with torch.device("cuda"):
        prev = torch.get_default_dtype()
        torch.set_default_dtype(torch.bfloat16)
        try:
            dit = DiT(DiTConfig.f_lite_7b()).eval()
        finally:
            torch.set_default_dtype(prev)
        vae = AutoencoderKL(VAEConfig.flux()).eval()
    randomize_(dit, seed=1)
    randomize_(vae, seed=2)
    return FLitePipeline(dit, vae)


def text_7b(pipe, text_len=128, real_len=77):
    """128 text rows of which the first 77 are real, seeded."""
    import numpy as np

    rs = np.random.RandomState(3)
    embeds = (rs.randn(1, text_len, pipe.dit.config.cross_attn_input_size)
              * 0.02).astype(np.float32)
    return embeds, np.arange(text_len)[None, :] < real_len


def blocks_7b(pipe) -> int:
    cfg = pipe.dit.config
    return cfg.depth + sum(cfg.block_has_cross_attn(i) for i in range(cfg.depth))


def int8_layers(dit) -> int:
    """The DiT's QuantDense layers: launches of each int8 kernel a forward."""
    from f_lite_tpu_torch.models.dit import QuantDense

    return sum(isinstance(m, QuantDense) for m in dit.modules())


def run_7b(pipe, steps=30, guidance=6.0, size=1024, label="7b") -> dict:
    """Phase 9 (and 11a, on the quantized pipeline): text to image at 1024
    px, 30 steps, g=6."""
    import numpy as np
    import torch

    vae = pipe.vae
    embeds, mask = text_7b(pipe)
    expected = launches(fwd=steps * blocks_7b(pipe),
                        quantize=steps * int8_layers(pipe.dit),
                        gemm=steps * int8_layers(pipe.dit))

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
    reset_counts()
    t0 = time.perf_counter()
    out = pipe(prompt_embeds=embeds, context_mask=mask, height=size, width=size,
               num_inference_steps=steps, guidance_scale=guidance,
               generator=torch.Generator("cuda").manual_seed(4),
               output_type="uint8")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = read_counts()
    for hk in hooks:
        hk.remove()

    img = out.images
    denoise_s = marks["decode_start"] - t0
    # the int8 DiT holds its projections' weights as buffers (w8, scale)
    res = dict(params=sum(t.numel() for t in (*pipe.dit.parameters(),
                                               *pipe.dit.buffers())),
               image=list(img.shape), dtype=str(img.dtype),
               s_per_step=denoise_s / steps, decode_s=marks["decode_end"] - marks["decode_start"],
               s_per_image=total, max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=counts["fwd"], counts=counts, expected_launches=expected,
               decoded_finite=finite == [True])
    log(label, json.dumps(res))
    if img.shape != (1, size, size, 3) or img.dtype != np.uint8:
        raise AssertionError(f"{label} image {img.shape} {img.dtype}")
    if finite != [True]:
        raise AssertionError(f"{label} decoded image holds NaN or Inf")
    if counts != expected:
        raise AssertionError(f"{label}: launches {counts}, expected {expected}")
    res["step_profile"] = profile_step(
        lambda: pipe(prompt_embeds=embeds, context_mask=mask, height=size,
                     width=size, num_inference_steps=1,
                     guidance_scale=guidance, output_type="latent"),
        label=f"{label} step_profile")
    torch.cuda.empty_cache()
    return res


def run_img2img(pipe, steps=30, strength=0.5, guidance=6.0, size=1280) -> dict:
    """Phase 10: image to image with a mask at 1280 px (6416 tokens):
    strength 0.5 (15 of 30 steps), g=6, the left half repainted (mask at
    the latent grid); "auto" memory mode tiles the encode and the decode
    (3x3 tiles of 64 latents each). Finite output, exactly 15 * 56 forward
    launches and none of the others, and in the final latents the kept
    region equal to the encoded image's latents (the last step ends at
    t = 0)."""
    import numpy as np
    import torch

    from f_lite_tpu_torch.models.vae import normalize_latents

    embeds, mask = text_7b(pipe)
    lh = size // pipe.vae_scale_factor
    rs = np.random.RandomState(11)
    image = rs.randint(0, 256, (size, size, 3)).astype(np.uint8)
    repaint = np.zeros((lh, lh), np.uint8)
    repaint[:, : lh // 2] = 255
    n_run = max(1, min(steps, int(round(strength * steps))))  # rows run
    expected = n_run * blocks_7b(pipe)

    seen = {}
    tiles = {"encoder": 0, "decoder": 0}

    def timed(name, fn):
        def wrapper(x):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x)
            torch.cuda.synchronize()
            seen[name] = (x, out, time.perf_counter() - t0)
            return out
        return wrapper

    def count(name):
        def hook(_m, _inp, _out):
            tiles[name] += 1
        return hook

    pipe._encode_image_latents = timed("encode", pipe._encode_image_latents)
    pipe._decode = timed("decode", pipe._decode)
    hooks = [pipe.vae.encoder.register_forward_hook(count("encoder")),
             pipe.vae.decoder.register_forward_hook(count("decoder"))]
    try:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = pipe(prompt_embeds=embeds, context_mask=mask, height=size, width=size,
                   num_inference_steps=steps, guidance_scale=guidance,
                   image=image, strength=strength, mask_image=repaint,
                   generator=torch.Generator("cuda").manual_seed(12),
                   output_type="uint8")
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = read_counts()
    finally:
        for hk in hooks:
            hk.remove()
        del pipe._encode_image_latents, pipe._decode

    img = out.images
    encoded = normalize_latents(seen["encode"][1].float(), pipe.vae.config)
    final = seen["decode"][0]
    keep = slice(lh // 2, None)
    # the final latents are in the DiT's dtype, rounded from fp32 at the end
    kept_equal = bool(torch.equal(final[:, :, keep],
                                  encoded[:, :, keep].to(final.dtype)))
    repaint_moved = float((final[:, :, : lh // 2].float()
                           - encoded[:, :, : lh // 2]).abs().mean())
    res = dict(size=size, tokens=16 + (lh // 2) ** 2, strength=strength,
               steps_run=n_run, image=list(img.shape),
               s_per_image=total, encode_s=seen["encode"][2], decode_s=seen["decode"][2],
               s_per_step=(total - seen["encode"][2] - seen["decode"][2]) / n_run,
               tiles=tiles, max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=counts, expected_launches=expected,
               kept_region_equals_encoded=kept_equal,
               repainted_mean_abs_change=repaint_moved)
    log("7b_img2img", json.dumps(res))
    if img.shape != (1, size, size, 3) or not bool(torch.isfinite(final).all()):
        raise AssertionError(f"img2img: image {img.shape} or non-finite latents")
    if counts != launches(fwd=expected):
        raise AssertionError(f"img2img: launches {counts}, expected {expected} forward only")
    if tiles != {"encoder": 9, "decoder": 9}:
        raise AssertionError(f"img2img: tiles {tiles}, expected 9 encode and 9 decode")
    if not kept_equal or not repaint_moved > 0:
        raise AssertionError("img2img: the kept region is not the encoded image, "
                             f"or the repainted one did not move ({repaint_moved})")
    torch.cuda.empty_cache()
    return res


def run_strength_one(pipe, size=256, steps=3, guidance=6.0) -> dict:
    """Phase 11: image to image at strength 1.0 (no mask) is text to image
    bit for bit: the encode is skipped and the start noise is the same
    draw."""
    import numpy as np
    import torch

    embeds, mask = text_7b(pipe)
    image = np.random.RandomState(13).randint(0, 256, (size, size, 3)).astype(np.uint8)
    kw = dict(prompt_embeds=embeds, context_mask=mask, height=size, width=size,
              num_inference_steps=steps, guidance_scale=guidance, output_type="np")
    reset_counts()
    a = pipe(**kw, image=image, strength=1.0,
             generator=torch.Generator("cuda").manual_seed(14)).images
    b = pipe(**kw, generator=torch.Generator("cuda").manual_seed(14)).images
    counts = read_counts()
    expected = 2 * steps * blocks_7b(pipe)
    res = dict(size=size, steps=steps, bitwise_equal=bool(np.array_equal(a, b)),
               finite=bool(np.isfinite(a).all()), launches=counts,
               expected_launches=expected)
    log("7b_strength_one", json.dumps(res))
    if not res["bitwise_equal"] or not res["finite"]:
        raise AssertionError("strength 1.0 differs from text to image")
    if counts != launches(fwd=expected):
        raise AssertionError(f"strength 1.0: launches {counts}, expected {expected}")
    return res


def profile_step(run_one_step, label="step_profile") -> dict:
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
    return profile_summary(prof, wall_ms, label)


def profile_summary(prof, wall_ms, label="step_profile") -> dict:
    """Device ms by kernel class, busy ms and idle share of a window of
    `wall_ms` traced by `prof`."""
    import torch

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    def dev_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) / 1e3
    busy = sum(dev_ms(e) for e in kernels)
    classes = {"flash_attention_fwd": 0.0, "flash_attention_bwd_dq": 0.0,
               "flash_attention_bwd_dkv": 0.0, "int8_gemm": 0.0,
               "int8_quantize": 0.0, "matmul": 0.0, "other": 0.0}
    for e in kernels:
        n = e.key.lower()
        # the int8 kernels first: "gemm" would file them under matmul
        if "int8_gemm_kernel" in n:
            classes["int8_gemm"] += dev_ms(e)
        elif "quantize_rows_kernel" in n:
            classes["int8_quantize"] += dev_ms(e)
        elif "flash_fwd" in n:
            classes["flash_attention_fwd"] += dev_ms(e)
        elif "flash_bwd_dq" in n:
            classes["flash_attention_bwd_dq"] += dev_ms(e)
        elif "flash_bwd_dkv" in n:
            classes["flash_attention_bwd_dkv"] += dev_ms(e)
        elif any(w in n for w in ("gemm", "nvjet", "xmma", "cutlass", "sm90")):
            classes["matmul"] += dev_ms(e)
        else:
            classes["other"] += dev_ms(e)
    top = sorted(kernels, key=dev_ms, reverse=True)[:12]
    res = dict(wall_ms=wall_ms, device_busy_ms=busy,
               idle_share=(1.0 - busy / wall_ms) if busy else None,
               by_class_ms=classes,
               top=[dict(name=e.key[:90], ms=dev_ms(e), count=e.count) for e in top])
    log(label, json.dumps(res))
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from f_lite_tpu_torch.ops.cuda.build import SOURCES, build, library_path

    card = card_line()
    log("card:", card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    build()
    log(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(SOURCES)})")
    for name in SOURCES:
        for line in library_path(name).with_suffix(".log").read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry",
                                       "warning", "nvcc seconds")):
                log(f"  ptxas {name}: {line.strip()}")

    t_start = time.perf_counter()

    def phase(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log(f"phase {fn.__name__}: {time.perf_counter() - t:.1f} s "
            f"(script {time.perf_counter() - t_start:.1f} s)")
        return out

    rows = phase(check_attention)
    bwd_rows = phase(check_backward)
    variant_rows = phase(check_variants)
    lab = phase(run_lab)
    block = phase(check_block_grads)
    int8_rows, int8_edges, int8_fit = phase(check_int8)
    fixture, full_images = phase(run_fixture)
    fixture_extras = phase(run_fixture_extras, full_images)
    fixture_int8 = phase(run_fixture_int8, full_images)
    pipe = build_7b_pipe()
    big = phase(run_7b, pipe)
    img2img = phase(run_img2img, pipe)
    strength_one = phase(run_strength_one, pipe)
    from f_lite_tpu_torch.quant import quantize_dit

    quantize_dit(pipe.dit)
    big_int8 = phase(run_7b, pipe, 30, 6.0, 1024, "7b_int8")
    log("7b_int8_vs_bf16", json.dumps({
        **{key: dict(bf16=big[key], int8=big_int8[key])
           for key in ("s_per_step", "s_per_image", "decode_s", "max_memory_allocated_gb")},
        "step_by_class_ms": dict(bf16=big["step_profile"]["by_class_ms"],
                                 int8=big_int8["step_profile"]["by_class_ms"])}))
    del pipe
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        fixture_train = phase(run_fixture_training, Path(tmp))
        train_7b = phase(run_7b_training, Path(tmp))

    main_row = next(r for r in rows if r["shape"] == "7b_self" and r["dtype"] == "bfloat16")
    forward = dict(
        name="flash_attention_fwd",
        route="cuda",
        source="f_lite_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="f_lite_tpu/ops/pallas/flash_attention.py:92",
        replaces_function="_fa_fwd_kernel",
        launches=train_7b["launches"]["fwd"],
        launches_per_train_step=train_7b["per_step"]["fwd"],
        launches_serving_7b_image=big["launches"],
        launches_serving_7b_img2img_1280=img2img["launches"]["fwd"],
        launches_serving_fixture=fixture["launches"],
        launches_serving_fixture_extras=fixture_extras["launches"]["fwd"],
        launches_lab=lab["launches"]["fwd"],
        launches_fixture_train=fixture_train["launches"]["fwd"],
        max_abs_err=max(r["max_abs_err"] for r in rows),
        max_err_over_tolerance=max(r["max_abs_err"] / r["tolerance"] for r in rows),
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"],
        at="7b_self (serving, B=2 L=4112) bfloat16",
        shapes=rows,
    )
    bwd_main = next(r for r in bwd_rows if r["shape"] == "7b_self" and r["dtype"] == "bfloat16")
    backward = []
    for name, fn, ms_key, grads in (("flash_attention_bwd_dq", "_dq_kernel:269", "dq_ms", ("dq",)),
                                    ("flash_attention_bwd_dkv", "_dkv_kernel:316", "dkv_ms", ("dk", "dv"))):
        which = "dq" if name.endswith("dq") else "dkv"
        backward.append(dict(
            name=name,
            route="cuda",
            source="f_lite_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces=f"f_lite_tpu/ops/pallas/flash_attention.py:{fn.split(':')[1]}",
            replaces_function=fn.split(":")[0],
            launches=train_7b["launches"][which],
            launches_per_train_step=train_7b["per_step"][which],
            launches_fixture_train=fixture_train["launches"][which],
            max_abs_err=max(r["max_abs_err"][gname] for r in bwd_rows for gname in grads),
            max_err_over_tolerance=max(r["max_abs_err"][gname] / r["tolerance"][gname]
                                       for r in bwd_rows for gname in grads),
            ms=bwd_main[ms_key], plain_ms=bwd_main["plain_ms"],
            plain_covers="dq, dk and dv together",
            bound_ms=bwd_main["bound_ms"][which], bound_by=bwd_main["bound_by"][which],
            library_ms=bwd_main["library_ms"],
            library_covers="SDPA forward + backward minus forward (dq, dk, dv)",
            pair_ms=bwd_main["pair_ms"], fused_bound_ms=bwd_main["bound_ms"]["fused"],
            at="7b_self (training, B=4 L=1040) bfloat16",
            by_shape={r["shape"]: dict(ms=r[ms_key], pair_ms=r["pair_ms"],
                                       library_ms=r["library_ms"],
                                       bound_ms=r["bound_ms"][which])
                      for r in bwd_rows if r["dtype"] == "bfloat16"},
        ))
    from f_lite_tpu_torch.ops.cuda import flash_variants as fv

    lab_at = {(r["block_q"], r["block_k"], r["variant"]): r["ms"] for r in lab["rows"]}
    serving_pair = fv.SERVING_BLOCKS[256]
    lab_main = next(r for r in variant_rows if r["shape"] == "7b_serving")
    variants = dict(
        name="flash_attention_variants",
        route="cuda",
        source="f_lite_tpu_torch/csrc/flash_attention_variants.cu",
        replaces="tools/flash_variants.py:43",
        replaces_function="_kernel",
        launches=lab["launches"]["variants"],
        launches_serving=sum(c["variants"] for c in (
            fixture["counts"], fixture_extras["launches"], big["counts"],
            img2img["launches"], strength_one["launches"])),
        launches_training=(fixture_train["launches"]["variants"]
                           + train_7b["launches"]["variants"]),
        max_abs_err=max(r["max_abs_err"] for r in variant_rows),
        max_err_over_tolerance=max(r["max_err_over_tolerance"] for r in variant_rows),
        ms=lab_at[(*serving_pair, "base")],
        ms_block_k_64=lab_at[(128, 64, "base")],
        forward_ms=main_row["ms"],
        plain_ms=lab_main["plain_ms"],
        bound_ms=lab_main["bound_ms"], bound_by=lab_main["bound_by"],
        library_ms=lab_main["library_ms"],
        at=f"7b_serving 2x10x4112x256 bfloat16, base, blocks {serving_pair}; "
           "forward_ms: flash_attention_fwd at 7b_self (phase 3)",
        sweep=[[r["block_q"], r["block_k"], r["variant"], r["ms"]] for r in lab["rows"]],
        shapes=variant_rows,
    )
    int8_main = next(r for r in int8_rows if r["shape"] == "7b_qkv")
    int8_common = dict(
        route="cuda", source="f_lite_tpu_torch/csrc/int8_gemm.cu",
        replaces="f_lite_tpu/quant.py:52",
        replaces_function="quant_matmul",
        replaces_note="lowered and fused by XLA; no Pallas kernel",
        max_abs_err=max(r["max_abs_err"] for r in int8_rows + int8_edges),
        at="7b_qkv (M 8224, N 7680, K 2560) bfloat16")
    int8_kernels = []
    for name, key, counter in (("int8_quantize_rows", "quantize", "quantize"),
                               ("int8_gemm_dequant", "gemm", "gemm")):
        int8_kernels.append(dict(
            name=name, **int8_common,
            launches=big_int8["counts"][counter],
            launches_serving_fixture_int8=fixture_int8["launches"][counter],
            ms=int8_main[f"{key}_ms"], plain_ms=int8_main[f"{key}_plain_ms"],
            bound_ms=int8_main[f"{key}_bound_ms"],
            bound_by=int8_main[f"{key}_bound_by"],
            library_ms=int8_main["library_ms"] if key == "gemm" else None,
            **(dict(library_covers="torch._int_mm + the dequant as separate passes",
                    int_mm_ms=int8_main["int_mm_ms"],
                    bf16_linear_ms=int8_main["bf16_linear_ms"],
                    # the fit of the design at 7b_qkv, in its own tiles
                    fixed_us_per_tile=int8_fit["pingpong"]["fixed_us_per_tile"],
                    fixed_us_residual=int8_fit["pingpong"]["max_abs_residual_us"],
                    us_per_k_tile=int8_fit["pingpong"]["us_per_k_tile"],
                    fit_tile=int8_fit["pingpong"]["tile"],
                    k_fit=int8_fit,
                    edge_shapes_checked=[r["shape"] for r in int8_edges])
               if key == "gemm" else {}),
            by_shape={r["shape"]: {f: r[f] for f in r if f.startswith(key) or (
                key == "gemm" and f in ("library_ms", "int_mm_ms", "bf16_linear_ms"))}
                for r in int8_rows},
        ))
    kernels = [forward, *backward, variants, *int8_kernels]
    for k in kernels:
        missing = [key for key in KERNEL_KEYS if key not in k]
        if missing:
            raise AssertionError(f"kernels line: {k['name']} lacks {missing}")
    log(json.dumps({"kernels": kernels,
                    "block_grads_max_rel": block["max_rel"],
                    "backward_shapes": bwd_rows,
                    "fixture_int8": dict(both_acc=fixture_int8["both_acc"],
                                         psnr_vs_bf16_db=fixture_int8["psnr_vs_bf16_db"])}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
