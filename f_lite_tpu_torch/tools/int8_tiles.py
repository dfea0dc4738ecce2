"""The int8 product kernel's tile trial, on one NVIDIA GPU:

    python -m f_lite_tpu_torch.tools.int8_tiles [--against DIR] [--k-sweep]

Builds the int8 product (`csrc/int8_gemm.cu` `int8_gemm_kernel`) and
prints ptxas' lines of its instances (`forward_tiles.build_all`). Both of
its designs are launched, whatever `int8_gemm.gemm_design` would pick:
"pingpong" (128 x 128 tiles) and "cooperative" (a 128 x 256 tile). At
every shape of `chip_smoke.INT8_SHAPES` and of `edge_shapes` (the
persistent grid's edges, ragged M and K; checked, not timed) it checks
each design against the plain versions bit for bit in every output type
(bf16 and fp32, each with and without bias, and the int32 accumulators)
and times raw launches (bf16 out, no bias; `forward_tiles.time_ms`:
replays of a CUDA graph of them, timed with CUDA events), the designs in
turns (a, b, ..., b, a) beside bf16 `F.linear` at the same shape, and
prints the shape's bound and which design the wrapper picks there.
With `--against DIR` the product kernel of another checkout (DIR holds its
`f_lite_tpu_torch/`, e.g. an unpacked `git archive` of an earlier commit)
joins every turn as "earlier", and every design's output is compared with
the earlier kernel's bit for bit in every output type. `--k-sweep` also
times every kernel at M 8224, N 7680 and K = `K_SWEEP` and prints the fit
t = waves * (a + b * k_tiles) of each (`fit_k_sweep`), in the kernel's
own tiles: a is the fixed cost of an output tile, b the cost of one
128-deep k-tile of it. None of these launches counts in the wrapper's
`GEMM_LAUNCHES`.

Prints the card's name and power limit, one JSON line per kernel and
shape, one `equal` line per shape and output type, the sweep's lines and
last one JSON line {"tiles": [...], "fits": [...]}. Exits non-zero
without a card ("needs an NVIDIA GPU"), and where any output differs from
the plain version's or the earlier kernel's.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import math
import statistics
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch
import torch.nn.functional as F

from f_lite_tpu_torch.ops.cuda import build
from f_lite_tpu_torch.ops.cuda import int8_gemm as ig
from f_lite_tpu_torch.tools.forward_tiles import build_all, card_line, time_in_turns

SOURCE = "int8_gemm"
ROOT = Path(__file__).resolve().parents[2]
DESIGNS = {"pingpong": ig.PINGPONG, "cooperative": ig.COOPERATIVE}
K_SWEEP = (128, 256, 512, 1024, 2560, 4096, 5120, 10240)
# K of the grid-edge checks, 16 past a whole 128-deep k-tile: short and long
# under COOPERATIVE_MIN_K, and one above it
EDGE_K = (144, 2576, 5136)
SWEEP_MN = (8224, 7680)
# (label, output dtype, with bias)
MODES = (("bf16", torch.bfloat16, False), ("bf16+bias", torch.bfloat16, True),
         ("fp32", torch.float32, False), ("fp32+bias", torch.float32, True),
         ("int32", torch.int32, False))
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# the C entry's int arguments after (M, N, K, out_dtype) by its
# `int8_gemm_abi`: none (one block a tile), or the SM count and the design
_ABI_INTS = {1: 4, 2: 6}


class Kernel(NamedTuple):
    """A library's `int8_gemm_dequant`, its argument list (`int8_gemm_abi`,
    1 where the library has none), the design it is launched with (None:
    the one `gemm_design` picks for K, or none in ABI 1) and the width of
    its tiles (None where that follows K)."""
    fn: object
    abi: int
    design: int | None
    block_n: int | None


def fit_k_sweep(points, m: int, n: int, num_sms: int, block_n: int) -> dict:
    """Least-squares fit of t = waves * (a + b * k_tiles) to `points`
    [(K, ms), ...] at one (m, n) for tiles of 128 x `block_n`: waves =
    ceil(tiles / num_sms), k_tiles = ceil(K / 128). a (`fixed_us_per_tile`)
    is the fixed cost of an output tile, b (`us_per_k_tile`) the cost of
    one of its k-tiles, both in us; `max_abs_residual_us` is the largest
    distance of a point from the line in the same unit, and a is resolved
    only where it is larger than that."""
    waves = math.ceil(math.ceil(m / 128) * math.ceil(n / block_n) / num_sms)
    xs = [math.ceil(k / 128) for k, _ in points]
    ys = [ms * 1e3 / waves for _, ms in points]
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    b = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
         / sum((x - mx) ** 2 for x in xs))
    a = my - b * mx
    residuals = [abs(a + b * x - y) for x, y in zip(xs, ys)]
    return dict(tile=f"128x{block_n}", fixed_us_per_tile=a, us_per_k_tile=b,
                waves=waves, max_abs_residual_us=max(residuals),
                max_rel_residual=max(r / y for r, y in zip(residuals, ys)),
                fixed_cost_resolved=abs(a) > max(residuals))


def grid_edge_ms(num_sms: int) -> list[int]:
    """M values at which a product with one n-tile meets the persistent
    grid's edges on `num_sms` SMs: SMs - 1 m-tiles (the last of 77 rows),
    SMs (whole), SMs + 1 (the last of one row) and a partial last round
    (SMs + SMs // 3 m-tiles, the last of 64 rows)."""
    return [ig.BLOCK_M * (tiles - 1) + last
            for tiles, last in ((num_sms - 1, 77), (num_sms, ig.BLOCK_M),
                                (num_sms + 1, 1), (num_sms + num_sms // 3, 64))]


def edge_shapes(num_sms: int) -> list[tuple]:
    """(label, M, N, K) of the grid-edge checks: every M of `grid_edge_ms`
    at each K of EDGE_K, N one tile of the design the wrapper picks there."""
    return [(f"edge_m{m}_k{k}", m, ig.BLOCK_N[ig.gemm_design(k)], k)
            for k in EDGE_K for m in grid_edge_ms(num_sms)]


def smoke_module():
    """chip_smoke.py of this checkout (its INT8_SHAPES and bounds)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def kernels_of(against: Path | None) -> dict:
    """{label: Kernel}: this checkout's designs, and the earlier
    checkout's kernel with `against`; every library built first."""
    builds = {"this": ((), build.CSRC)}
    if against is not None:
        builds["earlier"] = ((), against / "f_lite_tpu_torch" / "csrc")
    build_all(SOURCE, builds.values(), keep=("Compiling entry", "spill", "Used", "warning"))

    def bind(defines, csrc):
        lib = build.load(SOURCE, defines, csrc)
        abi = (ctypes.c_int.in_dll(lib, "int8_gemm_abi").value
               if hasattr(lib, "int8_gemm_abi") else 1)
        fn = lib.int8_gemm_dequant
        fn.restype = _INT
        fn.argtypes = [_PTR] * 6 + [_INT] * _ABI_INTS[abi] + [_PTR]
        return fn, abi

    fn, abi = bind(*builds["this"])
    out = {label: Kernel(fn, abi, design, ig.BLOCK_N[design])
           for label, design in DESIGNS.items()}
    if against is not None:
        fn, abi = bind(*builds["earlier"])
        out["earlier"] = Kernel(fn, abi, None, 256 if abi == 1 else None)
    return out


def launch(kernel: Kernel, x8, sx, w8, scale, bias, out, num_sms) -> None:
    (m, k), n = x8.shape, w8.shape[0]
    ints = (m, n, k, ig._OUT_CODES[out.dtype])
    if kernel.abi == 2:
        design = ig.gemm_design(k) if kernel.design is None else kernel.design
        ints += (num_sms, design)
    err = kernel.fn(x8.data_ptr(), sx.data_ptr(), w8.data_ptr(), scale.data_ptr(),
                    None if bias is None else bias.data_ptr(), out.data_ptr(), *ints,
                    torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{SOURCE} launch failed: "
                           f"{ig.LAUNCH_ERRORS.get(err, f'CUDA error {err}')}")


def operands(m, n, k, gen):
    """(x8, sx, w8, scale, bias fp32, w bf16) from seeded random values,
    with a zero activation row and two zero weight rows."""
    from f_lite_tpu_torch.quant import quantize_weight

    w = torch.randn((n, k), generator=gen, device="cuda") * k**-0.5
    w[3] = 0.0
    w[-1] = 0.0
    w8, scale = quantize_weight(w.to(torch.bfloat16))
    x = torch.randn((m, k), generator=gen, device="cuda") * 3
    x[m // 2] = 0.0
    x8, sx = ig.quantize_rows_plain(x.to(torch.bfloat16))
    bias = torch.randn((n,), generator=gen, device="cuda") * 0.1
    return x8, sx, w8, scale, bias, w.to(torch.bfloat16)


def check_shape(kernels, x8, sx, w8, scale, bias, num_sms) -> tuple[dict, dict]:
    """({label: [modes where the kernel differs from plain]}, {mode:
    {label: equal to the earlier kernel}}) at one shape."""
    m, n = x8.shape[0], w8.shape[0]
    ones = torch.ones((max(m, n),), device="cuda")
    wrong = {label: [] for label in kernels}
    equal = {}
    for mode, dtype, with_bias in MODES:
        b = bias.to(dtype) if with_bias else None
        if dtype == torch.int32:
            args, want = (ones[:m], w8, ones[:n], None), ig.int8_matmul_plain(x8, w8)
        else:
            args, want = (sx, w8, scale, b), ig.int8_linear_plain(x8, sx, w8, scale, b, dtype)
        outs = {}
        for label, kernel in kernels.items():
            out = torch.empty((m, n), device="cuda", dtype=dtype)
            launch(kernel, x8, *args, out, num_sms)
            torch.cuda.synchronize()
            outs[label] = out
            if not torch.equal(out, want):
                wrong[label].append(mode)
        if "earlier" in outs:
            equal[mode] = {label: torch.equal(out, outs["earlier"])
                           for label, out in outs.items() if label != "earlier"}
        del outs, want
    return wrong, equal


def clocks_during(run, seconds: float = 1.5) -> dict:
    """The card's SM clock (MHz) and power draw (W), medians of nvidia-smi
    samples every 50 ms over the second half of about `seconds` of `run()`
    launched back to back."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                run()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    samples = [tuple(map(float, line.split(","))) for line in out.splitlines()
               if line.count(",") == 1]
    late = samples[len(samples) // 2:] or [(math.nan, math.nan)]
    return dict(sm_mhz=statistics.median(c for c, _ in late),
                power_w=statistics.median(w for _, w in late), samples=len(samples))


def k_sweep(kernels, num_sms, gen) -> list[dict]:
    """Every kernel at M 8224, N 7680 and each K of K_SWEEP (bf16 out, in
    turns), and the card's clock and power under each at K 2560 and 10240;
    one fit a kernel of a fixed tile."""
    m, n = SWEEP_MN
    points = {label: [] for label in kernels}
    for k in K_SWEEP:
        x8 = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                           dtype=torch.int8)
        w8 = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                           dtype=torch.int8)
        sx = torch.rand((m,), generator=gen, device="cuda") + 0.5
        scale = torch.rand((n,), generator=gen, device="cuda") * 1e-3
        out = torch.empty((m, n), device="cuda", dtype=torch.bfloat16)
        times = time_in_turns(kernels, lambda label: launch(
            kernels[label], x8, sx, w8, scale, None, out, num_sms))
        for label in kernels:
            ms = sum(times[label]) / len(times[label])
            points[label].append((k, ms))
            row = dict(candidate=label, m=m, n=n, k=k, k_tiles=math.ceil(k / 128),
                       ms=ms, ms_each=times[label],
                       picked=DESIGNS.get(label) == ig.gemm_design(k))
            print("ksweep", json.dumps(row), flush=True)
        if k in (2560, 10240):
            for label in kernels:
                clocks = clocks_during(lambda: launch(
                    kernels[label], x8, sx, w8, scale, None, out, num_sms))
                print("clocks", json.dumps(dict(candidate=label, k=k, **clocks)),
                      flush=True)
        del x8, w8, out
    fits = []
    for label, pts in points.items():
        block_n = kernels[label].block_n
        if block_n is None:  # its tile follows K: no one line
            continue
        # every K, then the K >= 1024 alone: below it the output's bytes,
        # not the tiles, set the time
        fit = dict(candidate=label, **fit_k_sweep(pts, m, n, num_sms, block_n),
                   k1024=fit_k_sweep([p for p in pts if p[0] >= 1024], m, n,
                                     num_sms, block_n))
        print("fit", json.dumps(fit), flush=True)
        fits.append(fit)
    return fits


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="a checkout whose product kernel is timed beside")
    parser.add_argument("--k-sweep", action="store_true",
                        help="fit each kernel's fixed cost a tile and cost a k-tile")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("int8_tiles: needs an NVIDIA GPU")
    print("card:", card_line(), flush=True)
    smoke = smoke_module()
    kernels = kernels_of(args.against)
    num_sms = ig.num_sms(0)
    gen = torch.Generator("cuda").manual_seed(15)
    rows, bad, differ = [], [], []
    edges = edge_shapes(num_sms)
    for shape, m, n, k in smoke.INT8_SHAPES + edges:
        x8, sx, w8, scale, bias, w = operands(m, n, k, gen)
        wrong, equal = check_shape(kernels, x8, sx, w8, scale, bias, num_sms)
        for mode, eq in equal.items():
            print("equal", json.dumps(dict(shape=shape, mode=mode,
                                           equal_to_earlier=eq)), flush=True)
            differ += [(shape, mode, label) for label, e in eq.items() if not e]
        bad += [(shape, label, mode) for label in kernels for mode in wrong[label]]
        if (shape, m, n, k) in edges:  # checked, not timed
            print("edge", json.dumps(dict(shape=shape, m=m, n=n, k=k, differs_from_plain={
                label: wrong[label] for label in kernels})), flush=True)
            continue
        x = torch.empty((m, k), device="cuda", dtype=torch.bfloat16)
        out = torch.empty((m, n), device="cuda", dtype=torch.bfloat16)
        labels = [*kernels, "bf16_linear"]

        def run(label):
            if label == "bf16_linear":
                F.linear(x, w)
            else:
                launch(kernels[label], x8, sx, w8, scale, None, out, num_sms)

        times = time_in_turns(labels, run)
        bound, bound_by = smoke.int8_bounds_ms(m, n, k, 2)["gemm"]
        for label in labels:
            ms = sum(times[label]) / len(times[label])
            row = dict(candidate=label, shape=shape, m=m, n=n, k=k, ms=ms,
                       ms_each=times[label], bound_ms=bound, bound_by=bound_by,
                       share_of_bound=bound / ms)
            if label in kernels:
                row["picked"] = DESIGNS.get(label) == ig.gemm_design(k)
                row["equal_to_plain"] = not wrong[label]
                row["differs_from_plain_in"] = wrong[label]
                if args.against is not None and label != "earlier":
                    row["equal_to_earlier"] = all(eq[label] for eq in equal.values())
            print("tiles", json.dumps(row), flush=True)
            rows.append(row)
        del x8, sx, w8, scale, bias, w, x, out
        torch.cuda.empty_cache()
    fits = k_sweep(kernels, num_sms, gen) if args.k_sweep else []
    print(json.dumps({"tiles": rows, "fits": fits}), flush=True)
    if bad:
        raise SystemExit(f"int8_tiles: differs from the plain version: {bad}")
    if differ:
        raise SystemExit(f"int8_tiles: differs from the earlier kernel: {differ}")
    return rows


if __name__ == "__main__":
    main()
