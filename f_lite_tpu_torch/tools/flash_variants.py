"""Forward-kernel variant sweep on the card (perf lab; counterpart of
`tools/flash_variants.py` `main`).

    python -m f_lite_tpu_torch.tools.flash_variants

Runs the lab's seven rows (base, prescale, exp2, condmask, condmask-e,
alphabf16, all; `ops/cuda/flash_variants.VARIANTS`) of the variant kernel
at the 7B serving shape B=2 H=10 L=4112 D=256 in bf16, for every compiled
block pair (BQ, BK), and prints per row the mean ms over 20 launches (CUDA
events), TF/s (4*B*H*L^2*D flops) and max|Δ| against `base` at the same
blocks. `SHAPE=B,H,L,D` sets the shape; `BQ` and `BK` (both, or neither)
pick one block pair. Runs on the card only: without one it raises.
"""

from __future__ import annotations

import os

import torch

from f_lite_tpu_torch.ops.cuda import flash_variants as fv

REPS = 20
SHAPE = (2, 10, 4112, 256)


def lab_shape() -> tuple:
    if os.environ.get("SHAPE"):
        return tuple(int(x) for x in os.environ["SHAPE"].split(","))
    return SHAPE


def lab_blocks() -> tuple:
    if os.environ.get("BQ") or os.environ.get("BK"):
        return ((int(os.environ["BQ"]), int(os.environ["BK"])),)
    return fv.BLOCKS


def mean_ms(fn, reps=REPS) -> float:
    """Mean device ms of fn() over `reps` launches, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sweep(shape=None, blocks=None, *, seed=0) -> list[dict]:
    """Every (block pair, variant) row at `shape` on the card: dicts of
    block_q, block_k, variant, ms, tflops, max_abs_delta (against base)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the lab times the card")
    b, h, l, d = shape or lab_shape()
    gen = torch.Generator("cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, h, l, d), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    flops = 4.0 * b * h * l * l * d
    rows = []
    for bq, bk in blocks or lab_blocks():
        ref = None
        for name, kw in fv.VARIANTS.items():
            def run(kw=kw, bq=bq, bk=bk):
                return fv.flash_fwd(q, k, v, block_q=bq, block_k=bk, **kw)

            one = run().float()
            if ref is None:
                ref = one
            ms = mean_ms(run)
            rows.append(dict(block_q=bq, block_k=bk, variant=name, ms=ms,
                             tflops=flops / ms / 1e9,
                             max_abs_delta=float((one - ref).abs().max())))
    return rows


def format_row(r: dict) -> str:
    return (f"BQ={r['block_q']:3d} BK={r['block_k']:3d} {r['variant']:12s}: "
            f"{r['ms']:7.3f} ms {r['tflops']:6.1f} TF/s "
            f"max|Δ|={r['max_abs_delta']:.4f}")


def main() -> list[dict]:
    """Print the sweep table; returns its rows."""
    print("shape B,H,L,D =", ",".join(map(str, lab_shape())), "bf16", flush=True)
    rows = sweep()
    for r in rows:
        print(format_row(r), flush=True)
    return rows


if __name__ == "__main__":
    main()
