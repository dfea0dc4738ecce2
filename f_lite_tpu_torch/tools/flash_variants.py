"""Forward-kernel variant sweep on the card (perf lab; counterpart of
`tools/flash_variants.py` `main`).

    python -m f_lite_tpu_torch.tools.flash_variants [--against DIR]

Runs the lab's seven rows (base, prescale, exp2, condmask, condmask-e,
alphabf16, all; `ops/cuda/flash_variants.VARIANTS`) of the variant kernel
(the serving forward's TMA + wgmma mainloop with the lab's softmax policy)
at the 7B serving shape B=2 H=10 L=4112 D=256 in bf16, for every block pair
(BQ, BK) compiled for that head dim (`flash_variants.blocks(d)`), and
prints per row the mean ms over 20 launches (CUDA events, through the
wrapper), TF/s (4*B*H*L^2*D flops) and max|Δ| against `base` at the same
blocks. `SHAPE=B,H,L,D` sets the shape (any D up to 256; other than 64 and
256 it runs zero-padded); `BQ` and `BK` (both, or neither) pick one block
pair.

With `--against DIR` (DIR holds another checkout's `f_lite_tpu_torch/`,
e.g. an unpacked `git archive` of an earlier commit) it then times, for
each variant, this checkout's kernel at each of its block pairs and the
earlier checkout's variant kernel at each pair that one compiled (found by
asking its entry point), as raw launches on the same prepared inputs, in
turns (a, b, ..., b, a) so that drift of the card's clock falls on all, and
prints one JSON line per variant and last one {"against": [...]} line.

Runs on the card only: without one it raises.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import torch

from f_lite_tpu_torch.ops.cuda import build
from f_lite_tpu_torch.ops.cuda import flash_attention as fa
from f_lite_tpu_torch.ops.cuda import flash_variants as fv

REPS = 20
SHAPE = (2, 10, 4112, 256)
# block pairs asked of an earlier checkout's entry point: the mma.sync
# variant kernel compiled (64, 64), (64, 128) and (128, 64); this one
# compiles BLOCKS
PROBE_BLOCKS = tuple(sorted({(64, 64), (64, 128), (128, 64)}
                            | {p for ps in fv.BLOCKS.values() for p in ps}))


def lab_shape() -> tuple:
    if os.environ.get("SHAPE"):
        return tuple(int(x) for x in os.environ["SHAPE"].split(","))
    return SHAPE


def lab_blocks(d: int) -> tuple:
    if os.environ.get("BQ") or os.environ.get("BK"):
        return ((int(os.environ["BQ"]), int(os.environ["BK"])),)
    return fv.blocks(d)


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


def _inputs(shape, seed):
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the lab times the card")
    gen = torch.Generator("cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device="cuda",
                             dtype=torch.bfloat16) for _ in range(3))


def sweep(shape=None, blocks=None, *, seed=0) -> list[dict]:
    """Every (block pair, variant) row at `shape` on the card: dicts of
    block_q, block_k, variant, ms, tflops, max_abs_delta (against base)."""
    b, h, l, d = shape or lab_shape()
    q, k, v = _inputs((b, h, l, d), seed)
    flops = 4.0 * b * h * l * l * d
    rows = []
    for bq, bk in blocks or lab_blocks(d):
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


def earlier_entry(against: Path):
    """The variant kernel's entry point of the checkout under `against`."""
    csrc = against / "f_lite_tpu_torch" / "csrc"
    return fv.bind(build.load("flash_attention_variants", (), csrc))


def against_sweep(against: Path, shape=None, *, seed=0) -> list[dict]:
    """Per variant: this checkout's kernel at each pair of `blocks(d)` and
    the earlier checkout's at each pair it compiled, raw launches timed in
    turns on the same inputs (q prescaled and every input padded along D
    once, outside the timed launches). Dicts of variant, ms {label: mean
    ms}, ms_each {label: [ms, ms]}."""
    b, h, l, d = shape or lab_shape()
    q, k, v = _inputs((b, h, l, d), seed)
    scale = d**-0.5
    d_pad = fa.padded_head_dim(d)
    k, v = fa.pad_head_dim(k), fa.pad_head_dim(v)
    out = torch.empty((b, h, l, d_pad), device="cuda", dtype=torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    fns = {"this": fv._entry(), "earlier": earlier_entry(against)}
    rows = []
    for name, kw in fv.VARIANTS.items():
        flags = fv._flags(**kw)
        qp = fa.pad_head_dim(fv.prescale_q(q, scale, kw.get("use_exp2", False))
                             if flags & 1 else q)

        def launch(which, bq, bk):
            return fns[which](qp.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), b, h, l, l, d_pad, scale, bq, bk,
                              flags, stream)

        pairs = {f"this {bq},{bk}": ("this", bq, bk) for bq, bk in fv.blocks(d)}
        for bq, bk in PROBE_BLOCKS:
            if launch("earlier", bq, bk) == 0:
                pairs[f"earlier {bq},{bk}"] = ("earlier", bq, bk)
        for label, args in pairs.items():
            if launch(*args) != 0:
                raise RuntimeError(f"flash_variants --against: {label} {name} "
                                   "did not launch")
        torch.cuda.synchronize()
        times = {label: [] for label in pairs}
        for label in list(pairs) + list(pairs)[::-1]:
            times[label].append(mean_ms(lambda: launch(*pairs[label])))
        row = dict(variant=name, shape=[b, h, l, d],
                   ms={label: sum(t) / len(t) for label, t in times.items()},
                   ms_each=times)
        print("against", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> list[dict]:
    """Print the sweep table (and with --against the comparison in turns);
    returns the sweep's rows."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="a checkout whose variant kernel is timed beside")
    args = parser.parse_args(argv)
    print("shape B,H,L,D =", ",".join(map(str, lab_shape())), "bf16", flush=True)
    rows = sweep()
    for r in rows:
        print(format_row(r), flush=True)
    if args.against is not None:
        print(json.dumps({"against": against_sweep(args.against)}), flush=True)
    return rows


if __name__ == "__main__":
    main()
