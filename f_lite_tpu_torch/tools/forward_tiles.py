"""The forward kernel's tile trial, on one NVIDIA GPU:

    python -m f_lite_tpu_torch.tools.forward_tiles [--against DIR]

Builds the bf16 forward (`csrc/flash_attention_fwd.cu`) once for each
candidate number of keys per K/V tile (BK: 64 and 80 at head dim 256, 32,
64 and 128 at head dim 64), each into its own library (`build.load(...,
defines=...)`, all nvcc processes at once), prints ptxas' register and
spill lines of each, checks each against `flash_attention_plain` within
`flash_attention.tolerance`, and times each at the bf16 shapes of the
serving and training paths (`time_ms`: replays of a CUDA graph of raw
launches, timed with CUDA events), the candidates in turns (a, b, ..., b,
a) so that drift of the card's clock falls on all. With `--against
DIR` the forward of another checkout (DIR holds its `f_lite_tpu_torch/`,
e.g. an unpacked `git archive` of an earlier commit) joins every turn as
"earlier", and the shipped tile's output (`flash_variants.SERVING_BLOCKS`)
is compared with the earlier forward's bit for bit at every shape: a
change that means to leave the forward's arithmetic alone shows
`"equal_to_earlier": true` on every shipped row; the SASS of the shipped
tile's bf16 kernel is compared with the earlier library's too (`cuobjdump
-sass`, instructions without addresses and encodings), one `sass` line a
head dim. The package's wrapper
always launches the shipped tiles (the source's defaults); none of these
launches counts in its `LAUNCHES`.

Prints the card's name and power limit, one JSON line per head dim,
candidate and shape, one `bitwise` line per shape with --against, and last
one JSON line {"tiles": [...]} of every row. Exits non-zero where a
candidate is outside the tolerance or the shipped tile's output differs
from the earlier forward's.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from f_lite_tpu_torch.ops.cuda import build
from f_lite_tpu_torch.ops.cuda import flash_attention as fa
from f_lite_tpu_torch.ops.cuda import flash_variants as fv

SOURCE = "flash_attention_fwd"
CANDIDATES = {256: (64, 80), 64: (32, 64, 128)}
# (label, B, H, Lq, Lk, kv_lens or None) at each head dim: every bf16 call
# of the serving and training paths
SHAPES = {
    256: [("7b_self", 2, 10, 4112, 4112, None),
          ("7b_cross", 2, 10, 4112, 128, [77, 128]),
          ("7b1280_self", 2, 10, 6416, 6416, None),
          ("7b1280_cross", 2, 10, 6416, 128, [77, 128]),
          ("train_7b_self", 4, 10, 1040, 1040, None),
          ("train_7b_cross", 4, 10, 1040, 128, [77, 128, 77, 128])],
    64: [("fixture_self", 48, 4, 1040, 1040, None),
         ("fixture_cross", 48, 4, 1040, 32, [32] * 48)],
}
REPS = 20


def candidates(d: int, against: Path | None) -> dict:
    """{label: (defines, source dir)} of head dim `d`."""
    out = {f"bk{bk}": ((f"FLASH_FWD_BK_D{d}={bk}",), build.CSRC)
           for bk in CANDIDATES[d]}
    if against is not None:
        out["earlier"] = ((), against / "f_lite_tpu_torch" / "csrc")
    return out


def entry(defines, csrc):
    fn = build.load(SOURCE, defines, csrc).flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def launch(fn, q, k, v, lens, out) -> None:
    b, h, lq, d = q.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if lens is None else lens.data_ptr(), out.data_ptr(), None,
             b, h, lq, k.shape[2], d, d**-0.5, 1,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{SOURCE} launch failed: code {err}")


def time_ms(run) -> float:
    """Device time of one `run()` in ms: REPS launches captured in a CUDA
    graph, the replay timed with CUDA events, so that the host's cost of a
    launch (the ctypes call, the tensor maps) does not count."""
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            run()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def time_in_turns(labels, run) -> dict:
    """{label: [ms, ms]}: `run(label)` timed (`time_ms`) for every label in
    turns (a, b, ..., b, a), so that drift of the card's clock falls on
    all."""
    times = {label: [] for label in labels}
    for label in list(labels) + list(labels)[::-1]:
        times[label].append(time_ms(lambda: run(label)))
    return times


def build_all(source: str, builds,
              keep=("bf16", "spill", "Used", "warning")) -> None:
    """Build `source` for every (defines, csrc) of `builds`, all nvcc
    processes at once, and print the lines of each one's ptxas report that
    hold one of `keep` (by default the bf16 kernels' names and the
    register, spill and warning lines)."""
    builds = sorted(set(builds), key=str)
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda b: build.build([source], *b), builds))
    for defines, csrc in builds:
        log = build.library_path(source, defines, csrc).with_suffix(".log")
        for line in log.read_text().splitlines():
            if any(w in line for w in keep):
                print(f"  ptxas {csrc.parts[-3]} {' '.join(defines)}: "
                      f"{line.strip()[:160]}", flush=True)


def sass(lib: Path, kernel: str) -> list[str]:
    """The instructions of the function of library `lib` whose mangled name
    holds `kernel` (`cuobjdump -sass`; addresses and encodings dropped)."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    for part in text.split("Function : ")[1:]:
        if kernel in part.split("\n", 1)[0]:
            return re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", part)
    raise ValueError(f"no function {kernel} in {lib}")


def compare_sass(d: int, against: Path) -> dict:
    """Whether the shipped tile's bf16 kernel at head dim `d` compiles to
    the same instructions as the earlier checkout's, the same ones in
    another order (registers named alike), and how many lines differ."""
    kernel = f"flash_fwd_bf16_kernelILi{d}E"
    ours, theirs = (sass(build.library_path(SOURCE, *b), kernel)
                    for b in (candidates(d, None)[f"bk{fv.SERVING_BLOCKS[d][1]}"],
                              candidates(d, against)["earlier"]))
    return dict(d=d, equal_to_earlier=ours == theirs,
                same_instructions_in_another_order=sorted(ours) == sorted(theirs),
                lines_differing=sum(a != b for a, b in zip(ours, theirs)),
                instructions=[len(ours), len(theirs)])


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="a checkout whose forward is timed beside")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("forward_tiles: needs an NVIDIA GPU")
    print("card:", card_line(), flush=True)
    build_all(SOURCE, [v for d in CANDIDATES
                       for v in candidates(d, args.against).values()])
    sass_rows = []
    if args.against is not None:
        for d in CANDIDATES:
            sass_rows.append(compare_sass(d, args.against))
            print("sass", json.dumps(sass_rows[-1]), flush=True)
    rows = []
    gen = torch.Generator("cuda").manual_seed(0)
    for d in CANDIDATES:
        fns = {label: entry(*b) for label, b in candidates(d, args.against).items()}
        labels = list(fns)
        for shape, b, h, lq, lk, kv in SHAPES[d]:
            q, k, v = (torch.randn((b, h, n, d), generator=gen, device="cuda",
                                   dtype=torch.bfloat16) for n in (lq, lk, lk))
            lens = None if kv is None else torch.tensor(kv, dtype=torch.int32,
                                                        device="cuda")
            ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), lens)
            tol = fa.tolerance(ref, torch.bfloat16)
            out = torch.empty_like(q)
            errs, outs = {}, {}
            for label in labels:
                launch(fns[label], q, k, v, lens, out)
                torch.cuda.synchronize()
                errs[label] = float((out.float() - ref).abs().max())
                outs[label] = out.clone()
            shipped = f"bk{fv.SERVING_BLOCKS[d][1]}"
            equal = (torch.equal(outs[shipped], outs["earlier"])
                     if "earlier" in outs else None)
            if equal is not None:
                print("bitwise", json.dumps(dict(d=d, shape=shape, candidate=shipped,
                                                 equal_to_earlier=equal)), flush=True)
            times = time_in_turns(
                labels, lambda label: launch(fns[label], q, k, v, lens, out))
            for label in labels:
                row = dict(d=d, candidate=label, shape=shape, q=[b, h, lq, d],
                           kv=[b, h, lk, d], kv_lens=kv, max_abs_err=errs[label],
                           tolerance=tol, ok=errs[label] <= tol,
                           ms=sum(times[label]) / len(times[label]),
                           ms_each=times[label])
                if label == shipped:
                    row["equal_to_earlier"] = equal
                print("tiles", json.dumps(row), flush=True)
                rows.append(row)
            del q, k, v, ref, out, outs
    print(json.dumps({"tiles": rows, "sass": sass_rows}), flush=True)
    bad = [(r["d"], r["candidate"], r["shape"]) for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"forward_tiles: outside the tolerance: {bad}")
    differ = [(r["d"], r["shape"]) for r in rows if r.get("equal_to_earlier") is False]
    if differ:
        raise SystemExit(f"forward_tiles: the shipped tile differs from the earlier "
                         f"forward: {differ}")
    return rows


if __name__ == "__main__":
    main()
