"""The backward kernels' tile trial, on one NVIDIA GPU:

    python -m f_lite_tpu_torch.tools.backward_tiles [--against DIR]

Builds the bf16 backward (`csrc/flash_attention_bwd.cu`, the dq and the dkv
kernel) once for each candidate tile: the dq kernel's keys per K/V tile
(BK: 32, 48 and 64 at head dim 256; 32 and 64 at head dim 64) and the dkv
kernel's q rows per Q/dO tile at head dim 64 (BQ: 32 and 64; 64 at 256),
each into its own library (`build.load(..., defines=...)`, all nvcc
processes at once, with the forward trial's machinery), prints ptxas'
register, spill and warning lines of each, checks each candidate's dq, dk
and dv against `flash_attention_bwd_plain` within `grad_tolerance`, and
times each kernel at the bf16 shapes of the training path (replays of a
CUDA graph of raw launches, `forward_tiles.time_ms`), the candidates in
turns (a, b, ..., b, a). With `--against DIR` the
backward of another checkout (DIR holds its `f_lite_tpu_torch/`, e.g. an
unpacked `git archive` of an earlier commit) joins every turn as
"earlier"; it takes lse and delta with Lq rows a head, where this tree's
kernels take them padded (`flash_attention.pad_stat_rows`). The package's
wrapper always launches the shipped tiles (the source's defaults); none of
these launches counts in its `DQ_LAUNCHES` or `DKV_LAUNCHES`.

Prints the card's name and power limit, one JSON line per head dim,
candidate and shape, and last one JSON line {"tiles": [...]} of every row.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from f_lite_tpu_torch.ops.cuda import build
from f_lite_tpu_torch.ops.cuda import flash_attention as fa
from f_lite_tpu_torch.tools.forward_tiles import build_all, card_line, time_in_turns

SOURCE = "flash_attention_bwd"
CANDIDATES = {
    256: {f"bk{bk}": (f"FLASH_DQ_BK_D256={bk}",) for bk in (32, 48, 64)},
    64: {f"bk{bk}_bq{bq}": (f"FLASH_DQ_BK_D64={bk}", f"FLASH_DKV_BQ_D64={bq}")
         for bk, bq in ((32, 64), (64, 64), (32, 32))},
}
# (label, B, H, Lq, Lk, kv_lens or None) at each head dim: every bf16
# backward call of the training paths (f_lite_7b_width_d20_train512 and
# the fixture's recipe)
SHAPES = {
    256: [("7b_self", 4, 10, 1040, 1040, None),
          ("7b_cross", 4, 10, 1040, 128, [77, 128, 77, 128])],
    64: [("fixture_self", 32, 4, 1040, 1040, None),
         ("fixture_cross", 32, 4, 1040, 32, [32] * 32)],
}
_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def candidates(d: int, against: Path | None) -> dict:
    """{label: (defines, source dir)} of head dim `d`."""
    out = {label: (defines, build.CSRC)
           for label, defines in CANDIDATES[d].items()}
    if against is not None:
        out["earlier"] = ((), against / "f_lite_tpu_torch" / "csrc")
    return out


def entries(defines, csrc):
    """(dq entry point, dkv entry point) of one build."""
    lib = build.load(SOURCE, defines, csrc)
    dq, dkv = lib.flash_attention_bwd_dq, lib.flash_attention_bwd_dkv
    for fn, n_out in ((dq, 1), (dkv, 2)):
        fn.restype = _INT
        fn.argtypes = [_PTR] * (7 + n_out) + [_INT] * 5 + [_FLOAT, _INT, _PTR]
    return dq, dkv


def launch(fn, ins, outs) -> None:
    """One launch of an entry point on (q, k, v, dO, lse, delta, kv_lens)."""
    q, k = ins[0], ins[1]
    b, h, lq, d = q.shape
    err = fn(*(None if t is None else t.data_ptr() for t in ins + outs),
             b, h, lq, k.shape[2], d, d**-0.5, 1,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{SOURCE} launch failed: code {err}")


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="a checkout whose backward is timed beside")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("backward_tiles: needs an NVIDIA GPU")
    print("card:", card_line(), flush=True)
    build_all(SOURCE, [v for d in CANDIDATES
                       for v in candidates(d, args.against).values()])
    rows = []
    gen = torch.Generator("cuda").manual_seed(0)
    for d in CANDIDATES:
        fns = {label: entries(*b) for label, b in candidates(d, args.against).items()}
        labels = list(fns)
        for shape, b, h, lq, lk, kv in SHAPES[d]:
            q, k, v, dout = (torch.randn((b, h, n, d), generator=gen, device="cuda",
                                         dtype=torch.bfloat16)
                             for n in (lq, lk, lk, lq))
            lens = None if kv is None else torch.tensor(kv, dtype=torch.int32,
                                                        device="cuda")
            qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
            lse = fa.flash_attention_lse_plain(qf, kf, lens)
            delta = fa.attention_delta(fa.flash_attention_plain(qf, kf, vf, lens), dof)
            want = fa.flash_attention_bwd_plain(q, k, v, dout, lse, delta, lens,
                                                out_dtype=torch.float32)
            tols = [fa.grad_tolerance(w, torch.bfloat16) for w in want]
            padded = (q, k, v, dout, fa.pad_stat_rows(lse),
                      fa.pad_stat_rows(delta), lens)
            plain = (q, k, v, dout, lse, delta, lens)
            ins = {label: plain if label == "earlier" else padded
                   for label in labels}
            dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
            ratios = {}
            for label in labels:
                launch(fns[label][0], ins[label], (dq,))
                launch(fns[label][1], ins[label], (dk, dv))
                torch.cuda.synchronize()
                ratios[label] = [float((g.float() - w).abs().max()) / t
                                 for g, w, t in zip((dq, dk, dv), want, tols)]
            dq_times = time_in_turns(
                labels, lambda label: launch(fns[label][0], ins[label], (dq,)))
            dkv_times = time_in_turns(
                labels, lambda label: launch(fns[label][1], ins[label], (dk, dv)))
            for label in labels:
                dq_ms = sum(dq_times[label]) / len(dq_times[label])
                dkv_ms = sum(dkv_times[label]) / len(dkv_times[label])
                row = dict(d=d, candidate=label, shape=shape, q=[b, h, lq, d],
                           kv=[b, h, lk, d], kv_lens=kv,
                           err_over_tolerance=dict(zip(("dq", "dk", "dv"),
                                                       ratios[label])),
                           ok=max(ratios[label]) <= 1.0, dq_ms=dq_ms,
                           dkv_ms=dkv_ms, pair_ms=dq_ms + dkv_ms,
                           dq_ms_each=dq_times[label],
                           dkv_ms_each=dkv_times[label])
                print("tiles", json.dumps(row), flush=True)
                rows.append(row)
            del q, k, v, dout, qf, kf, vf, dof, want, padded, plain, ins
    print(json.dumps({"tiles": rows}), flush=True)
    bad = [(r["d"], r["candidate"], r["shape"]) for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"backward_tiles: outside the tolerance: {bad}")
    return rows


if __name__ == "__main__":
    main()
