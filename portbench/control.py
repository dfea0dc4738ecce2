"""Readings that the limits of `correct` are set from (not run by the
benchmark's own runs): the numbers of `portbench.checks` over many seeds,
in one process, for the program as the cell runs it, for one of the
cell's controls, or for a fault planted in the program.

    python3 -m portbench.control --workload <cell> --mode program --seeds 1 2 3 ...
    python3 -m portbench.control --workload <cell> --mode <control> --seeds ...
    python3 -m portbench.control --workload <cell> --mode half_batch --seeds ...

Each seed prints one JSON line {"seed", "mode", "correct", "checks", ...}:
the numbers and `correct` as the cell's limits judge them. A run here is
a cell's run with its window cut to what the check reads: two requests
served, or no training step after the checked ones.

- program: the cell as `portbench.run` runs it;
- a control, by its name in the mix's "controls": the program with a
  lower-precision path of its own switched on ("quantize": its int8 W8A8
  path, for a bf16 model; "tf32": TF32 products in cuBLAS and cuDNN, for
  the fp32 VAE), or the reference in a lower precision put in the
  program's place ("reference_dit": "fp8" for bf16, "int4" for W8A8);
- half_batch (training): the program's loss sees the first half of each
  batch's rows, its mean taken over them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def plant_half_batch() -> None:
    """The port's training step computes its loss on half of the rows."""
    import f_lite_tpu_torch.train.step as step

    whole = step.flow_matching_loss

    def half(dit, latents, context, context_mask, *, draws=None, **kw):
        h = latents.shape[0] // 2
        return whole(dit, latents[:h], context[:h], context_mask[:h],
                     draws=draws.rows(0, h), **kw)

    step.flow_matching_loss = half


def main(argv=None) -> int:
    from portbench.run import prepare_environment, process_start

    t_start = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", default="program",
                   help="program, half_batch or a control named in the mix")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    prepare_environment()

    import torch

    from portbench import registry
    from portbench.run import RunContext, run_cell

    cell = registry.cell(args.workload)
    controls = cell.traffic["controls"]
    if args.mode not in ("program", "half_batch", *controls):
        p.error(f"--mode: program, half_batch or one of {sorted(controls)}")
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    if args.mode == "half_batch":
        plant_half_batch()
    serve = cell.traffic["driver"] == "serve"
    for seed in args.seeds:
        t0 = time.time()
        ctx = RunContext(cell.config, cell.traffic, seed, 0.0, False, device,
                         t_start if seed == args.seeds[0] else t0,
                         control=controls.get(args.mode),
                         requests=2 if serve else None, steps=None if serve else 0)
        record = run_cell(cell, ctx)
        print(json.dumps({"workload": cell.name, "mode": args.mode, "seed": seed,
                          "correct": record["correct"], "checks": record["checks"],
                          "e2e": record.get("e2e"), "seconds": time.time() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
