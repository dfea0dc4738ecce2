"""The numbers that decide `correct`, and the judgement against the
cell's limits (`portbench/limits/<cell>.json`: for each number, its limit
and the readings it was set from).

Serving, for each checked request and step s (the program's own state z_s
going in):
- step_err: |z_{s+1} - z'_{s+1}| / |z'_{s+1} - z_s|, z' the reference's
  step from z_s: the DiT, the CFG combine and the Euler update together,
  relative to the step's own move (L2 norms over the latents);
- proj_err: |y - y'| / |y'| for each kept projection (rows of its input
  x and output y, `drivers/serve.py`), y' the reference's product of x
  in the precision the mix states: the projections' own arithmetic,
  which step_err's bf16 floor (the state rounded to bf16 around each
  step) hides;
- pixel_mad: the mean |difference| in uint8 levels between the image the
  program returned and the reference's decode of the program's final
  latents.
Training, over the first three steps, against the reference run from the
same weights and batches:
- loss_gap: |loss - loss'| / |loss'|, the worst of the three steps;
- grad_gap: per leaf, | |g| - |g'| | / max(|g'|, the median leaf's |g'|),
  the worst leaf, g the first update's clipped gradient (the program's
  read from its first moment, mu / (1 - b1));
- change_gap: the same of each leaf's |p_3 - p_0|, over the leaves whose
  reference gradient is at least a thousandth of the median leaf's.
"""

from __future__ import annotations

import math
import statistics


def rel_l2(got, want, base) -> float:
    """|got - want| / |base| (L2 over every value)."""
    return float((got.float() - want.float()).norm() / base.float().norm())


def leaf_gap(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """(the worst leaf's | |a| - |b| | / max(|b|, median |b|), its name)
    of two maps of per-leaf norms; `keep` limits the leaves."""
    names = [k for k in ref if keep is None or k in keep]
    median = statistics.median(ref[k] for k in names)
    worst, which = 0.0, ""
    for k in names:
        gap = abs(prog[k] - ref[k]) / max(ref[k], median)
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, which = gap, k
    return worst, which


def moved_leaves(grad_norms: dict) -> set:
    """The leaves whose gradient is at least 1e-3 of the median leaf's."""
    median = statistics.median(grad_norms.values())
    return {k for k, v in grad_norms.items() if v >= 1e-3 * median}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number finite and at
    most its limit; a number with no limit fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name, {}).get("limit")
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not (math.isfinite(value) and value <= limit):
            ok = False
    return ok, checks
