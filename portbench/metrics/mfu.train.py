"""The training step's share of the card's bf16 peak, in %: 3 x the
forward's flops (model flops: the recomputed blocks not counted), from the
shapes of each step's batch, at 989 TFLOP/s, over the steps' host-clock
times, summed over the steps outside the profiled window."""

from portbench.flops import PEAK_FLOPS
from portbench.readers import train_forward_flops, unprofiled


def read(record):
    rows = unprofiled(record.get("steps", []))
    if not rows:
        return None
    least = sum(3.0 * train_forward_flops(record, r) for r in rows) / PEAK_FLOPS["bfloat16"]
    return 100.0 * least / sum(r["seconds"] for r in rows)
