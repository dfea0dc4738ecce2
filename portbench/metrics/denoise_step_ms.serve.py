"""ms a denoise step: `sampling/euler.py` `denoise`, from the DiT's first
forward to the decoder's pre-hook (both synchronised) over the steps,
averaged over the requests outside the profiled window."""

from portbench.readers import mean, unprofiled


def read(record):
    rows = unprofiled(record.get("spans", []))
    steps = record["model"]["traffic"]["steps"]
    return mean(1e3 * r["denoise_s"] / steps for r in rows)
