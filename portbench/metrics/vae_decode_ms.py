"""ms a decode: `models/vae.py`'s decoder between its pre- and post-hooks
(synchronised), averaged over the requests outside the profiled window."""

from portbench.readers import mean, unprofiled


def read(record):
    return mean(1e3 * r["decode_s"] for r in unprofiled(record.get("spans", [])))
