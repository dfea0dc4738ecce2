"""Kernels #2 and #3 (`csrc/flash_attention_bwd.cu`: dq and dk, dv)
against their roofline, in %: the least time of every backward in the
profiled steps (10 H Lq D operations a real key, or its bytes, from the
shapes) over both kernels' device time there. None where the program's
launch counters disagree with the attentions the shapes list."""

from portbench.flops import attention_bwd_bound_s
from portbench.readers import device_s, train_step_attentions


def read(record):
    took = device_s(record, "step", "flash_bwd_dq", "flash_bwd_dkv")
    rows = [r for r in record.get("steps", []) if r["profiled"]]
    if took is None or not rows:
        return None
    atts = [a for r in rows for a in train_step_attentions(record, r)]
    counts = record["profile"]["counts"]
    if counts["dq"] != len(atts) or counts["dkv"] != len(atts):
        return None
    return 100.0 * sum(attention_bwd_bound_s(*a) for a in atts) / took
