"""Kernel #1 (`csrc/flash_attention_fwd.cu`) against its roofline, in %:
the least time of every launch in the profiled steps (operations for
self-attention, bytes for cross-attention over the real keys, from the
shapes) over the kernel's device time there. None where the program's
launch counter disagrees with the launches the shapes list."""

from portbench.flops import attention_fwd_bound_s
from portbench.readers import device_s, serve_forward, serve_profiled


def read(record):
    prof = serve_profiled(record)
    took = device_s(record, "denoise", "flash_fwd")
    if prof is None or took is None:
        return None
    span, steps = prof
    att, _ = serve_forward(record, span["text_len"])
    if record["profile"]["counts"]["fwd"] != steps * len(att):
        return None
    return 100.0 * steps * sum(attention_fwd_bound_s(*a) for a in att) / took
