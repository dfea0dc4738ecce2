"""Kernels #5 and #6 (`csrc/int8_gemm.cu`: the per-token quantize and the
int8 product with its dequant) against their roofline, in %: the least
time of every launch of both in the profiled steps, from the shapes, over
both kernels' device time there. None where the program's launch
counters disagree with the launches the shapes list."""

from portbench.flops import int8_bound_s
from portbench.readers import device_s, serve_forward, serve_profiled


def read(record):
    prof = serve_profiled(record)
    took = device_s(record, "denoise", "int8_gemm", "int8_quantize")
    if prof is None or took is None or not record["model"]["quantized"]:
        return None
    span, steps = prof
    _, prods = serve_forward(record, span["text_len"])
    counts = record["profile"]["counts"]
    if counts["gemm"] != steps * len(prods) or counts["quantize"] != counts["gemm"]:
        return None
    return 100.0 * steps * sum(sum(int8_bound_s(*p)) for p in prods) / took
