"""The whole request's share of the card's peak, in %: the least time of
a request (each step's products and attention at the peak of their
precision: int8 at 1,979 TOP/s, bf16 at 989 TFLOP/s; the fp32 decode at 67
TFLOP/s), counted from the shapes, over the requests' host-clock times,
summed over the requests outside the profiled window."""

from portbench.readers import serve_least_s, unprofiled


def read(record):
    rows = unprofiled(record.get("spans", []))
    if not rows:
        return None
    least = sum(serve_least_s(record, r["text_len"]) for r in rows)
    return 100.0 * least / sum(r["total_s"] for r in rows)
