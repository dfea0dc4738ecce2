"""Device ms a training step of the kernels outside the port's kernels and
cuBLAS (class "other": the forward's and backward's norms, rope,
modulation, SwiGLU, copies, the loss and AdamW's elementwise update), over
the profiled steps."""

from portbench.readers import device_s


def read(record):
    other = device_s(record, "step", "other")
    steps = sum(r["profiled"] for r in record.get("steps", []))
    if other is None or not steps:
        return None
    return 1e3 * other / steps
