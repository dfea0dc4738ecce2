"""Device ms a denoise step of the kernels outside the port's kernels and
cuBLAS (class "other": the DiT's norms, rope, modulation, SwiGLU and
copies), over the profiled steps."""

from portbench.readers import device_s, serve_profiled


def read(record):
    prof = serve_profiled(record)
    other = device_s(record, "denoise", "other")
    if prof is None or other is None:
        return None
    return 1e3 * other / prof[1]
