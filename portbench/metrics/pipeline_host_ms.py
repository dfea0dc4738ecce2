"""Host time of a request outside its denoise loop and its decode, in ms:
`FLitePipeline.__call__`'s own work (inputs to the device, the schedule,
the uint8 conversion and the copy back), by the host clock around the call
minus the synchronised spans of the loop and the decode, averaged over the
requests outside the profiled window."""

from portbench.readers import mean, unprofiled


def read(record):
    rows = unprofiled(record.get("spans", []))
    return mean(1e3 * (r["total_s"] - r["denoise_s"] - r["decode_s"]) for r in rows)
