"""ms of the optimizer's step (`train/optim.py`: the global norm, the
clip and AdamW's update), by CUDA events the benchmark records around the
call, averaged over the window's steps."""

from portbench.readers import mean


def read(record):
    return mean(record.get("optimizer_ms", []))
