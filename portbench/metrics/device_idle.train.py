"""The device's idle share of the profiled training steps, in %: 1 - busy
/ wall."""

from portbench.readers import idle_percent


def read(record):
    return idle_percent(record)
