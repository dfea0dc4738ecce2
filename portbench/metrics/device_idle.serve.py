"""The device's idle share of the profiled window of a request (its last
steps, its decode and its return), in %: 1 - busy / wall."""

from portbench.readers import idle_percent


def read(record):
    return idle_percent(record)
