"""The host's time in the training step's call, mean milliseconds over
the window's steps."""

from benchmark.core import readers


def read(rec):
    return readers.span_ms(rec, "dispatch")
