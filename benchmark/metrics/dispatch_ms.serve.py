"""The host's enqueue of a round (make_forward over its batches), mean
milliseconds over the window's rounds, in the open loop."""

from benchmark.core import readers


def read(rec):
    return readers.span_ms(rec, "dispatch")
