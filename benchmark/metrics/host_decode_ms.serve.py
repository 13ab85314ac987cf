"""The Tester's host decode of a round (detect_outputs of its batches),
mean milliseconds over the window's rounds, in the open loop."""

from benchmark.core import readers


def read(rec):
    return readers.span_ms(rec, "decode")
