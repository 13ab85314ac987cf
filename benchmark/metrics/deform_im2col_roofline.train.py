"""The deform_im2col kernel's share of its roofline in the traced slice of
training steps: its least time at the steps' shapes over its device time."""

from benchmark.core import readers


def read(rec):
    return readers.roofline_pct(rec, "deform_im2col")
