"""The deform_im2col kernel's share of its roofline in the traced slice of the
pyramid: its least time at the slice's shapes over its device time."""

from benchmark.core import readers


def read(rec):
    return readers.roofline_pct(rec, "deform_im2col")
