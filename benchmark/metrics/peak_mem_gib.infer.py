"""The card's peak allocated memory over the window, GiB."""

from benchmark.core import readers


def read(rec):
    return readers.peak_gib(rec)
