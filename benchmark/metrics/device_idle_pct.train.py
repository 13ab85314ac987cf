"""The share of the traced slice in which no operation ran on the card."""

from benchmark.core import readers


def read(rec):
    return readers.idle_pct(rec)
