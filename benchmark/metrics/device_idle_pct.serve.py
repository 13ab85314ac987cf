"""The share of the window in which no operation ran on the card, in the
open loop (readers.idle_pct)."""

from benchmark.core import readers


def read(rec):
    return readers.idle_pct(rec)
