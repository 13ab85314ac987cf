"""The pyramid's counted FLOPs over the window, as a share of the card's
dense bf16 peak."""

from benchmark.core import readers


def read(rec):
    return readers.mfu_pct(rec, "rounds", "round_flops")
