"""The training steps' counted FLOPs (forward and backward) over the
window, as a share of the card's dense bf16 peak."""

from benchmark.core import readers


def read(rec):
    return readers.mfu_pct(rec, "steps", "step_flops")
