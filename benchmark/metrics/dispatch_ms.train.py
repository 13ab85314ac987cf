"""The host's own work in the training step's call: its milliseconds,
mean over steps taken after the window each with the card drained before
it, so that the call never waits for room in the launch queue
(drivers/train_step.py)."""

from benchmark.core import readers


def read(rec):
    return readers.span_ms(rec, "dispatch")
