"""The card's idle milliseconds a round of the traced slice while the host
was inside the model's layers: the idle gaps named after the program spans
sniper/trunk, sniper/rpn and sniper/head (the span open at a gap's
middle). None under a program that opens no spans."""

from benchmark.core import spans


def read(rec):
    return spans.idle_ms(rec, ("trunk", "rpn", "head"))
