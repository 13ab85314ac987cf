"""The card's idle milliseconds a step of the traced slice while the host
was inside one of the program's spans (trunk, rpn, head, loss, backward,
optimizer): the idle gaps named after them (the span open at a gap's
middle). None under a program that opens no spans."""

from benchmark.core import spans


def read(rec):
    return spans.idle_ms(rec)
