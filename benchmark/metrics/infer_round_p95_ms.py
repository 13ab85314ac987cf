"""The 95th percentile over all rounds of the window of a round's latency:
from the start of its dispatch to the end of its last image's decode
(host clock). The pyramid's closed loop runs at the card's capacity, where
a tail swings with the smallest change in the host's pace, so it is a
per-layer reading and not an end-to-end one."""

from benchmark.core import harness


def read(rec):
    v = rec.get("spans", {}).get("round")
    return harness.p95(v) * 1e3 if v else None
