"""How late the host dispatched the open loop's rounds: the 95th
percentile over the window's rounds of dispatch start less due time. It
grows through the window where the offered rate exceeds what the card and
host sustain."""

from benchmark.core import harness


def read(rec):
    v = rec.get("spans", {}).get("late")
    return harness.p95(v) * 1e3 if v else None
