"""What the per-layer readers share: each reader file under
``benchmark/metrics/`` is one metric, and reads a run's record through one
of these. A reader that finds nothing to read returns None, and the
harness leaves its metric out of the line.

The record (a driver's ``record``): ``window_s``, the work done in it
(``rounds`` and ``round_flops``, or ``steps`` and ``step_flops``),
``spans`` (host seconds per round or step, by name), ``peak_flops``,
``window_peak_bytes``, and in a traced run ``trace`` (the profiled slice:
``busy_s``, ``window_s``, device seconds ``by_group``) and ``bounds``
(each hand kernel's least seconds over the slice).
"""

from __future__ import annotations


def span_ms(rec, name):
    """The mean host milliseconds of a span over the window."""
    v = rec.get("spans", {}).get(name)
    return sum(v) / len(v) * 1e3 if v else None


def mfu_pct(rec, units, flops):
    """The window's counted FLOPs over its seconds, as a percentage of the
    card's dense bf16 peak."""
    if not rec.get(units) or not rec.get("peak_flops"):
        return None
    return rec[units] * rec[flops] / rec["window_s"] / rec["peak_flops"] * 100


def roofline_pct(rec, kernel):
    """A hand kernel's least seconds over its device seconds in the traced
    slice, as a percentage."""
    t = rec.get("trace", {}).get("by_group", {}).get(kernel)
    bound = rec.get("bounds", {}).get(kernel)
    if not t or bound is None:
        return None
    return bound / t * 100


def idle_pct(rec):
    """The share of the measured window in which the card ran nothing:
    the traced slice's busy seconds per round or step (the union of its
    device intervals) against the window's seconds per round or step. The
    slice's own idle share reads higher where the host paces the card,
    since the profiler slows the host's launches and not the device's
    kernels."""
    tr = rec.get("trace", {})
    if not tr.get("busy_s") or not rec.get("units") \
            or not rec.get("slice_units"):
        return None
    busy = tr["busy_s"] / rec["slice_units"]
    return (1 - busy / (rec["window_s"] / rec["units"])) * 100


def peak_gib(rec):
    v = rec.get("window_peak_bytes")
    return v / 2**30 if v else None
