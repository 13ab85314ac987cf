"""The program's layer spans in a profiled slice.

While a profiler records, the port opens a flat host annotation
``sniper/<layer>`` around each of its layers (sniper_tpu_torch/utils/
profiler.span): ``trunk``, ``rpn``, ``head``, ``decode``, ``loss``,
``backward``, ``optimizer``. In torch.profiler's Chrome trace they share
the clock of the device's kernels, so that:

- ``table`` reads, per span name, the host seconds inside it, the device
  seconds of the work the host launched inside it (each device event
  joined by its ``correlation`` id to the CUDA runtime or driver call that
  launched it, from whichever thread: the backward's kernels are launched
  from autograd's), the number of those launches, the device's idle
  seconds while the host was inside it, and its device seconds by kernel
  group; and the launches of the whole slice. ``harness.read_trace`` does
  not call it: its readings are printed by scripts/profile_torch_infer.py.
- ``idle_ms`` is what the per-layer readers ``host_paced_idle_ms.*`` read:
  the slice's idle gaps that ``harness.read_trace`` names after a program
  span (the span open at a gap's middle).
"""

from __future__ import annotations

import bisect

from benchmark.core.harness import DEVICE_CATS, _union

PREFIX = "sniper/"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _covered(a, b, busy, starts):
    """Seconds of [a, b) that the merged intervals ``busy`` cover."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    out = 0.0
    while i < len(busy) and busy[i][0] < b:
        out += max(0.0, min(b, busy[i][1]) - max(a, busy[i][0]))
        i += 1
    return out


def table(events, t0, t1, group_of) -> dict:
    """The program's spans in the slice [t0, t1) (microseconds) of the
    Chrome trace ``events``: ``{"spans": {name: {"host_s", "device_s",
    "launches", "idle_s", "by_group"}}, "launches": n}``. A launch is a
    runtime or driver call that starts in the slice and whose correlation
    id some device event (kernel, copy or set) carries; it belongs to the
    span inside which it starts. ``device_s`` sums its device events'
    whole durations, as the harness's ``by_group`` does; ``idle_s`` is the
    span's intervals, clipped to the slice, less the union of the device's
    busy intervals."""
    intervals, calls, device, busy = [], [], {}, []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if s + d <= t0 or s >= t1:
            continue
        cat = e.get("cat")
        corr = e.get("args", {}).get("correlation")
        if cat == "user_annotation" and e["name"].startswith(PREFIX):
            intervals.append((max(s, t0), min(s + d, t1),
                              e["name"][len(PREFIX):]))
        elif cat in LAUNCH_CATS and corr is not None and s >= t0:
            calls.append((s, corr))
        elif cat in DEVICE_CATS:
            busy.append((max(s, t0), min(s + d, t1)))
            if corr is not None:
                device.setdefault(corr, []).append((e["name"], d))
    busy = _union(busy)
    busy_starts = [s for s, _ in busy]
    intervals.sort()
    starts = [s for s, _, _ in intervals]
    spans = {}
    for s, e, name in intervals:
        row = spans.setdefault(name, dict(host_s=0.0, device_s=0.0,
                                          launches=0, idle_s=0.0,
                                          by_group={}))
        row["host_s"] += (e - s) * 1e-6
        row["idle_s"] += (e - s - _covered(s, e, busy, busy_starts)) * 1e-6
    launches = 0
    for ts, corr in calls:
        work = device.get(corr)
        if not work:
            continue
        launches += 1
        i = bisect.bisect_right(starts, ts) - 1
        if i < 0 or ts >= intervals[i][1]:
            continue
        row = spans[intervals[i][2]]
        row["launches"] += 1
        for name, d in work:
            g = group_of(name)
            row["device_s"] += d * 1e-6
            row["by_group"][g] = row["by_group"].get(g, 0.0) + d * 1e-6
    return {"spans": spans, "launches": launches}


def idle_ms(rec, names=None):
    """Milliseconds a round or step of the traced slice's idle gaps that
    the harness names after the program spans ``names`` (every program
    span when None). None where no gap of the slice is named after a
    program span, as under a program that opens none."""
    gaps = rec.get("trace", {}).get("gaps")
    units = rec.get("slice_units")
    named = [(label[len(PREFIX):], s) for label, s in gaps or ()
             if label.startswith(PREFIX)]
    if not named or not units:
        return None
    return sum(s for name, s in named
               if names is None or name in names) / units * 1e3
