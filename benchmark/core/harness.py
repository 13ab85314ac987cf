"""The harness's common parts: the cell's files, statistics, the profiled
slice and the result line.

A cell is one entry of BENCHMARK.json's ``workloads``; everything it needs
is found by name:

- ``benchmark/configs/<config>.json``: the model configuration as run;
- ``benchmark/traffic/<traffic>.json``: the traffic mix, whose ``driver``
  names ``benchmark/drivers/<driver>.py``;
- ``benchmark/limits/<workload>.json``: each compared number's limit;
- ``benchmark/metrics/<metric>.py``: one reader per per-layer metric.

A metric named ``<m>.<tag>`` that has no reader (per-layer) or driver
value (end-to-end) of its own is ``<m>`` under an entry of its own, with
its own bound and its own cells: one quantity split between cells
(``metric_file``, ``e2e_value``).
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
# what the process that prints a result may not hold, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sniper_tpu")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A reader or driver file, loaded by its path (its name may hold
    dots)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_file_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_file(name: str) -> Path:
    """The reader of the per-layer metric ``name``: its own file, or that
    of the metric it splits (module doc)."""
    path = BENCH / "metrics" / f"{name}.py"
    if path.is_file() or "." not in name:
        return path
    return metric_file(name.rsplit(".", 1)[0])


def e2e_value(values: dict, name: str):
    """The end-to-end metric ``name`` of a driver's ``values``: its own, or
    that of the metric it splits (module doc)."""
    if name in values or "." not in name:
        return values[name]
    return e2e_value(values, name.rsplit(".", 1)[0])


def load_cell(workload: str) -> dict:
    """The cell ``workload`` of the checkout's BENCHMARK.json: its entry,
    configuration, traffic, limits, and the end-to-end and per-layer
    metric entries it reports."""
    spec = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")

    def reports(m):
        return "workloads" not in m or workload in m["workloads"]

    return dict(
        entry=entry,
        config=load_json(BENCH / "configs" / f"{entry['config']}.json"),
        traffic=load_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(BENCH / "limits" / f"{workload}.json"),
        end_to_end=[m for m in spec["end_to_end"] if reports(m)],
        per_layer=[m for m in spec["per_layer"] if reports(m)],
    )


def p95(values) -> float:
    """The 95th percentile of all the samples (linear between order
    statistics)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# the profiled slice
# ---------------------------------------------------------------------------


def _union(intervals):
    """Merge [start, end) intervals; returns the merged list."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_trace(path: str, slice_name: str, group_of) -> dict:
    """The device's work inside the host annotation ``slice_name`` of a
    Chrome trace written by torch.profiler: busy seconds (the union of the
    device's kernel, copy and set intervals), the slice's seconds, device
    seconds by kernel group, and the idle gaps, each named by the host
    annotation (``record_function``) open at its middle."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    span = next((e for e in events if e.get("name") == slice_name
                 and e.get("cat") == "user_annotation"), None)
    if span is None:
        return {}
    t0, t1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if s + d <= t0 or s >= t1:
            continue
        if e.get("cat") in DEVICE_CATS:
            device.append((max(s, t0), min(s + d, t1), e["name"], d))
        elif (e.get("cat") == "user_annotation"
              and e.get("name") != slice_name):
            host.append((s, s + d, e["name"]))
    busy = _union([(s, e) for s, e, _, _ in device])
    by_group: dict = {}
    for _, _, name, d in device:
        g = group_of(name)
        by_group[g] = by_group.get(g, 0.0) + d * 1e-6
    gaps, last = [], t0
    for s, e in busy + [[t1, t1]]:
        if s > last:
            mid = (s + last) / 2
            label = next((n for hs, he, n in host if hs <= mid < he),
                         "between host spans")
            gaps.append((label, (s - last) * 1e-6))
        last = max(last, e)
    return dict(busy_s=sum(e - s for s, e in busy) * 1e-6,
                window_s=(t1 - t0) * 1e-6, by_group=by_group, gaps=gaps)


class Profiled:
    """torch.profiler (the host's ops and the device's) over a slice of
    the run, its trace written to TMPDIR, read back and deleted: ``with
    Profiled() as p: with p.slice(): ...``, then
    ``p.summary(group_of)``."""

    NAME = "benchmark_slice"

    def __init__(self):
        self.prof = None
        self.path = None

    def __enter__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        return self

    def slice(self):
        import torch

        return torch.profiler.record_function(self.NAME)

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        fd, self.path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        self.prof.export_chrome_trace(self.path)
        return False

    def summary(self, group_of) -> dict:
        if self.path is None:
            return {}
        try:
            return read_trace(self.path, self.NAME, group_of)
        finally:
            os.unlink(self.path)


def breakdown(trace: dict) -> dict:
    """The result line's breakdown: the device groups that took most
    time, and the longest idle gaps by what the host was doing."""
    ops = sorted(trace.get("by_group", {}).items(), key=lambda kv: -kv[1])
    gaps = sorted(trace.get("gaps", []), key=lambda kv: -kv[1])
    return {"device_ops": [[k, v] for k, v in ops[:10]],
            "idle_gaps": [[k, v] for k, v in gaps[:10]]}


def finite(v) -> bool:
    return v is not None and isinstance(v, (int, float)) and math.isfinite(v)
