"""The program's layer spans in a profiled slice (benchmark/core/spans.py):
the table on a trace whose every number is computed by hand, the idle
readers on records with and without program spans, and the spans of a
whole traced run of a tiny cell on the CPU."""

import importlib.util
import json
import time

import pytest
import torch

import tiny
from benchmark.core import harness, spans


def _x(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# the slice [100, 300) us; device events by correlation id
EVENTS = [
    _x("user_annotation", "slice", 100, 200),
    _x("user_annotation", "sniper/trunk", 110, 40),
    _x("user_annotation", "sniper/head", 160, 40),
    _x("user_annotation", "sniper/backward", 210, 50),
    _x("user_annotation", "Optimizer.step#SGD.step", 262, 2),
    _x("user_annotation", "sniper/trunk", 270, 20),
    # launched before the slice: its kernel is clipped to [100, 105)
    _x("cuda_runtime", "cudaLaunchKernel", 80, 3, corr=8),
    _x("kernel", "conv_early", 90, 15, corr=8),
    # trunk: two launches and a call that launches nothing
    _x("cuda_runtime", "cudaLaunchKernel", 112, 2, corr=1),
    _x("kernel", "conv_fprop", 115, 25, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 120, 2, corr=2),
    _x("kernel", "pool_pass_kernel", 140, 10, corr=2),
    _x("cuda_runtime", "cudaGetDevice", 130, 1, corr=3),
    # head: a launch through the driver
    _x("cuda_driver", "cuLaunchKernel", 165, 2, corr=4),
    _x("kernel", "nms_mask_kernel", 170, 10, corr=4),
    # backward: launched from autograd's thread, a copy ending past the span
    _x("cuda_runtime", "cudaLaunchKernel", 215, 2, corr=5, tid=2),
    _x("kernel", "conv_dgrad", 220, 30, corr=5),
    _x("cuda_runtime", "cudaMemcpyAsync", 255, 1, corr=6, tid=2),
    _x("gpu_memcpy", "Memcpy DtoH", 256, 6, corr=6),
    # under no span
    _x("cuda_runtime", "cudaLaunchKernel", 264, 1, corr=7),
    _x("kernel", "elementwise_kernel", 266, 2, corr=7),
]


def _group(name):
    return name.split("_")[0]


def test_table_joins_launches_to_their_spans():
    t = spans.table(EVENTS, 100.0, 300.0, _group)
    assert set(t["spans"]) == {"trunk", "head", "backward"}
    # busy: [100, 105), [115, 150), [170, 180), [220, 250), [256, 262),
    # [266, 268)
    want = {
        "trunk": dict(host_s=60e-6, device_s=35e-6, launches=2,
                      idle_s=(5 + 20) * 1e-6,
                      by_group={"conv": 25e-6, "pool": 10e-6}),
        "head": dict(host_s=40e-6, device_s=10e-6, launches=1,
                     idle_s=30e-6, by_group={"nms": 10e-6}),
        "backward": dict(host_s=50e-6, device_s=36e-6, launches=2,
                         idle_s=(10 + 6) * 1e-6,
                         by_group={"conv": 30e-6, "Memcpy DtoH": 6e-6}),
    }
    for name, row in want.items():
        got = t["spans"][name]
        assert got["launches"] == row["launches"], name
        for k in ("host_s", "device_s", "idle_s"):
            assert got[k] == pytest.approx(row[k], abs=1e-12), (name, k)
        assert got["by_group"] == pytest.approx(row["by_group"]), name
    # every correlated call that starts in the slice: 1, 2, 4, 5, 6, 7
    assert t["launches"] == 6


def test_table_and_read_trace_agree(tmp_path):
    """The table reads the slice and the busy union that read_trace reads;
    read_trace names each gap whole after the span open at its middle,
    where the table splits it at the spans' edges."""
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": EVENTS}))
    tr = harness.read_trace(str(p), "slice", _group)
    t = spans.table(EVENTS, 100.0, 300.0, _group)
    rows = t["spans"].values()
    # busy under the spans: all but [100, 105), [260, 262), [266, 268)
    assert sum(r["host_s"] - r["idle_s"] for r in rows) == \
        pytest.approx(tr["busy_s"] - 9e-6, abs=1e-12)
    named = {}
    for label, s in tr["gaps"]:
        named[label] = named.get(label, 0.0) + s
    # [105, 115) and [268, 300) trunk's, [150, 170) head's, [250, 256)
    # backward's; [180, 220) and [262, 266) between host spans
    assert named == pytest.approx({"sniper/trunk": 42e-6,
                                   "sniper/head": 20e-6,
                                   "sniper/backward": 6e-6,
                                   "between host spans": 44e-6})
    assert sum(r["idle_s"] for r in rows) == pytest.approx(71e-6)


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "reader", harness.BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


READERS = ("host_paced_idle_ms.infer", "host_paced_idle_ms.train")


@pytest.mark.parametrize("name", READERS)
def test_idle_readers_read_nothing_without_program_spans(name):
    read = _reader(name)
    assert read({}) is None
    assert read({"trace": {}, "slice_units": 4}) is None
    # a program that opens no span: every gap is between host spans
    rec = {"trace": {"gaps": [("between host spans", 0.003),
                              ("Optimizer.step#SGD.step", 0.001)]},
           "slice_units": 4}
    assert read(rec) is None


def test_idle_readers_sum_the_named_gaps():
    rec = {"trace": {"gaps": [("sniper/trunk", 0.002), ("sniper/head", 0.001),
                              ("between host spans", 0.004),
                              ("sniper/trunk", 0.001),
                              ("sniper/decode", 0.003)]},
           "slice_units": 2}
    assert _reader(READERS[0])(rec) == pytest.approx((0.004 / 2) * 1e3)
    assert _reader(READERS[1])(rec) == pytest.approx((0.007 / 2) * 1e3)


def _load_run():
    spec = importlib.util.spec_from_file_location(
        "bench_run", harness.BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("workload,want", [
    ("r101_pyramid", {"trunk", "rpn", "head", "decode"}),
    ("r101_train", {"trunk", "rpn", "head", "loss", "backward",
                    "optimizer"}),
])
def test_a_traced_run_holds_the_programs_spans(workload, want, monkeypatch):
    """A whole traced run of the tiny cell: its profiled slice holds each
    of the program's spans, on the CPU with host seconds and no
    launches."""
    tables = []
    read_trace = harness.read_trace

    def reading(path, slice_name, group_of):
        out = read_trace(path, slice_name, group_of)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        t0 = float(next(e["ts"] for e in events
                        if e.get("name") == slice_name))
        tables.append(spans.table(events, t0, t0 + out["window_s"] * 1e6,
                                  group_of))
        return out

    monkeypatch.setattr(harness, "read_trace", reading)
    res, _ = _load_run().execute(tiny.cell(workload), 2**31 + 9, 0.5, True,
                                 torch.device("cpu"), t_start=time.time(),
                                 peak=989e12)
    (t,) = tables
    assert set(t["spans"]) == want
    assert all(r["host_s"] > 0 and r["launches"] == 0
               for r in t["spans"].values())
    assert t["launches"] == 0
    assert res["device"]["busy_s"] == 0.0
