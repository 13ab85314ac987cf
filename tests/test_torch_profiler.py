"""The port's profiling helpers (sniper_tpu_torch/utils/profiler.py) on the
CPU: ``StageTimer`` reports what the JAX package's reports for the same
stages under the same (patched) clock, and ``device_trace`` writes a
Chrome trace of the block's operators. On a card the trace also holds the
kernels (chip_smoke.py phase 9 checks that)."""

import glob
import itertools
import json
import time

import jax.numpy as jnp
import pytest
import torch

from sniper_tpu.utils import profiler as jprofiler
from sniper_tpu_torch.utils import profiler as tprofiler


def _run(mod, leaf, monkeypatch):
    """Stages a, b, a, c with durations 0.25, 1.5, 0.125 and 3 s of a fake
    clock, the second and third synchronizing ``leaf``."""
    ticks = itertools.accumulate([10.0, 0.25, 0.0, 1.5, 0.0, 0.125, 0.0,
                                  3.0])
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    timer = mod.StageTimer()
    for name, tree in (("a", None), ("b", {"x": [leaf]}), ("a", (leaf,)),
                       ("c", None)):
        with timer.stage(name, sync_tree=tree):
            pass
    return timer.report()


def test_stage_timer_report_matches_jax(monkeypatch):
    want = _run(jprofiler, jnp.ones(3), monkeypatch)
    got = _run(tprofiler, torch.ones(3), monkeypatch)
    assert got == want
    assert got.splitlines()[0] == "a: total 0.375s, mean 187.5ms over 2"


def test_sync_returns_the_tree():
    tree = {"a": [torch.ones(2)], "b": (torch.zeros(1), 3)}
    assert tprofiler.sync(tree) is tree


def test_device_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with tprofiler.device_trace(str(tmp_path / "trace")) as prof:
        (x @ x).relu().sum()
    files = glob.glob(str(tmp_path / "trace" / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"aten::mm", "aten::relu"} <= names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_device_trace_exports_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError, match="in the block"):
        with tprofiler.device_trace(str(tmp_path)):
            torch.ones(2).sum()
            raise RuntimeError("in the block")
    assert len(glob.glob(str(tmp_path / "trace_*.json"))) == 1
