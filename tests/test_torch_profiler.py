"""The port's profiling helpers (sniper_tpu_torch/utils/profiler.py) on the
CPU: ``StageTimer`` reports what the JAX package's reports for the same
stages under the same (patched) clock, and ``device_trace`` writes a
Chrome trace of the block's operators. On a card the trace also holds the
kernels (chip_smoke.py phase 9 checks that). The program's layer spans:
a profiled inference batch, decode and training step of the tiny detector
hold each of them, none inside another, and with no profiler recording
``span`` enters no ``record_function``."""

import glob
import itertools
import json
import os
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sniper_tpu.utils import profiler as jprofiler
from sniper_tpu_torch.utils import profiler as tprofiler
from torch_port import tiny_torch_detector

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import gen_torch_train_golden as gg  # noqa: E402


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


SPANS = ("trunk", "rpn", "head", "decode", "loss", "backward", "optimizer")


def _layers_once():
    """One inference batch through make_forward, its decode by the Tester,
    and one training step, of the tiny detector on the CPU."""
    from sniper_tpu_torch.config.defaults import default_config
    from sniper_tpu_torch.infer.tester import Tester
    from sniper_tpu_torch.main_test import make_forward
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.train.optimizer import make_optimizer
    from sniper_tpu_torch.train.trainer import make_train_step

    torch.manual_seed(0)
    model = init_detector(tiny_torch_detector(**gg.model_kwargs()), seed=5,
                          offset_std=1e-3).eval()
    means = (102.9801, 115.9465, 122.7717)
    data = torch.randint(0, 255, (2, 64, 64, 3), dtype=torch.uint8)
    info = np.array([[64.0, 64.0, 1.0], [56.0, 60.0, 1.0]], np.float32)
    out = make_forward(model, None, torch.device("cpu"), means)(data, info)
    cfg = default_config()
    cfg.TEST.NMS = -1  # soft-NMS, as the shipped configs
    Tester(None, cfg, model.num_classes).detect_outputs(out, info,
                                                        [1.0, 1.0])
    opt, sched, _ = make_optimizer(gg.make_cfg(), 100, model)
    step = make_train_step(model, opt, sched, gg.B,
                           pixel_means=(0.0, 0.0, 0.0))
    step({k: torch.from_numpy(v) for k, v in gg.make_batch().items()})


def test_spans_mark_each_layer_flat(tmp_path):
    with tprofiler.device_trace(str(tmp_path)):
        _layers_once()
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("sniper/"))
    assert {n for _, _, n in spans} == {f"sniper/{n}" for n in SPANS}
    # flat: each span ends before the next one starts
    for (_, end, name), (start, _, nxt) in zip(spans, spans[1:]):
        assert end <= start, (name, nxt)
    # the forward opens the RPN's twice (its convs, then the proposals);
    # the training step the head's twice around the sample
    names = [n for _, _, n in spans]
    assert names.count("sniper/rpn") == 4 and names.count("sniper/head") == 3
    assert names.count("sniper/optimizer") == 2


class _CountRecords:
    """Counts the record_function contexts made, then makes them."""

    def __init__(self, monkeypatch):
        self.calls = 0
        self.inner = torch.profiler.record_function
        monkeypatch.setattr(torch.profiler, "record_function", self)

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.inner(*args, **kwargs)


def test_span_off_enters_no_record_function(monkeypatch):
    count = _CountRecords(monkeypatch)
    _layers_once()
    assert count.calls == 0
    with tprofiler.span("trunk") as a, tprofiler.span("rpn") as b:
        assert a is None and b is None
    assert count.calls == 0
    with torch.profiler.profile():
        with tprofiler.span("trunk"):
            pass
    assert count.calls == 1
