"""The mask cell (drivers/mask_pyramid.py) at a tiny size on the CPU: a
whole run prints a result line, and each of its new checks flips
``correct`` under the fault it is there for:

- a wrong class plane (each roi's neg and pos planes of the next class):
  ``mask_gap``;
- a skipped roi (the branch run on all but each image's last roi, that
  roi's mask left at zero): ``mask_short``;

and the mask head's precision control (reference/mask.py with
``mask_precision`` "bf16") fails ``mask_head_gap``, which a sound run
passes. The
FLOP count of the branch is the one the configuration's widths give."""

import json
import subprocess
import sys
import time

import pytest
import torch

import tiny
from benchmark.core import harness
from benchmark.core.masks import mask_reference_model
from benchmark.yardstick.mask_flops import mask_flops

SEED = 2**31 + 43


def mask_cell():
    c = tiny.cell("r101_mask_pyramid")
    t = c["traffic"]
    for k in ("chip", "batch", "n_batches", "max_gts", "max_box", "min_box",
              "traced_steps", "tiers"):
        t.pop(k, None)
    t.update(width=64, height=48, pool_images=8, round_images=4,
             warmup_rounds=1, traced_rounds=1)
    return c


def run(cell, trace=False):
    mod = harness.load_module(harness.BENCH / "run.py")
    res, _ = mod.execute(cell, SEED, 0.2, trace, torch.device("cpu"),
                         t_start=time.time(), peak=989e12)
    return res


@pytest.fixture
def detector():
    from sniper_tpu_torch.models import detector

    return detector


def wrong_plane(monkeypatch, detector):
    pick = detector.SNIPERDetector._class_planes

    def planes(self, logits, cid):
        return pick(self, logits, (cid + 1) % (self.num_classes - 1))

    monkeypatch.setattr(detector.SNIPERDetector, "_class_planes", planes)


def skipped_roi(monkeypatch, detector):
    prob = detector.SNIPERDetector._mask_prob

    def fewer(self, roi_feat_map, rois, cls_prob):
        got = prob(self, roi_feat_map, rois[:, :-1], cls_prob[:, :-1])
        return torch.cat([got, torch.zeros_like(got[:, :1])], dim=1)

    monkeypatch.setattr(detector.SNIPERDetector, "_mask_prob", fewer)


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_mask_run_prints_a_correct_result(trace):
    res = run(mask_cell(), trace)
    assert res["correct"], res["checks"]
    assert {"mask_gap", "mask_head_gap", "mask_short"} <= set(res["checks"])
    assert res["checks"]["mask_short"]["value"] == 0
    if trace:
        assert "mask_host_ms.infer" in res["metrics"]
    json.dumps(res)


@pytest.mark.parametrize("fault,number", [(wrong_plane, "mask_gap"),
                                          (skipped_roi, "mask_short")],
                         ids=lambda x: getattr(x, "__name__", x))
def test_fault_comes_out_not_correct(fault, number, monkeypatch, detector):
    fault(monkeypatch, detector)
    res = run(mask_cell())
    assert not res["correct"]
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]


def test_mask_bf16_control_fails_the_mask_head_check():
    from benchmark import calibrate_mask, run as bench

    cell = mask_cell()
    sound = run(cell)["checks"]["mask_head_gap"]
    ctx = bench.Context(cell, SEED, 0, False, torch.device("cpu"),
                        time.time(), 989e12)
    rows = []
    calibrate_mask.control_masks(ctx, "control_mask_bf16", rows.append)
    assert rows[0]["mask_head_gap"] > sound["limit"] >= sound["value"]


def test_mask_flops_are_the_widths():
    config = harness.load_cell("r101_mask_pyramid")["config"]
    per_roi = 2 * (50176 * 392 + 4 * 196 * 256 * 256 * 9
                   + 784 * 256 * 256 + 784 * 256 * 160)
    assert mask_flops(mask_reference_model(config), 4800) == 4800 * per_roi


def test_parent_without_the_counter_stops_at_once(monkeypatch, detector):
    monkeypatch.delattr(detector, "MASK_ROIS")
    mod = harness.load_module(harness.BENCH / "drivers" / "mask_pyramid.py")
    with pytest.raises(RuntimeError, match="no mask roi counter"):
        mod._counter()


def test_run_refuses_the_mask_cell_without_a_card():
    out = subprocess.run(
        [sys.executable, str(harness.BENCH / "run.py"), "--workload",
         "r101_mask_pyramid", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=tiny.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
