"""Tiny cells for the harness's CPU tests: the benchmark's own
configurations at one unit per stage, with small canvases, chips and roi
counts, so that a whole run (set-up, window, reference) takes seconds on
the CPU. Widths are the configurations' own."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.core import harness  # noqa: E402

WORKLOADS = ("r101_pyramid", "r101_train", "x101_pyramid", "r101_serve")


def cell(workload: str, config: str | None = None) -> dict:
    """The tiny form of ``workload``, with another configuration's file
    where ``config`` names one."""
    c = copy.deepcopy(harness.load_cell(workload))
    if config is not None:
        c["config"] = harness.load_json(harness.BENCH / "configs"
                                        / f"{config}.json")
    cfg = c["config"]
    cfg["units"] = [1, 1, 1, 1]
    yml = cfg["yml"]
    te, tr = yml["TEST"], yml["TRAIN"]
    te.update(SCALES=[[96, 128], [48, 64], [32, 64]], BATCH_IMAGES=[2, 4, 4],
              RPN_PRE_NMS_TOP_N=200, N_PROPOSAL_PER_SCALE=[24, 16, 8])
    tr.update(BATCH_IMAGES=2, RPN_PRE_NMS_TOP_N=200, RPN_POST_NMS_TOP_N=32,
              RPN_BATCH_SIZE=32)
    t = c["traffic"]
    if t["driver"] == "pyramid":
        t.update(width=64, height=48, pool_images=8, round_images=4,
                 warmup_rounds=1, traced_rounds=1)
    else:
        t.update(chip=64, batch=2, n_batches=4, max_gts=8, max_box=40,
                 min_box=12, traced_steps=2, drained_steps=2,
                 tiers=[{"scale": 1.0, "valid_range": [0.0, 64.0]}])
    return c


def dump(obj) -> str:
    return json.dumps(obj, sort_keys=True)
