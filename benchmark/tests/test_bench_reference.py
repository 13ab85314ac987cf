"""The frozen reference against the port's plain path on the CPU.

With the trunk in fp32 (TRAIN.bf16 off), the port on the CPU runs the
plain versions of its kernels, so the port and the reference compute the
same function in the same precision: a whole run of each tiny cell, one
forward of every scale or three training steps, reads gaps at fp32
rounding. The card's runs then hold the kernel path against this same
reference."""

import time

import pytest
import torch

import tiny
from benchmark.core import harness

FP32_LIMITS = {"score_gap": 1e-4, "box_gap": 1e-4, "roi_miss": 0.0,
               "nms_iou": 0.7, "label_gap": 0.0, "loss_gap": 1e-5,
               "delta_gap": 1e-3, "replay_roi_miss": 0.0,
               "replay_label_gap": 0.0, "replay_loss_gap": 1e-5,
               "replay_delta_gap": 1e-3, "eager_in_replay": 0}


def run_module():
    return harness.load_module(harness.BENCH / "run.py")


CASES = [(w, None) for w in tiny.WORKLOADS] + [("r101_train", "x101_e2e")]


@pytest.mark.parametrize("workload,config", CASES)
def test_port_plain_path_equals_the_reference_in_fp32(workload, config):
    cell = tiny.cell(workload, config)
    cell["config"]["yml"]["TRAIN"]["bf16"] = False
    cell["limits"] = {k: FP32_LIMITS[k] for k in cell["limits"]}
    res, checks = run_module().execute(
        cell, 2**31 + 17, 0.2, False, torch.device("cpu"),
        t_start=time.time(), peak=989e12)
    assert res["correct"], res["checks"]
    assert checks
