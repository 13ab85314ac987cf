"""The yardstick's arithmetic: the frozen FLOP count, the kernels' bounds,
the statistics, and the reading of a profiled slice."""

import json

import numpy as np
import pytest
import torch

import tiny  # noqa: F401  (puts the checkout on sys.path)
from benchmark.core import harness, readers
from benchmark.core.program import program_model, reference_model
from benchmark.yardstick import flops, kernels


@pytest.mark.parametrize("workload", ["r101_pyramid", "x101_pyramid"])
@pytest.mark.parametrize("train", [False, True])
def test_frozen_count_equals_the_ports(workload, train):
    """At a tiny size, the frozen count over the reference detector is the
    port's utils/flops.py over the port's detector."""
    from sniper_tpu_torch.utils.flops import detector_flops

    config = tiny.cell(workload)["config"]
    fixed = config["yml"]["network"]["FIXED_PARAMS"]
    ref = reference_model(config)
    _, prog = program_model(config, 1, torch.device("cpu"))
    for canvas, rois in (((128, 128), 24), ((64, 96), 8)):
        assert flops.detector_flops(ref, 2, canvas, rois, train=train,
                                    fixed_params=fixed) == \
            detector_flops(prog, 2, canvas, rois, train=train,
                           fixed_params=fixed)


def test_frozen_count_closed_form():
    """R101's forward at a 512x512 chip against the sum written out."""
    config = harness.load_cell("r101_pyramid")["config"]
    ref = reference_model(config)
    B, rois = 1, 300
    f = 0
    f += 2 * 256 * 256 * 64 * 3 * 49                      # conv0 at stride 2
    H = 128                                               # after the max-pool
    cin = 64
    for i, (n, out) in enumerate(zip((3, 4, 23, 3), (256, 512, 1024, 2048))):
        mid = out // 4
        for j in range(n):
            stride = 2 if j == 0 and i in (1, 2) else 1
            Ho = H // stride
            f += 2 * H * H * mid * cin                    # conv1
            if i == 3:
                f += 2 * Ho * Ho * 72 * mid * 9          # offset conv
            f += 2 * Ho * Ho * mid * mid * 9              # conv2 / DCN
            f += 2 * Ho * Ho * out * mid                  # conv3
            if j == 0:
                f += 2 * Ho * Ho * out * cin              # shortcut
            H, cin = Ho, out
    f += 2 * H * H * 512 * 3072 * 9 + 2 * H * H * (42 + 84) * 512  # RPN
    f += 2 * H * H * 256 * 3072                           # conv_new_1
    f += 2 * rois * (12544 * 98 + 12544 * 1024 + 1024 * 1024
                     + 1024 * 81 + 1024 * 4)              # the head
    assert flops.detector_flops(ref, B, (512, 512), rois)[0] == f


def test_bounds_are_the_larger_of_bytes_and_operations():
    assert kernels.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert kernels.bound_s(0, 67e12) == pytest.approx(1.0)
    assert kernels.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)
    # X1 at R101's scale-0 C5 reads x and offsets, writes the col
    B, H, W, C = 4, 88, 120, 512
    nbytes = B * H * W * C * 2 + B * H * W * 72 * 4 + B * H * W * 9 * C * 2
    assert kernels.im2col(B, H, W, C) == pytest.approx(nbytes / 3.35e12)


def test_kernel_groups():
    g = kernels.group_of
    assert g("void (anonymous namespace)::pool_pass_kernel<7>(...)") == \
        "fused_pool"
    assert g("pool_pass_bwd_kernel") == "fused_pool_bwd"
    assert g("deform_im2col_bwd_kernel<bf16>") == "deform_im2col_bwd"
    assert g("deform_im2col_kernel<bf16>") == "deform_im2col"
    assert g("nms_scan_kernel") == "nms"
    assert g("elementwise_kernel") == kernels.OTHER


def test_statistics_take_all_samples():
    v = list(range(1, 101))
    assert harness.p95(v) == pytest.approx(np.percentile(v, 95))
    assert harness.p95([5.0] * 19 + [100.0]) > 5.0
    rec = {"spans": {"decode": [0.001, 0.003]}, "rounds": 10,
           "round_flops": 2e12, "window_s": 4.0, "peak_flops": 1e15}
    assert readers.span_ms(rec, "decode") == pytest.approx(2.0)
    # all the work over all the time of the window
    assert readers.mfu_pct(rec, "rounds", "round_flops") == \
        pytest.approx(10 * 2e12 / 4.0 / 1e15 * 100)
    assert readers.span_ms(rec, "dispatch") is None
    assert readers.roofline_pct(rec, "nms") is None


def _trace(tmp_path, events):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return str(p)


def test_read_trace_takes_the_union_inside_the_slice(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "slice", "ts": 100,
         "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "decode", "ts": 150,
         "dur": 40},
        {"ph": "X", "cat": "kernel", "name": "pool_pass_kernel", "ts": 90,
         "dur": 30},                       # clipped to [100, 120)
        {"ph": "X", "cat": "kernel", "name": "conv_fprop", "ts": 110,
         "dur": 30},                       # overlaps: union [100, 140)
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 180,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 250, "dur": 5},
    ]
    t = harness.read_trace(_trace(tmp_path, ev), "slice", kernels.group_of)
    assert t["window_s"] == pytest.approx(100e-6)
    assert t["busy_s"] == pytest.approx(50e-6)
    assert t["by_group"]["fused_pool"] == pytest.approx(30e-6)
    gaps = dict(t["gaps"])
    assert gaps["decode"] == pytest.approx(40e-6)     # [140, 180)
    assert gaps["between host spans"] == pytest.approx(10e-6)  # [190, 200)
    rec = {"trace": t, "bounds": {"fused_pool": 15e-6}, "slice_units": 2,
           "units": 10, "window_s": 400e-6}
    assert readers.roofline_pct(rec, "fused_pool") == pytest.approx(50.0)
    # 25 us busy a unit of the slice, 40 us a unit of the window
    assert readers.idle_pct(rec) == pytest.approx(37.5)
