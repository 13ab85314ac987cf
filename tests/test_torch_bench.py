"""The port's bench (sniper_tpu_torch/bench.py, bench_autofocus.py) on the
CPU at a tiny size, and its FLOP count (utils/flops.py).

- The inference settings of the flagship yml are bench.py's: canvases,
  batches, post-NMS counts and reps; the inputs and the training batch's
  pixels and GT boxes are the arrays bench.py draws from RandomState(0).
- The FLOP count equals a closed form written out here by layer for the
  pre-activation R101 detector, tiny (one unit per stage) and at full
  depth; on the CPU's plain route it equals torch's FlopCounterMode over
  the trunk and the RPN (forward, and for ResNet forward and backward:
  the counter books a grouped conv's backward as a dense one, so it
  cannot check ResNeXt's or MobileNetV2's), and it reads no forward.
- Every section runs through ``main`` at a tiny size with the plain
  kernels and gives bench.py's keys; a section that raises ends ``main``;
  the CLI without a CUDA device exits non-zero with no result.
- The AutoFocus sweep's pieces equal scripts/bench_autofocus.py's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from sniper_tpu_torch import bench, bench_autofocus
from sniper_tpu_torch.config import load_config
from sniper_tpu_torch.models.detector import SNIPERDetector
from sniper_tpu_torch.models.init import init_detector
from sniper_tpu_torch.train.optimizer import is_fixed
from sniper_tpu_torch.utils.flops import detector_flops, flops_by_part
from torch_port import TINY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import bench_autofocus as jax_bench_autofocus  # noqa: E402

FIXED = ["conv0", "bn0", "stage1", "bn_data"]
# the keys of bench.py's r101 line (bench.py:249-280,360-374,509-538,560-567)
JAX_KEYS = {
    "metric", "value", "unit", "vs_baseline", "train_step_ms",
    "train_img_per_s", "train_batch", "train_chip", "train_step_tflops",
    "train_mfu", "train_pipeline_ms", "train_pipeline_img_per_s",
    "train_pipeline_steps", "loader_only_ms", "upload_only_ms",
    "autofocus_img_per_s", "autofocus_pct_pixels",
    "autofocus_full_pyramid_img_per_s", "autofocus_speedup",
    "autofocus_sweep",
}


def flagship_cfg():
    return load_config(str(bench.FLAGSHIP))


def test_scale_specs_are_bench_py_s():
    """bench.py:105-119,176-193 on the flagship yml: a 640x480 image's
    canvas per scale, batches 4/8/8, post-NMS 300/200/100, reps 2/1/1."""
    specs = bench.scale_specs(flagship_cfg())
    assert [sp["canvas"] for sp in specs] == [(1408, 1920), (832, 1088),
                                              (384, 512)]
    assert [sp["hw"] for sp in specs] == [(1400, 1867), (800, 1067),
                                          (384, 512)]
    assert [sp["batch"] for sp in specs] == [4, 8, 8]
    assert [sp["post_nms"] for sp in specs] == [300, 200, 100]
    assert bench.round_reps([4, 8, 8]) == [2, 1, 1]
    assert bench.round_reps([8, 12, 24]) == [3, 2, 1]
    with pytest.raises(ValueError):
        bench.round_reps([4, 8, 8], [1, 1, 1])


def test_inference_inputs_are_bench_py_s():
    """bench.py:141-161: one RandomState(0), randn per scale drawn from the
    smallest canvas up, im_info rows (h, w, scale)."""
    specs = bench.scale_specs(flagship_cfg())
    got = bench.inference_inputs(specs)
    rng = np.random.RandomState(0)
    scales = [(1408, 1920, 4, 2.9166667, 1400, 1867),
              (832, 1088, 8, 1.6666666, 800, 1067),
              (384, 512, 8, 0.8, 384, 512)]
    for i in (2, 1, 0):
        ch, cw, b, s, h, w = scales[i]
        data = rng.randn(b, ch, cw, 3).astype(np.float32)
        np.testing.assert_array_equal(got[i][0], data)
        np.testing.assert_allclose(
            got[i][1], np.tile([[h, w, s]], (b, 1)).astype(np.float32),
            rtol=1e-7)


def test_train_batch_is_bench_py_s_in_the_port_s_form():
    """bench.py:309-323's pixels, im_info, valid ranges and GT boxes; the
    RPN targets in the chip loader's sparse form, labelled against those
    boxes by the loader's assigner."""
    cfg = bench.train_cfg(flagship_cfg())
    batch = bench.train_batch(cfg, 16, 512)
    rng = np.random.RandomState(0)
    gt = np.full((16, 100, 5), -1.0, np.float32)
    gt[:, 0] = [40, 40, 200, 200, 2]
    gt[:, 1] = [250, 250, 400, 420, 7]
    np.testing.assert_array_equal(
        batch["data"], rng.randn(16, 512, 512, 3).astype(np.float32))
    np.testing.assert_array_equal(batch["gt_boxes"], gt)
    np.testing.assert_array_equal(batch["im_info"],
                                  np.tile([[512, 512, 1.0]], (16, 1)))
    np.testing.assert_array_equal(batch["valid_ranges"],
                                  np.tile([[0.0, 512.0]], (16, 1)))
    n_anchors = 21 * 32 * 32
    assert batch["rpn_pids"].shape == (16, 256)
    assert batch["rpn_pids"].max() < n_anchors
    labels = batch["rpn_label_vals"]
    assert set(np.unique(labels)) <= {-1.0, 0.0, 1.0}
    assert ((labels == 1).sum(1) > 0).all() and ((labels == 0).sum(1) > 0).all()
    fg = batch["fg_pids"]
    assert fg.shape[0] == 16 and batch["fg_targets"].shape == fg.shape + (4,)
    # every fg pid is a sampled anchor labelled 1
    for i in range(16):
        fg_i = set(fg[i][fg[i] >= 0])
        assert fg_i == set(batch["rpn_pids"][i][labels[i] == 1])


# ---------------------------------------------------------------------------
# the FLOP count
# ---------------------------------------------------------------------------


def r101_closed_form(units, B, H, W, rois, num_anchors, num_classes,
                     train):
    """(forward, backward) FLOPs of the pre-activation R101 box detector,
    written out by layer: stem conv0 7x7/2 and max-pool 3x3/2; per stage
    (widths 256/512/1024/2048, bottleneck f/4, stride 2 in stages 2 and 3,
    C5 dilated at stride 1) the first unit's 1x1 in->mid, 3x3 mid->mid at
    the stride, 1x1 mid->f and the 1x1 shortcut at the stride, the other
    units' three convs, C5's offset convs (3x3 mid->72); the RPN's 3x3
    3072->512 and 1x1s to 2A and 4A; conv_new_1 3072->256; per roi the
    offset FC 12544->98, fc_new_1 12544->1024, fc_new_2, cls_score and
    bbox_pred. Training with the stem and stage 1 frozen: every product
    from stage 2 on, BatchNorm before it, has both gradients (2x), the
    stem and stage 1 none."""

    def out(n, k, s, p):
        return (n + 2 * p - (k - 1) - 1) // s + 1

    def conv(Ho, Wo, cin, cout, k):
        return 2 * B * Ho * Wo * cin * cout * k * k

    H1, W1 = out(H, 7, 2, 3), out(W, 7, 2, 3)
    stem = conv(H1, W1, 3, 64, 7)
    H, W = out(H1, 3, 2, 1), out(W1, 3, 2, 1)
    stages, cin = [], 64
    for i, (n, f) in enumerate(zip(units, (256, 512, 1024, 2048))):
        mid, stride = f // 4, 2 if i in (1, 2) else 1
        Ho, Wo = out(H, 3, stride, 1), out(W, 3, stride, 1)
        s = (conv(H, W, cin, mid, 1) + conv(Ho, Wo, mid, mid, 3)
             + conv(Ho, Wo, mid, f, 1) + conv(Ho, Wo, cin, f, 1))
        s += (n - 1) * (conv(Ho, Wo, f, mid, 1) + conv(Ho, Wo, mid, mid, 3)
                        + conv(Ho, Wo, mid, f, 1))
        if i == 3:
            s += n * conv(Ho, Wo, mid, 4 * 2 * 9, 3)
        stages.append(s)
        H, W, cin = Ho, Wo, f
    feat = 1024 + 2048
    A = num_anchors
    rpn = (conv(H, W, feat, 512, 3) + conv(H, W, 512, 2 * A, 1)
           + conv(H, W, 512, 4 * A, 1))
    new1 = conv(H, W, feat, 256, 1)
    pp = 7 * 7 * 256
    head = 2 * B * rois * (pp * 98 + pp * 1024 + 1024 * 1024
                           + 1024 * num_classes + 1024 * 4)
    fwd = stem + sum(stages) + rpn + new1 + head
    return fwd, (2 * (fwd - stem - stages[0]) if train else 0)


def tiny_r101(**kw):
    return SNIPERDetector(**dict(TINY, dtype=torch.float32, **kw))


@pytest.mark.parametrize("case", [
    # (units, B, canvas, rois, train)
    ((1, 1, 1, 1), 2, (64, 96), 16, False),
    ((1, 1, 1, 1), 3, (70, 50), 12, True),
    ((3, 4, 23, 3), 4, (1408, 1920), 300, False),
    ((3, 4, 23, 3), 8, (832, 1088), 200, False),
    ((3, 4, 23, 3), 8, (384, 512), 100, False),
    ((3, 4, 23, 3), 16, (512, 512), 300, True),
])
def test_flops_equal_the_closed_form(case):
    units, B, hw, rois, train = case
    if units == (1, 1, 1, 1):
        model, A, C = tiny_r101(), TINY["num_anchors"], TINY["num_classes"]
    else:
        cfg = flagship_cfg()
        with torch.device("meta"):
            from sniper_tpu_torch.models.registry import get_model

            model = get_model(cfg)
        A, C = 21, 81
    got = detector_flops(model, B, hw, rois, train=train, fixed_params=FIXED)
    assert got == r101_closed_form(units, B, *hw, rois, A, C, train)


def test_full_width_flops():
    """R101 at bench.py's shapes: 0.146 TFLOP per 512x512 chip forward,
    6.72 per training step of 16, per batch at each test scale, 2.00 per
    image over the three."""
    with torch.device("meta"):
        from sniper_tpu_torch.models.registry import get_model

        model = get_model(flagship_cfg())
    fwd, _ = detector_flops(model, 1, (512, 512), 300)
    assert fwd == 145539436544
    step = sum(detector_flops(model, 16, (512, 512), 300, train=True,
                              fixed_params=FIXED))
    assert step == 6723094642688
    per_batch = [detector_flops(model, sp["batch"], sp["canvas"],
                                sp["post_nms"])[0]
                 for sp in bench.scale_specs(flagship_cfg())]
    # chip_smoke.py's BENCH_FLOPS holds the bench's line to these
    assert per_batch == [5663558615040, 3817093398528, 842816651264]
    assert per_batch[0] // 4 + per_batch[1] // 8 + per_batch[2] // 8 \
        == 1998378409984


ZOO_FIXED = {"resnet": FIXED, "resnext": ["conv0", "bn0", "stage1"],
             "mobilenetv2": ["first_conv"]}


@pytest.mark.parametrize("trunk", ["resnet", "resnext", "mobilenetv2"])
def test_flops_equal_the_flop_counter_on_the_plain_route(trunk):
    """The trunk's and the RPN's forward counts equal FlopCounterMode's
    over a CPU forward (the C5 deformable conv's plain im2col is gathers,
    its product one matmul); ResNet's trunk forward + backward under the
    frozen stem and stage 1 too, with offsets that move."""
    kw = dict(trunk_type=trunk)
    if trunk == "mobilenetv2":
        kw.update(head_fc_dim=512, feat_stride=32)
    model = init_detector(tiny_r101(**kw), seed=0, offset_std=0.5).eval()
    x = torch.randn(2, 64, 96, 3, generator=torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model._shared(x)
    counts = {k: sum(v.values()) for k, v in fc.get_flop_counts().items()}
    mine = flops_by_part(model, 2, (64, 96), TINY["post_nms_top_n"])
    assert counts[type(model.trunk).__name__] == mine["trunk"][0]
    assert counts["RPNHead"] == mine["rpn"][0]
    if trunk != "resnet":
        return
    for name, p in model.named_parameters():
        p.requires_grad_(not is_fixed(name, FIXED))
    model.train()
    with FlopCounterMode(display=False) as fc:
        model.trunk.feature(x.permute(0, 3, 1, 2)).float().sum().backward()
    mine = flops_by_part(model, 2, (64, 96), 16, train=True,
                         fixed_params=FIXED)["trunk"]
    assert sum(fc.get_flop_counts()["Global"].values()) == sum(mine)


def test_flops_read_shapes_only(monkeypatch):
    """The count is the same on the CPU and on the meta device, where no
    kernel and no plain version can run, and runs no forward."""
    model = tiny_r101(autofocus=True)
    want = flops_by_part(model, 2, (64, 96), 16, train=True,
                         fixed_params=FIXED)

    def no_forward(*_, **__):
        raise AssertionError("the count ran the model")

    monkeypatch.setattr(SNIPERDetector, "forward", no_forward)
    assert flops_by_part(model.to("meta"), 2, (64, 96), 16, train=True,
                         fixed_params=FIXED) == want
    assert set(want) == {"trunk", "rpn", "conv_new_1", "rcnn", "autofocus"}


def test_resolve_peak():
    assert bench.resolve_peak("NVIDIA H100 80GB HBM3") == 989e12
    for name in ("TPU v5 lite", "Tesla V100-SXM2-16GB", "cpu"):
        with pytest.raises(ValueError):
            bench.resolve_peak(name)


# ---------------------------------------------------------------------------
# the sections, at a tiny size on the CPU
# ---------------------------------------------------------------------------


def tiny_build(section):
    """bench.flagship's (config, model) at a tiny size: TINY's detector in
    fp32, small test scales, 64x64 training chips, 2 per batch."""
    if section == "autofocus":
        cfg = bench_autofocus.make_cfg()
        cfg.TEST.SCALES = [(48, 64), (64, 96), (96, 128)]
        cfg.TEST.BATCH_IMAGES = [2, 2, 1]
    else:
        cfg = flagship_cfg()
        if section == "inference":
            cfg.TEST.SCALES = [(96, 128), (64, 96), (48, 64)]
            cfg.TEST.BATCH_IMAGES = [1, 2, 2]
            cfg.TEST.N_PROPOSAL_PER_SCALE = [16, 12, 8]
        else:
            cfg = (bench.train_cfg(cfg) if section == "train"
                   else bench.pipeline_cfg(cfg))
            cfg.TRAIN.BATCH_IMAGES = 2
            cfg.TRAIN.CHIP_SIZE = 64
            cfg.TRAIN.SCALES = [(120, 160), (60, 80)]
            cfg.TRAIN.VALID_RANGES = [(-1, 40), (20, -1)]
            cfg.TRAIN.NUM_THREAD = 1
    cfg.dataset.NUM_CLASSES = TINY["num_classes"]
    cfg.network.ANCHOR_SCALES = TINY["anchor_scales"]
    cfg.network.NUM_ANCHORS = TINY["num_anchors"]
    model = tiny_r101(num_rois=16, train_pre_nms=100, train_post_nms=12,
                      autofocus=section == "autofocus")
    return cfg, init_detector(model, seed=0)


def test_main_runs_every_section_on_the_cpu():
    result, detail = bench.main("r101", device=torch.device("cpu"),
                                peak=1e12, build=tiny_build,
                                pipeline_images=4, autofocus_images=2)
    assert JAX_KEYS <= set(result) and set(bench.R101_KEYS) == JAX_KEYS
    assert result["metric"] == "multiscale_inference_throughput_r101"
    assert result["vs_baseline"] == pytest.approx(result["value"] / 5.0)
    assert result["train_batch"] == 2 and result["train_chip"] == 64
    assert result["train_pipeline_steps"] > 0
    for key in ("value", "train_step_ms", "train_mfu", "train_pipeline_ms",
                "loader_only_ms", "upload_only_ms", "autofocus_img_per_s",
                "autofocus_full_pyramid_img_per_s"):
        assert result[key] > 0, key
    sweep = result["autofocus_sweep"]
    assert set(sweep) == {"full_pyramid", "autofocus_d0.05",
                          "autofocus_d0.2"}
    assert sweep["full_pyramid"]["pct_pixels"] == 100.0
    # the inference detail: bench.py's keys and each scale's FLOPs
    assert {"per_scale", "round_flops_T", "pipeline_mfu",
            "peak_bf16_flops", "round_ms"} <= set(detail)
    assert len(detail["round_ms"]) == 8 and detail["pipeline_mfu"] > 0
    cfg, _ = tiny_build("inference")
    for sp, got in zip(bench.scale_specs(cfg), detail["per_scale"]):
        assert {"canvas", "batch", "post_nms", "step_ms", "img_per_s",
                "tflops", "mfu"} <= set(got)
        assert got["flops"] == r101_closed_form(
            (1, 1, 1, 1), sp["batch"], *sp["canvas"], sp["post_nms"],
            TINY["num_anchors"], TINY["num_classes"], False)[0]
        assert got["mfu"] > 0
    assert result["train_step_tflops"] * 1e12 == pytest.approx(sum(
        r101_closed_form((1, 1, 1, 1), 2, 64, 64, 16, TINY["num_anchors"],
                         TINY["num_classes"], True)))
    json.dumps(result)


def _stub_inference(*_, **__):
    return 10.0, {"per_scale": []}


@pytest.mark.parametrize("section", ["bench_train_step",
                                     "bench_train_pipeline", "autofocus"])
def test_a_failing_section_ends_main(monkeypatch, section):
    """No section's error is caught (bench.py reported it as a *_error key
    and exited 0)."""

    def boom(*_, **__):
        raise RuntimeError(f"{section} failed")

    monkeypatch.setattr(bench, "bench_inference", _stub_inference)
    monkeypatch.setattr(bench, "bench_train_step",
                        lambda *a, **k: {"train_step_ms": 1.0})
    monkeypatch.setattr(bench, "bench_train_pipeline",
                        lambda *a, **k: {"train_pipeline_ms": 1.0})
    monkeypatch.setattr(bench_autofocus, "bench", lambda *a, **k: {
        "full_pyramid": {"img_per_s": 1.0, "pct_pixels": 100.0},
        "autofocus_d0.05": {"img_per_s": 2.0, "pct_pixels": 12.0}})
    target = bench_autofocus if section == "autofocus" else bench
    monkeypatch.setattr(target, "bench" if section == "autofocus" else section,
                        boom)
    cfg = bench.train_cfg(flagship_cfg())
    with pytest.raises(RuntimeError, match="failed"):
        bench.main("r101", device=torch.device("cpu"), peak=1e12,
                   build=lambda section: (cfg, None))


@pytest.mark.parametrize("trunk,batches", [("r101", [4, 8, 8]),
                                           ("x101", None), ("mnv2", None)])
def test_only_r101_without_custom_batches_runs_the_extra_sections(
        monkeypatch, trunk, batches):
    def no_section(*_, **__):
        raise AssertionError("an extra section ran")

    monkeypatch.setattr(bench, "bench_inference", _stub_inference)
    monkeypatch.setattr(bench, "bench_train_step", no_section)
    result, _ = bench.main(trunk, batches, device=torch.device("cpu"),
                           peak=1e12, build=lambda section: (None, None))
    assert result == {"metric": f"multiscale_inference_throughput_{trunk}",
                      "value": 10.0, "unit": "images/sec",
                      "vs_baseline": 2.0}


@pytest.mark.parametrize("module", ["sniper_tpu_torch.bench",
                                    "sniper_tpu_torch.bench_autofocus"])
def test_cli_without_a_card_exits_nonzero(module):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m", module], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert not res.stdout and "no CUDA device" in res.stderr


# ---------------------------------------------------------------------------
# the AutoFocus sweep against scripts/bench_autofocus.py
# ---------------------------------------------------------------------------


def test_autofocus_pieces_are_the_jax_bench_s():
    for name in ("im0", "im7", "im31"):
        np.testing.assert_array_equal(bench_autofocus.synth_loader(name),
                                      jax_bench_autofocus.synth_loader(name))
    assert bench_autofocus.make_roidb(32) == jax_bench_autofocus.make_roidb()
    rng = np.random.RandomState(3)
    maps = [[rng.rand(fh, fw).astype(np.float32), None]
            for fh, fw in ((30, 40), (7, 5), (1, 1))]
    for density in (0.05, 0.2, 0.5):
        got = bench_autofocus.planted_maps(maps, density)
        want = jax_bench_autofocus.planted_maps(maps, density)
        for g_row, w_row in zip(got, want):
            assert g_row[1] is None and w_row[1] is None
            np.testing.assert_array_equal(g_row[0], w_row[0])
    cfg = bench_autofocus.make_cfg()
    want = jax_bench_autofocus.make_cfg()
    for key in ("SCALES", "BATCH_IMAGES", "AUTO_FOCUS", "DO_PRUNING",
                "CHIP_HYPERPARAMS", "VALID_RANGES", "NMS", "NMS_SIGMA",
                "MAX_PER_IMAGE"):
        assert cfg.TEST[key] == want.TEST[key], key
    np.testing.assert_array_equal(cfg.network.PIXEL_MEANS,
                                  want.network.PIXEL_MEANS)
