"""AutoFocus end to end on the CPU: the port's coarse-to-fine
``run_detection`` against the JAX CLI's, and the AutoFocus ymls through
the port's training and test entry points.

scripts/gen_torch_autofocus_golden.py froze tests/fixtures/
torch_autofocus_golden.json from the JAX chain: a tiny detector with the
FocusPixel head (its output layer scaled so the maps spread over (0, 1)),
three small scales of three synthetic images, each scale's FocusChips from
the one before. Here the same flax variables, converted, run through
sniper_tpu_torch.main_test.run_detection with the same images and
thresholds.

- The thresholds lie at the fixture's margin (half the widest gap between
  a scale's map values, 1e-3 or more) from every JAX map value; the port's
  maps are asserted to stay at least half that margin away, so no pixel
  crosses a threshold on a 1e-6 difference. The per-scale
  ``inference_crops`` must then be identical.
- The aggregated detections within test_torch_pipeline's tolerances
  (boxes 0.05 px, scores 1e-3, the same rows in the same order); with
  masks also each kept mask's mean and maximum within 1e-4 (fp32
  convolutions in another order).
- A run resumed from its dets_scale0.pkl (TEST.USE_CACHE) makes the same
  chips at the finer scales and the same detections.
- configs/sniper_res101_e2e_autofocus.yml trains through run_training with
  focus_loss, its checkpoint restores into main_test's run_detection, and
  main_test's CLI (``main``) runs coarse to fine with FocusChips over a
  synthetic COCO set; configs/sniper_res101_e2e_mask_autofocus.yml's
  masked inference runs through run_detection with FocusChips.
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from sniper_tpu_torch import main_test as tmain
from sniper_tpu_torch.config import default_config, load_config
from torch_port import TINY, synth_image_loader, tiny_torch_detector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import gen_torch_autofocus_golden as ga  # noqa: E402

with open(os.path.join(ROOT, "tests", "fixtures",
                       "torch_autofocus_golden.json")) as _f:
    GOLDEN = json.load(_f)
ADD_CHIPS = tmain.add_chips  # the function the tests wrap


def _keep(masks=False):
    """A dataset stand-in that hands back the aggregated detections (and
    masks)."""
    return ga._Keep(TINY["num_classes"], masks)


def _run(monkeypatch, tmp_path, mask, cfg=None, model=None):
    """The port's run_detection on the fixture's model and thresholds; each
    add_chips call checks the maps' distance from its threshold and records
    the crops. Returns (result, crops per scale, the least distance)."""
    want = GOLDEN["mask" if mask else "box"]
    if model is None:
        _, v = ga.variables(mask)
        model = tiny_torch_detector(v, autofocus=True, with_mask=mask)
    cfg = cfg or ga.configure(default_config(), want["thresholds"])
    crops = [[[[0.0, 0.0, ga.IM_W, ga.IM_H]]] * ga.N_IMAGES]
    closest = []
    real = ADD_CHIPS

    def add_chips(roidb, maps, s, cfg_):
        thr = cfg_.TEST.CHIP_HYPERPARAMS[s][1]
        closest.append(min(float(np.abs(m - thr).min()) for row in maps
                           for m in row if m is not None))
        out = real(roidb, maps, s, cfg_)
        crops.append([np.asarray(r["inference_crops"]).tolist()
                      for r in roidb])
        return out

    monkeypatch.setattr(tmain, "add_chips", add_chips)
    got = tmain.run_detection(cfg, model, None, ga.roidb(), _keep(mask),
                              str(tmp_path), torch.device("cpu"),
                              image_loader=ga.synth_loader)
    return got, crops, closest


def _check_dets(final, want):
    total = 0
    for c in range(TINY["num_classes"]):
        for i in range(ga.N_IMAGES):
            got = np.asarray(final[c][i], np.float32).reshape(-1, 5)
            exp = np.asarray(want["dets"][c][i], np.float32).reshape(-1, 5)
            assert got.shape == exp.shape, f"class {c} image {i}"
            np.testing.assert_allclose(got[:, :4], exp[:, :4], rtol=0,
                                       atol=0.05, err_msg=f"class {c} "
                                       f"image {i} boxes")
            np.testing.assert_allclose(got[:, 4], exp[:, 4], rtol=0,
                                       atol=1e-3, err_msg=f"class {c} "
                                       f"image {i} scores")
            total += len(exp)
    assert total > 0


@pytest.mark.parametrize("mask", [False, True], ids=["box", "mask"])
def test_run_detection_autofocus_matches_jax(monkeypatch, tmp_path, mask):
    want = GOLDEN["mask" if mask else "box"]
    got, crops, closest = _run(monkeypatch, tmp_path, mask)
    assert len(closest) == 2
    for s, (c, m) in enumerate(zip(closest, want["margins"])):
        assert m >= 1e-3 and c >= m / 2, (s, c, m)
    assert crops == want["crops"]
    # FocusChips: fewer or smaller chips than the full image at a scale,
    # more than one at another
    n = [sum(len(c) for c in s) for s in crops]
    assert n[0] == ga.N_IMAGES and max(n[1:]) > ga.N_IMAGES
    _check_dets(got["bbox"] if mask else got, want)
    if mask:
        for c in range(1, TINY["num_classes"]):
            for i in range(ga.N_IMAGES):
                dets, masks = got["segm"][c][i]
                assert len(masks) == len(dets)
                stats = np.asarray(want["mask_stats"][c][i]).reshape(-1, 2)
                flat = masks.reshape(len(masks), 28 * 28)
                np.testing.assert_allclose(
                    np.stack([flat.mean(1), flat.max(1)], 1).reshape(-1, 2),
                    stats, rtol=0, atol=1e-4, err_msg=f"class {c} image {i}")


def test_resumed_run_makes_the_same_chips(monkeypatch, tmp_path):
    """TEST.USE_CACHE: a second run finds dets_scale0.pkl, restores its
    maps and makes the first run's FocusChips and detections."""
    cfg = ga.configure(default_config(), GOLDEN["box"]["thresholds"])
    cfg.TEST.USE_CACHE = [True, False, False]
    _, v = ga.variables(False)
    model = tiny_torch_detector(v, autofocus=True)
    first, crops1, _ = _run(monkeypatch, tmp_path, False, cfg, model)
    assert os.path.exists(tmp_path / "dets_scale0.pkl")
    calls = []
    forward = model.forward
    monkeypatch.setattr(model, "forward",
                        lambda *a, **k: calls.append(a[0].shape)
                        or forward(*a, **k))
    second, crops2, _ = _run(monkeypatch, tmp_path, False, cfg, model)
    assert crops2 == crops1 == GOLDEN["box"]["crops"]
    # scale 0 (canvas 128x128) came from the cache: no forward ran there
    assert calls and all(tuple(s[1:3]) != (128, 128) for s in calls)
    for c in range(TINY["num_classes"]):
        for i in range(ga.N_IMAGES):
            np.testing.assert_array_equal(second[c][i], first[c][i])


def _tiny_yml(path):
    """The yml at tiny size: its TRAIN and TEST keys, with small chips and
    scales (coarse to fine, FocusChip thresholds at the fixture's), the
    tiny detector's anchors and classes."""
    cfg = load_config(os.path.join(ROOT, "configs", path))
    assert cfg.TRAIN.AUTO_FOCUS and cfg.TEST.AUTO_FOCUS
    ga.configure(cfg, GOLDEN["box"]["thresholds"])
    cfg.TEST.BATCH_IMAGES = [2, 2, 1]
    cfg.TRAIN.SCALES = [(192, 256), (-1, 128)]
    cfg.TRAIN.VALID_RANGES = [(-1, 60), (40, -1)]
    cfg.TRAIN.CHIP_SIZE = 64
    cfg.TRAIN.BATCH_IMAGES = 2
    cfg.TRAIN.USE_NEG_CHIPS = False
    cfg.TRAIN.CPP_CHIPS = False
    cfg.TRAIN.NUM_THREAD = 1
    cfg.TRAIN.FLIP = True
    cfg.TRAIN.end_epoch = 1
    cfg.TRAIN.warmup_step = 2
    cfg.network.ANCHOR_SCALES = TINY["anchor_scales"]
    cfg.network.NUM_ANCHORS = TINY["num_anchors"]
    cfg.dataset.NUM_CLASSES = TINY["num_classes"]
    return cfg


def _train_roidb(n=4):
    rng = np.random.RandomState(9)
    roidb = []
    for i in range(n):
        w, h = (320, 256) if i % 2 == 0 else (256, 320)
        side = np.concatenate([rng.uniform(12, 40, 3),
                               rng.uniform(60, 120, 2)])
        x1, y1 = rng.uniform(0, w - side - 1), rng.uniform(0, h - side - 1)
        cls = rng.randint(1, TINY["num_classes"], side.size)
        ov = np.zeros((side.size, TINY["num_classes"]), np.float32)
        ov[np.arange(side.size), cls] = 1.0
        roidb.append({"image": f"img{i}:{h}x{w}", "width": w, "height": h,
                      "boxes": np.stack([x1, y1, x1 + side, y1 + side], 1)
                      .astype(np.float32),
                      "gt_classes": cls.astype(np.int32), "gt_overlaps": ov,
                      "max_overlaps": np.ones(side.size, np.float32),
                      "max_classes": cls, "flipped": False})
    return roidb


def test_autofocus_yml_trains_and_detects(monkeypatch, tmp_path):
    """configs/sniper_res101_e2e_autofocus.yml at 64x64 chips with the tiny
    detector: run_training takes steps with focus_loss (finite, the head's
    gradients nonzero) and writes its checkpoint; main_test's restore
    reads it back, and run_detection runs coarse to fine with FocusChips."""
    from sniper_tpu_torch.data.loader import ChipLoader
    from sniper_tpu_torch.data.roidb import append_flipped_images
    from sniper_tpu_torch.main_train import run_training
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.train.checkpoint import restore_inference_state

    name = "sniper_res101_e2e_autofocus"
    cfg = _tiny_yml(f"{name}.yml")
    cfg.output_path = str(tmp_path / "output")
    cfg.dataset.image_set = "synth"
    roidb = append_flipped_images(_train_roidb())
    model = init_detector(tiny_torch_detector(
        autofocus=True, num_rois=16, train_pre_nms=100, train_post_nms=12),
        seed=0)
    head = model.autofocus.conv_new_2.weight
    grads = []
    head.register_hook(lambda g: grads.append(float(g.norm())))
    seen = []
    out_dir = os.path.join(cfg.output_path, name, "synth")
    res = run_training(cfg, model, ChipLoader(
        roidb, cfg, 2, seed=0, image_loader=synth_image_loader),
        torch.device("cpu"), out_dir=out_dir, log=lambda *_: None,
        max_steps=3, step_hook=lambda s, m: seen.append(
            {k: float(v) for k, v in m.items()}))
    assert res["step"] == len(seen) == 3
    assert all(math.isfinite(m["focus_loss"]) and m["focus_loss"] > 0
               for m in seen)
    assert len({m["focus_loss"] for m in seen}) > 1
    assert len(grads) == 3 and all(math.isfinite(g) and g > 0
                                   for g in grads)

    cfg.TEST.TEST_EPOCH = 1
    restored = tiny_torch_detector(autofocus=True)
    assert restore_inference_state(cfg, restored, name,
                                   lambda *_: None) == "checkpoint"
    torch.testing.assert_close(restored.autofocus.conv_new_out.weight,
                               model.autofocus.conv_new_out.weight)
    seen_crops = []
    real = ADD_CHIPS

    def add_chips(roidb, maps, s, cfg_):
        # the restored head's maps sit near 0.5: threshold at their median
        vals = np.concatenate([m.reshape(-1) for r in maps for m in r])
        cfg_.TEST.CHIP_HYPERPARAMS[s][1] = float(np.median(vals))
        out = real(roidb, maps, s, cfg_)
        seen_crops.append(sum(len(r["inference_crops"]) for r in roidb))
        return out

    monkeypatch.setattr(tmain, "add_chips", add_chips)
    final = tmain.run_detection(cfg, restored, None, ga.roidb()[:2],
                                _keep(), str(tmp_path), torch.device("cpu"),
                                image_loader=ga.synth_loader)
    assert len(seen_crops) == 2 and all(n > 0 for n in seen_crops)
    assert sum(len(final[c][i]) for c in range(1, TINY["num_classes"])
               for i in range(2)) > 0


def test_mask_autofocus_yml_detects_with_focus_chips(monkeypatch, tmp_path):
    """configs/sniper_res101_e2e_mask_autofocus.yml's inference: masks for
    every detection through FocusChips at the finer scales."""
    cfg = _tiny_yml("sniper_res101_e2e_mask_autofocus.yml")
    cfg.TEST.CHIP_HYPERPARAMS = [list(h) for h in
                                 ga.configure(default_config(), GOLDEN[
                                     "mask"]["thresholds"]).TEST
                                 .CHIP_HYPERPARAMS]
    assert cfg.TRAIN.WITH_MASK
    got, crops, _ = _run(monkeypatch, tmp_path, True, cfg)
    assert crops == GOLDEN["mask"]["crops"]
    n = 0
    for c in range(1, TINY["num_classes"]):
        for i in range(ga.N_IMAGES):
            dets, masks = got["segm"][c][i]
            assert masks.shape == (len(dets), 28, 28)
            assert ((masks >= 0) & (masks <= 1)).all()
            n += len(dets)
    assert n > 0


def _coco_val(root, n=ga.N_IMAGES):
    """A synthetic COCO val set of the fixture's images as PNGs, with two
    GT boxes each."""
    import cv2

    os.makedirs(os.path.join(root, "coco", "val_tiny"))
    os.makedirs(os.path.join(root, "coco", "annotations"))
    images, anns = [], []
    for i in range(1, n + 1):
        images.append({"id": i, "width": ga.IM_W, "height": ga.IM_H,
                       "file_name": f"im{i - 1}.png"})
        for k in range(2):
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": 1 + k, "iscrowd": 0,
                         "bbox": [20.0 + 60 * k, 30.0, 50.0, 40.0],
                         "area": 2000.0})
        cv2.imwrite(os.path.join(root, "coco", "val_tiny",
                                 f"im{i - 1}.png"),
                    ga.synth_loader(f"im{i - 1}"))
    with open(os.path.join(root, "coco", "annotations",
                           "instances_val_tiny.json"), "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c, "name": f"c{c}"}
                                  for c in range(1, TINY["num_classes"])]},
                  f)


def test_main_test_cli_runs_autofocus_yml(monkeypatch, tmp_path):
    """``python -m sniper_tpu_torch.main_test --cfg
    configs/sniper_res101_e2e_autofocus.yml --device cpu --weights ...``
    over a synthetic COCO set of the fixture's images, the registry's R101
    cut to the tiny detector and the fixture's weights in a state_dict
    file: the scales run coarse to fine through the fixture's FocusChips
    and the COCO evaluator scores the result."""
    from sniper_tpu_torch.models import registry

    _coco_val(str(tmp_path))
    _, v = ga.variables(False)
    weights = str(tmp_path / "weights.pt")
    torch.save(tiny_torch_detector(v, autofocus=True).state_dict(), weights)
    monkeypatch.setitem(registry._REGISTRY, "resnet_mx_101_e2e",
                        lambda cfg, **kw: tiny_torch_detector(
                            autofocus=True))
    crops = []
    real = ADD_CHIPS

    def add_chips(roidb, maps, s, cfg_):
        out = real(roidb, maps, s, cfg_)
        crops.append([np.asarray(r["inference_crops"]).tolist()
                      for r in roidb])
        return out

    monkeypatch.setattr(tmain, "add_chips", add_chips)
    thr = GOLDEN["box"]["thresholds"]
    tmain.main([
        "--cfg", os.path.join(ROOT, "configs",
                              "sniper_res101_e2e_autofocus.yml"),
        "--device", "cpu", "--weights", weights, "--set",
        "output_path", str(tmp_path / "out"),
        "dataset.root_path", str(tmp_path),
        "dataset.dataset_path", str(tmp_path / "coco"),
        "dataset.test_image_set", "val_tiny",
        "dataset.NUM_CLASSES", str(TINY["num_classes"]),
        "network.NUM_ANCHORS", str(TINY["num_anchors"]),
        "network.ANCHOR_SCALES", "[2, 4, 7]",
        "TEST.SCALES", "[[96, 128], [160, 256], [256, 384]]",
        "TEST.BATCH_IMAGES", "[2, 2, 2]",
        "TEST.CHIP_HYPERPARAMS",
        f"[[3, {thr[0]!r}, 3], [3, {thr[1]!r}, 4], [-1, -1, -1]]",
        "TEST.VALID_RANGES", "[[60, -1], [24, 120], [-1, 60]]",
        "TEST.DO_PRUNING", "[False, True, True]"])
    assert crops == GOLDEN["box"]["crops"][1:]
    assert os.path.exists(tmp_path / "out" / "sniper_res101_e2e_autofocus"
                          / "val_tiny" / "dets_scale2.pkl")
