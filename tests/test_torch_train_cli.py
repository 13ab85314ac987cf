"""The port's training loop (main_train.run_training) on the CPU, end to end
at a tiny size: the chip loader over a synthetic roidb -> the tiny detector
(fp32) -> SGD steps -> a checkpoint per epoch -> resume. Its parity with
the JAX package is held piece by piece in the other test_torch_* files; this
test checks the wiring: finite losses, the step count, the telemetry, the
checkpoints and the device counts. The mask config trains the same way (its
polygons rasterized by the loader, mask_loss among the metrics), and
main_test's restore of its checkpoint gives masks.
"""

import math
import os

import numpy as np
import pytest
import torch

from sniper_tpu.config import default_config
from sniper_tpu_torch.data.loader import ChipLoader
from sniper_tpu_torch.main_train import (
    build_roidb,
    check_devices,
    num_devices,
    run_training,
)
from sniper_tpu_torch.train.checkpoint import latest_epoch
from torch_port import TINY, synth_image_loader, tiny_torch_detector


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class SynthDataset:
    """Stands in for a dataset reader: gt_roidb() of a few images, with
    ``masks`` each GT's polygon (a 12-gon inscribed in its box)."""

    name = "synth"
    num_classes = TINY["num_classes"]

    def __init__(self, masks=False):
        self.masks = masks

    def gt_roidb(self):
        rng = np.random.RandomState(1)
        out = []
        for i in range(3):
            w, h = 160, 120
            s = rng.uniform(10, 60, 4)
            x1 = rng.uniform(0, w - s - 1)
            y1 = rng.uniform(0, h - s - 1)
            cls = rng.randint(1, 5, 4)
            ov = np.zeros((4, 5), np.float32)
            ov[np.arange(4), cls] = 1.0
            out.append({
                "image": f"img{i}:{h}x{w}", "width": w, "height": h,
                "boxes": np.stack([x1, y1, x1 + s, y1 + s], 1)
                .astype(np.float32),
                "gt_classes": cls.astype(np.int32), "gt_overlaps": ov,
                "max_overlaps": np.ones(4, np.float32), "max_classes": cls,
                "flipped": False,
            })
            if self.masks:
                t = np.arange(12) * (np.pi / 6)
                out[-1]["gt_masks"] = [
                    [np.stack([x + r / 2 * (1 + np.cos(t)),
                               y + r / 2 * (1 + np.sin(t))], 1).reshape(-1)]
                    for x, y, r in zip(x1, y1, s)]
        return out

    def evaluate_detections(self, all_boxes, roidb):
        return {"detections": sum(len(d) for c in all_boxes[1:] for d in c)}

    def evaluate_segmentations(self, all_boxes_masks, roidb):
        masks = [m for c in all_boxes_masks[1:] for _, m in c if len(m)]
        assert all(m.ndim == 3 and m.shape[1:] == (28, 28)
                   and m.min() >= 0 and m.max() <= 1 for m in masks)
        return {"masks": sum(len(m) for m in masks)}


def make_cfg():
    cfg = default_config()
    cfg.dataset.NUM_CLASSES = TINY["num_classes"]
    cfg.network.ANCHOR_SCALES = TINY["anchor_scales"]
    cfg.network.ANCHOR_RATIOS = TINY["anchor_ratios"]
    cfg.network.NUM_ANCHORS = TINY["num_anchors"]
    cfg.network.FIXED_PARAMS = ["conv0", "bn0", "stage1", "bn_data"]
    cfg.TRAIN.CHIP_SIZE = 64
    cfg.TRAIN.SCALES = [(120, 160), (60, 80)]
    cfg.TRAIN.VALID_RANGES = [(-1, 40), (20, -1)]
    cfg.TRAIN.BATCH_IMAGES = 2
    cfg.TRAIN.MAX_GT_BOXES = 10
    cfg.TRAIN.USE_NEG_CHIPS = False
    cfg.TRAIN.NUM_THREAD = 1
    cfg.TRAIN.lr = 0.01
    cfg.TRAIN.warmup = True
    cfg.TRAIN.warmup_lr = 0.001
    cfg.TRAIN.warmup_step = 2
    cfg.TRAIN.begin_epoch = 0
    cfg.TRAIN.end_epoch = 2
    return cfg


def test_run_training_trains_checkpoints_and_resumes(tmp_path):
    cfg = make_cfg()
    roidb = build_roidb(cfg, lambda *_: None, datasets=[SynthDataset()])
    assert len(roidb) == 6  # flipped copies
    kw = dict(num_rois=16, train_pre_nms=100, train_post_nms=12)
    model = tiny_torch_detector(**kw)
    torch.manual_seed(0)
    seen = []
    res = run_training(cfg, model, ChipLoader(roidb, cfg, 2, seed=0,
                                              image_loader=synth_image_loader),
                       torch.device("cpu"), out_dir=str(tmp_path),
                       log=lambda *_: None,
                       step_hook=lambda s, m: seen.append(
                           {k: float(v) for k, v in m.items()}))
    assert res["step"] == len(seen) > 2
    for m in seen:
        assert all(math.isfinite(v) for v in m.values()), m
        assert {"loss", "rcnn_acc", "offset_max", "dcn_offset_max"} <= set(m)
    assert latest_epoch(str(tmp_path / "checkpoints")) == 2
    frozen = model.trunk.stage1_unit1.conv1.weight
    assert not frozen.requires_grad

    # resume at epoch 1: the step count continues from the checkpoint
    cfg.TRAIN.begin_epoch = 1
    model2 = tiny_torch_detector(**kw)
    res2 = run_training(cfg, model2, ChipLoader(
        roidb, cfg, 2, seed=0, image_loader=synth_image_loader),
        torch.device("cpu"), out_dir=str(tmp_path), log=lambda *_: None,
        max_steps=1)
    steps_epoch0 = torch.load(tmp_path / "checkpoints" / "epoch_0001.pt",
                              weights_only=True)["step"]
    assert res2["step"] == steps_epoch0 + 1


@pytest.mark.parametrize("count", [1, 2])
def test_all_devices_resolves_to_the_visible_cards(monkeypatch, count):
    """parallel.num_devices = -1 is every visible card on a CUDA device
    (the JAX CLI's reading) and one device on the CPU, and training takes
    them all; asking for more cards than are visible raises, where the
    CPU's ranks are processes and any count goes."""
    cfg = make_cfg()
    cfg.parallel.num_devices = -1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert num_devices(cfg, "cuda") == count
    assert num_devices(cfg, torch.device("cpu")) == 1
    check_devices(cfg, torch.device("cpu"))
    check_devices(cfg, torch.device("cuda", 0))
    cfg.parallel.num_devices = count + 1
    with pytest.raises(ValueError, match="CUDA devices are visible"):
        check_devices(cfg, torch.device("cuda", 0))
    check_devices(cfg, torch.device("cpu"))


def test_mask_training_checkpoints_and_restores_with_masks(tmp_path):
    """configs/sniper_res101_e2e_mask.yml at 64x64 chips with the tiny
    detector: run_training takes mask steps and writes the epoch's
    checkpoint under the output path; main_test's restore
    (restore_inference_state) reads it back, and run_detection returns
    masks for every detection."""
    from sniper_tpu_torch.config import load_config
    from sniper_tpu_torch.main_test import run_detection
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.train.checkpoint import restore_inference_state

    cfg = load_config(os.path.join(ROOT, "configs",
                                   "sniper_res101_e2e_mask.yml"))
    assert cfg.TRAIN.WITH_MASK
    tiny = make_cfg()
    for key in ("CHIP_SIZE", "SCALES", "VALID_RANGES", "BATCH_IMAGES",
                "MAX_GT_BOXES", "USE_NEG_CHIPS", "NUM_THREAD", "lr",
                "warmup_step"):
        setattr(cfg.TRAIN, key, getattr(tiny.TRAIN, key))
    cfg.TRAIN.CPP_CHIPS = False
    cfg.TRAIN.end_epoch = 1
    cfg.dataset.NUM_CLASSES = TINY["num_classes"]
    cfg.dataset.image_set = SynthDataset.name
    cfg.network = tiny.network
    cfg.output_path = str(tmp_path / "output")
    ds = SynthDataset(masks=True)
    roidb = build_roidb(cfg, lambda *_: None, datasets=[ds])
    assert all("gt_masks" in r for r in roidb)
    # seeded: the deformable units' conv2_weight is torch.empty until then
    model = init_detector(tiny_torch_detector(
        with_mask=True, num_rois=16, train_pre_nms=100, train_post_nms=12),
        seed=0)
    out_dir = os.path.join(cfg.output_path, "sniper_res101_e2e_mask",
                           SynthDataset.name)
    seen = []
    res = run_training(cfg, model, ChipLoader(roidb, cfg, 2, seed=0,
                                              image_loader=synth_image_loader),
                       torch.device("cpu"), out_dir=out_dir,
                       log=lambda *_: None, max_steps=2,
                       step_hook=lambda s, m: seen.append(
                           {k: float(v) for k, v in m.items()}))
    assert res["step"] == len(seen) == 2
    assert all(math.isfinite(m["mask_loss"]) and m["mask_loss"] > 0
               for m in seen)
    assert latest_epoch(os.path.join(out_dir, "checkpoints")) == 1

    cfg.TEST.TEST_EPOCH = 1
    cfg.TEST.SCALES = [(96, 128), (-1, 96)]
    cfg.TEST.BATCH_IMAGES = [2, 2]
    cfg.TEST.N_PROPOSAL_PER_SCALE = [12, 8]
    cfg.TEST.VALID_RANGES = [(-1, 90), (32, -1)]
    restored = tiny_torch_detector(with_mask=True)
    assert restore_inference_state(cfg, restored, "sniper_res101_e2e_mask",
                                   lambda *_: None) == "checkpoint"
    torch.testing.assert_close(restored.mask.mask_out.weight,
                               model.mask.mask_out.weight)
    test_roidb = [{k: r[k] for k in ("image", "width", "height", "flipped")}
                  for r in ds.gt_roidb()[:2]]
    stats = run_detection(cfg, restored, None, test_roidb, ds,
                          str(tmp_path), torch.device("cpu"),
                          image_loader=synth_image_loader)
    assert stats["bbox"]["detections"] > 0
    assert stats["segm"]["masks"] == stats["bbox"]["detections"]
