"""Mask and AutoFocus training together
(configs/sniper_res101_e2e_mask_autofocus.yml: TRAIN.WITH_MASK and
TRAIN.AUTO_FOCUS), on the CPU.

- Three steps of the tiny detector with both branches against
  tests/fixtures/torch_train_mask_autofocus_golden.json
  (``scripts/gen_torch_train_golden.py --mask --autofocus``, made op by
  op like the mask fixture), all six losses above 0 at the first step,
  under tests/test_torch_train_step.py's bounds for a whole step.
- The yml's ChipLoader (cut to 256x256 chips, polygons per GT, flipped
  images) against the JAX loader's, batch for batch, ``gt_masks`` and
  ``scale_label`` among the arrays, bit for bit; and the loader process
  (TRAIN.LOADER_PROCESS) carrying both, bit for bit the in-process
  loader's.
- ``run_training`` of the yml with the tiny detector: every step's six
  losses finite, the checkpoint written.
"""

import copy
import json
import math
import os

import numpy as np
import torch

import test_torch_shm_loader as shm
from sniper_tpu.config import load_config as jload_config
from sniper_tpu.data import roidb as jroidb
from sniper_tpu.data.loader import ChipLoader as JChipLoader
from sniper_tpu_torch.config import load_config
from sniper_tpu_torch.data import roidb as troidb
from sniper_tpu_torch.data.loader import ChipLoader
from sniper_tpu_torch.data.shm_loader import ProcessChipLoader
from test_torch_loader import add_polygons, make_gt_roidb
from test_torch_train_step import check_three_steps, gg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YML = os.path.join(ROOT, "configs", "sniper_res101_e2e_mask_autofocus.yml")
LOSSES = ("rpn_cls_loss", "rpn_bbox_loss", "rcnn_cls_loss",
          "rcnn_bbox_loss", "mask_loss", "focus_loss")


def test_three_mask_autofocus_train_steps_match_jax():
    with open(gg.fixture_path(mask=True, autofocus=True)) as f:
        first = json.load(f)["metrics"][0]
    assert all(first[k] > 0 for k in LOSSES), first
    check_three_steps(mask=True, autofocus=True)


def _cut(cfg):
    """The yml at 256x256 chips, 5 classes and 9 anchors, the thread pool,
    no negative chips, the Python chip set-cover."""
    cfg.TRAIN.SCALES = [(1400, 2000), (800, 1280), (-1, 256)]
    cfg.TRAIN.VALID_RANGES = [(-1, 80), (32, 150), (120, -1)]
    cfg.TRAIN.CHIP_SIZE = 256
    cfg.TRAIN.MAX_GT_BOXES = 12
    cfg.TRAIN.USE_NEG_CHIPS = False
    cfg.TRAIN.CPP_CHIPS = False
    cfg.TRAIN.NUM_THREAD = 2
    cfg.network.ANCHOR_SCALES = (2, 4, 7)
    cfg.network.NUM_ANCHORS = 9
    cfg.dataset.NUM_CLASSES = 5
    return cfg


def _roidb():
    rng = np.random.RandomState(9)
    return add_polygons(make_gt_roidb(rng, n_images=2), rng)


def test_chip_loader_matches_jax():
    gt = _roidb()
    loaders = []
    for load, mod, cls in ((jload_config, jroidb, JChipLoader),
                           (load_config, troidb, ChipLoader)):
        cfg = _cut(load(YML))
        assert cfg.TRAIN.WITH_MASK and cfg.TRAIN.AUTO_FOCUS
        r = mod.append_flipped_images(copy.deepcopy(gt))
        loaders.append(cls(r, cfg, 2, image_loader=shm.image_loader, seed=4))
    jl, tl = loaders
    assert tl.reset() == jl.reset() > 0
    filled = labelled = 0
    for k, (a, b) in enumerate(zip(tl, jl)):
        assert a.keys() == b.keys() >= {"gt_masks", "scale_label"}
        for key in a:
            np.testing.assert_array_equal(a[key], np.asarray(b[key]),
                                          err_msg=f"batch {k} {key}")
        filled += int(a["gt_masks"].any())
        labelled += int((a["scale_label"] != 0).sum())
    assert k + 1 == len(tl) and filled > 0 and labelled > 0


def test_process_loader_carries_masks_and_scale_label():
    cfg = _cut(load_config(YML))
    roidb = troidb.append_flipped_images(_roidb())
    ref = ChipLoader(copy.deepcopy(roidb), cfg, 2,
                     image_loader=shm.image_loader, seed=6)
    proc = ProcessChipLoader(roidb, cfg, 2, seed=6,
                             image_loader=shm.image_loader)
    try:
        assert proc.reset() == ref.reset()
        got = shm._batches(proc)
        shm._assert_same(got, shm._batches(ref), "masks and scale_label")
    finally:
        proc.close()
    assert all({"gt_masks", "scale_label"} <= set(b) for b in got)


def test_run_training_trains_the_combination(tmp_path):
    """run_training of the yml (cut as test_torch_train_cli cuts the mask
    yml) with the tiny detector carrying both branches."""
    from sniper_tpu_torch.main_train import build_roidb, run_training
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.train.checkpoint import latest_epoch
    from test_torch_train_cli import SynthDataset, make_cfg
    from torch_port import synth_image_loader, tiny_torch_detector

    cfg = load_config(YML)
    tiny = make_cfg()
    for key in ("CHIP_SIZE", "SCALES", "VALID_RANGES", "BATCH_IMAGES",
                "MAX_GT_BOXES", "USE_NEG_CHIPS", "NUM_THREAD", "lr",
                "warmup_step"):
        setattr(cfg.TRAIN, key, getattr(tiny.TRAIN, key))
    cfg.TRAIN.CPP_CHIPS = False
    cfg.TRAIN.AUTO_FOCUS_SMALL_THRESH = 24  # the 64x64 chips' GT sizes
    cfg.TRAIN.end_epoch = 1
    cfg.dataset.NUM_CLASSES = tiny.dataset.NUM_CLASSES
    cfg.network = tiny.network
    roidb = build_roidb(cfg, lambda *_: None,
                        datasets=[SynthDataset(masks=True)])
    model = init_detector(tiny_torch_detector(
        with_mask=True, autofocus=True, num_rois=16, train_pre_nms=100,
        train_post_nms=12), seed=0)
    seen = []
    res = run_training(
        cfg, model, ChipLoader(roidb, cfg, 2, seed=0,
                               image_loader=synth_image_loader),
        torch.device("cpu"), out_dir=str(tmp_path), log=lambda *_: None,
        max_steps=2,
        step_hook=lambda s, m: seen.append(
            {k: float(v) for k, v in m.items()}))
    assert res["step"] == len(seen) == 2
    for m in seen:
        assert all(math.isfinite(m[k]) for k in LOSSES), m
    assert seen[0]["mask_loss"] > 0 and seen[0]["focus_loss"] > 0
    assert latest_epoch(str(tmp_path / "checkpoints")) == 1
