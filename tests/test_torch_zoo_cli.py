"""The model zoo through the port's entry points on the CPU, at a tiny size:
configs/sniper_mobilenetv2_e2e.yml and configs/sniper_res101_e2e.yml with
``symbol resnext_mx_101``, each with its trunk in tests/torch_port.py's
tiny detector (ZOO), through main_train.run_training (two steps over
64x64 chips of a synthetic roidb, a checkpoint) and main_test's restore
and run_detection. The wiring: finite losses, the trunk's telemetry, the
yml's FIXED_PARAMS (MobileNetV2's ``first_conv`` bit for bit unmoved while
its BatchNorm's running statistics update, as in flax), the checkpoint
restored, detections. Parity with the JAX package is held in
tests/test_torch_zoo_detector.py.
"""

import math
import os

import pytest
import torch

from sniper_tpu_torch.config import load_config
from sniper_tpu_torch.data.loader import ChipLoader
from sniper_tpu_torch.main_test import run_detection
from sniper_tpu_torch.main_train import build_roidb, run_training
from sniper_tpu_torch.models.init import init_detector
from sniper_tpu_torch.train.checkpoint import latest_epoch, \
    restore_inference_state
from test_torch_train_cli import ROOT, SynthDataset, make_cfg
from torch_port import TINY, ZOO, synth_image_loader, tiny_torch_detector

# the yml and the CLI's --set overrides of each
YML = {"resnext": ("sniper_res101_e2e.yml", ["symbol", "resnext_mx_101"]),
       "mobilenetv2": ("sniper_mobilenetv2_e2e.yml", [])}


@pytest.mark.parametrize("kind", ["resnext", "mobilenetv2"])
def test_zoo_yml_trains_restores_and_detects(tmp_path, kind):
    name, sets = YML[kind]
    cfg = load_config(os.path.join(ROOT, "configs", name), sets)
    if sets:
        assert cfg.symbol == "resnext_mx_101"
    tiny = make_cfg()
    for key in ("CHIP_SIZE", "SCALES", "VALID_RANGES", "BATCH_IMAGES",
                "MAX_GT_BOXES", "USE_NEG_CHIPS", "NUM_THREAD", "lr",
                "warmup_step"):
        setattr(cfg.TRAIN, key, getattr(tiny.TRAIN, key))
    cfg.TRAIN.CPP_CHIPS = False
    cfg.TRAIN.end_epoch = 1
    cfg.dataset.NUM_CLASSES = TINY["num_classes"]
    cfg.dataset.image_set = SynthDataset.name
    for key in ("ANCHOR_SCALES", "ANCHOR_RATIOS", "NUM_ANCHORS"):
        setattr(cfg.network, key, getattr(tiny.network, key))
    cfg.network.pretrained = ""
    cfg.output_path = str(tmp_path / "output")
    fixed = list(cfg.network.FIXED_PARAMS)
    ds = SynthDataset()
    roidb = build_roidb(cfg, lambda *_: None, datasets=[ds])
    kw = dict(ZOO[kind], num_rois=16, train_pre_nms=100, train_post_nms=12)
    model = init_detector(tiny_torch_detector(**kw), seed=0)
    stem = (model.trunk.first_conv if kind == "mobilenetv2"
            else model.trunk.conv0)
    before = {k: v.clone() for k, v in stem.state_dict().items()}
    out_dir = os.path.join(cfg.output_path, name[:-4], SynthDataset.name)
    seen = []
    res = run_training(cfg, model, ChipLoader(roidb, cfg, 2, seed=0,
                                              image_loader=synth_image_loader),
                       torch.device("cpu"), out_dir=out_dir,
                       log=lambda *_: None, max_steps=2,
                       step_hook=lambda s, m: seen.append(
                           {k: float(v) for k, v in m.items()}))
    assert res["step"] == len(seen) == 2
    for m in seen:
        assert all(math.isfinite(v) for v in m.values()), m
        assert ("dcn_offset_max" in m) == (kind == "resnext")
    assert latest_epoch(os.path.join(out_dir, "checkpoints")) == 1
    assert fixed == (["first_conv"] if kind == "mobilenetv2"
                     else ["conv0", "bn0", "stage1", "bn_data"])
    after = stem.state_dict()
    for k, v in before.items():
        if "running" in k:  # MobileNetV2's first_conv BN keeps training
            assert torch.equal(after[k], v) == (kind == "resnext"), k
        else:
            assert torch.equal(after[k], v), k
    assert not any(p.requires_grad for p in stem.parameters())

    cfg.TEST.TEST_EPOCH = 1
    cfg.TEST.SCALES = [(96, 128), (-1, 96)]
    cfg.TEST.BATCH_IMAGES = [2, 2]
    cfg.TEST.N_PROPOSAL_PER_SCALE = [12, 8]
    cfg.TEST.VALID_RANGES = [(-1, 90), (32, -1)]
    restored = tiny_torch_detector(**ZOO[kind])
    assert restore_inference_state(cfg, restored, name[:-4],
                                   lambda *_: None) == "checkpoint"
    for k, v in model.state_dict().items():
        torch.testing.assert_close(restored.state_dict()[k], v)
    test_roidb = [{k: r[k] for k in ("image", "width", "height", "flipped")}
                  for r in ds.gt_roidb()[:2]]
    stats = run_detection(cfg, restored, None, test_roidb, ds,
                          str(tmp_path), torch.device("cpu"),
                          image_loader=synth_image_loader)
    assert stats["detections"] > 0
