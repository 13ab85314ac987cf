"""The flagship training recipe through the port's CLIs on the CPU, at a
tiny size (scripts/train_neg_props_and_sniper.sh's three phases):

1. ``main_train`` with TRAIN.ONLY_PROPOSAL from an imported backbone
   (network.pretrained names a tiny MXNet ``.params`` file) and the loader
   process: RPN-only checkpoints for epochs 1 and 2;
2. ``main_test`` with TEST.EXTRACT_PROPOSALS over the training set, the
   model restored from phase 1's epoch-2 checkpoint: one proposal entry per
   image in ``<PROPOSAL_SAVE_PATH>/COCO_<train set>_rpn.pkl``;
3. ``main_train`` of the full detector from the same backbone, with
   negative chips mined from that file (more than 0) and the NUM_PROCESS 2
   re-roll pool: its checkpoint.

The dataset is a synthetic COCO set with PNG images; the registry's
``resnet_mx_50_e2e`` is replaced by units (1, 1, 1, 1) at full width, fp32.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from sniper_tpu_torch import main_test, main_train
from sniper_tpu_torch.config import load_config
from sniper_tpu_torch.models import registry
from sniper_tpu_torch.models.init import init_detector
from sniper_tpu_torch.train.pretrained import mapping_rows, save_mxnet_params

N_IMAGES = 4


def make_coco(root):
    """N_IMAGES PNGs of 256x192 with three GT boxes each, small ones in the
    top-left corner, so that most of the image is left to negative chips."""
    import cv2

    rng = np.random.RandomState(0)
    images, anns = [], []
    os.makedirs(os.path.join(root, "coco", "train_tiny"))
    os.makedirs(os.path.join(root, "coco", "annotations"))
    for i in range(1, N_IMAGES + 1):
        w, h = 256, 192
        images.append({"id": i, "width": w, "height": h,
                       "file_name": f"im{i}.png"})
        for _ in range(3):
            x, y = rng.uniform(4, 60), rng.uniform(4, 40)
            bw, bh = rng.uniform(14, 30), rng.uniform(14, 30)
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": int(rng.randint(1, 5)),
                         "iscrowd": 0, "bbox": [x, y, bw, bh],
                         "area": bw * bh})
        cv2.imwrite(os.path.join(root, "coco", "train_tiny", f"im{i}.png"),
                    rng.randint(0, 255, (h, w, 3)).astype(np.uint8))
    with open(os.path.join(root, "coco", "annotations",
                           "instances_train_tiny.json"), "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c, "name": f"c{c}"}
                                  for c in range(1, 5)]}, f)


CFG = """---
output_path: "{tmp}/output"
symbol: resnet_mx_50_e2e
proposal_path: "{tmp}/props"
network:
  pretrained: "{tmp}/backbone"
  PIXEL_MEANS: [103.9, 116.8, 123.7]
  RPN_FEAT_STRIDE: 16
  FIXED_PARAMS: [conv0, bn0, stage1, bn_data]
  ANCHOR_RATIOS: [0.5, 1, 2]
  ANCHOR_SCALES: [2, 4, 7]
  NUM_ANCHORS: 9
dataset:
  NUM_CLASSES: 5
  dataset: coco
  dataset_path: "{tmp}/coco"
  image_set: train_tiny
  root_path: "{tmp}"
  test_image_set: val_tiny
TRAIN:
  bf16: false
  CPP_CHIPS: false
  USE_NEG_CHIPS: true
  SCALES: [[384, 512], [-1, 128]]
  VALID_RANGES: [[-1, 60], [40, -1]]
  CHIP_SIZE: 128
  lr: 0.001
  lr_step: ''
  warmup: false
  end_epoch: 1
  FLIP: false
  BATCH_IMAGES: 2
  NUM_THREAD: 1
  RPN_BATCH_SIZE: 64
  RPN_PRE_NMS_TOP_N: 200
  RPN_POST_NMS_TOP_N: 16
TEST:
  SCALES: [[384, 512], [-1, 128]]
  BATCH_IMAGES: [2, 4]
  RPN_PRE_NMS_TOP_N: 600
  RPN_POST_NMS_TOP_N: 150
  NMS: -1
  TEST_EPOCH: 7
"""


@pytest.fixture
def recipe(tmp_path, monkeypatch):
    tmp = str(tmp_path)
    make_coco(tmp)
    cfg_path = os.path.join(tmp, "recipe.yml")
    with open(cfg_path, "w") as f:
        f.write(CFG.format(tmp=tmp))
    build = registry._resnet((1, 1, 1, 1))
    monkeypatch.setitem(registry._REGISTRY, "resnet_mx_50_e2e", build)
    # an ImageNet-style backbone file: the trunk's names only
    model = init_detector(build(load_config(cfg_path)), seed=3)
    state = model.state_dict()
    save_mxnet_params(os.path.join(tmp, "backbone-0000.params"), {
        mx: state[key].numpy() for key, mx in mapping_rows(model)
        if key.startswith("trunk.")})
    loaders = []

    def make_loader(*args, **kw):
        loaders.append(make_loader_orig(*args, **kw))
        return loaders[-1]

    make_loader_orig = main_train.make_loader
    monkeypatch.setattr(main_train, "make_loader", make_loader)
    return tmp, cfg_path, loaders, state


def test_three_phase_recipe(recipe):
    tmp, cfg_path, loaders, backbone = recipe
    cpu = ["--device", "cpu"]
    ckpt = os.path.join(tmp, "output", "recipe", "train_tiny", "checkpoints")
    # phase 1: RPN-only training, the batches from the loader process
    main_train.main(["--cfg", cfg_path, *cpu, "--set",
                     "TRAIN.ONLY_PROPOSAL", "True", "TRAIN.USE_NEG_CHIPS",
                     "False", "TRAIN.end_epoch", "2",
                     "TRAIN.LOADER_PROCESS", "True"])
    assert type(loaders[0]).__name__ == "ProcessChipLoader"
    assert not loaders[0].proc.is_alive()  # closed by main
    assert sorted(os.listdir(ckpt)) == ["epoch_0001.pt", "epoch_0002.pt"]
    rpn_state = torch.load(os.path.join(ckpt, "epoch_0002.pt"),
                           weights_only=True)["model"]
    assert {k.split(".")[0] for k in rpn_state} == {"trunk", "rpn"}
    # the frozen stem kept the backbone file's values
    assert torch.equal(rpn_state["trunk.conv0.weight"],
                       backbone["trunk.conv0.weight"])
    assert not torch.equal(rpn_state["trunk.stage2_unit1.conv1.weight"],
                           backbone["trunk.stage2_unit1.conv1.weight"])

    # phase 2: proposals over the training set from the epoch-2 checkpoint
    props = os.path.join(tmp, "props")
    main_test.main(["--cfg", cfg_path, *cpu, "--set",
                    "TEST.EXTRACT_PROPOSALS", "True", "TRAIN.ONLY_PROPOSAL",
                    "True", "TEST.TEST_EPOCH", "2", "dataset.test_image_set",
                    "train_tiny", "TEST.PROPOSAL_SAVE_PATH", props])
    assert os.listdir(props) == ["COCO_train_tiny_rpn.pkl"]
    with open(os.path.join(props, "COCO_train_tiny_rpn.pkl"), "rb") as f:
        boxes = pickle.load(f)["boxes"]
    assert len(boxes) == N_IMAGES
    assert all(b.shape[1] == 5 and len(b) > 150 for b in boxes)

    # phase 3: SNIPER training with negative chips from those proposals
    main_train.main(["--cfg", cfg_path, *cpu, "--set",
                     "TRAIN.NUM_PROCESS", "2"])
    loader = loaders[-1]
    assert loader._reroll_pool is None  # closed by main
    assert sum(len(r.get("neg_chips", [])) for r in loader.roidb) > 0
    full = torch.load(os.path.join(ckpt, "epoch_0001.pt"),
                      weights_only=True)["model"]
    assert "rcnn.fc_new_1.weight" in full and "conv_new_1.weight" in full
    assert torch.equal(full["trunk.conv0.weight"],
                       backbone["trunk.conv0.weight"])
