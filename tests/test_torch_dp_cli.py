"""The data-parallel CLI plumbing of the port.

- network.BN_MODE: ``--set network.BN_MODE bogus`` is refused by the JAX
  registry and the port's alike (ValueError), and the valid values reach
  the BatchNorms as they are: "local" in one process is the plain batch
  statistics that the JAX registry resolves it to on one device;
- ``main_train.main`` with ``parallel.num_devices 2 --device cpu`` trains
  on 2 gloo ranks, each on its half of the roidb (shard_roidb) with its own
  loader: rank 0 alone logs and writes the epoch's checkpoint, which holds
  the unwrapped model's state_dict (no DDP ``module.`` prefix) and loads
  strictly into a one-process detector; the run's step count is the ranks'
  global minimum;
- over 3 epochs of unequal shards (3 chips on rank 0, 2 on rank 1), the
  loader process is cut to the global minimum of steps without losing its
  state: each rank's epochs draw what the thread loader draws, and each
  epoch draws anew;
- the same run started one process per rank (``parallel.num_processes``,
  ``parallel.process_id`` and ``parallel.coordinator_address``, here a
  ``file://`` store), as torchrun or one command per host would.

The training run uses the registry's full-width R50 at 64x64 chips: a
spawned rank cannot see a test's monkeypatched registry.
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sniper_tpu_torch import main_train
from sniper_tpu_torch.config import load_config
from sniper_tpu_torch.models.norm import TrainBatchNorm
from sniper_tpu_torch.models.registry import get_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YML = os.path.join(ROOT, "configs", "sniper_res101_e2e.yml")
TINY_UNITS = dict(units=(1, 1, 1, 1))


def test_bogus_bn_mode_is_refused_by_both_registries():
    from sniper_tpu.config import load_config as jax_load
    from sniper_tpu.models.registry import get_model as jax_model

    over = ["network.BN_MODE", "bogus"]
    with pytest.raises(ValueError, match="BN_MODE must be sync|local"):
        jax_model(jax_load(YML, over))
    with pytest.raises(ValueError, match="BN_MODE must be sync|local"):
        get_model(load_config(YML, over), **TINY_UNITS)


@pytest.mark.parametrize("mode", ["sync", "local"])
@pytest.mark.parametrize("n", [1, 2])
def test_bn_mode_resolves_as_jax(mode, n):
    """The port's registry passes a valid mode through to every trainable
    BatchNorm. The JAX registry resolves "local" on one device to "sync",
    and the port's "local" is that without a group of more than one rank:
    bit for bit the sync module in one process. Above one device JAX's
    "local" has one group per device, the port's one rank per card
    (test_torch_dp_norm)."""
    from sniper_tpu.config import load_config as jax_load
    from sniper_tpu.models.registry import _bn_mode as jax_bn_mode

    over = ["network.BN_MODE", mode, "parallel.num_devices", str(n)]
    want, groups = jax_bn_mode(jax_load(YML, over))
    assert want == ("local" if mode == "local" and n > 1 else "sync")
    assert groups == (n if want == "local" else 1)
    model = get_model(load_config(YML, over), **TINY_UNITS)
    bns = [m for m in model.modules() if isinstance(m, TrainBatchNorm)]
    assert bns and {m.mode for m in bns} == {mode}
    if want == "sync":
        bn = bns[0].train()
        ref = copy.deepcopy(bn)
        ref.mode = "sync"
        x = torch.from_numpy(
            np.random.RandomState(0).randn(2, bn.running_mean.numel(), 5, 4)
            .astype(np.float32))
        assert torch.equal(bn(x), ref(x))
        assert torch.equal(bn.running_var, ref.running_var)


def _coco(root, n_images=5):
    import cv2

    rng = np.random.RandomState(0)
    images, anns = [], []
    os.makedirs(os.path.join(root, "coco", "train_dp"))
    os.makedirs(os.path.join(root, "coco", "annotations"))
    for i in range(1, n_images + 1):
        w, h = 96, 64
        images.append({"id": i, "width": w, "height": h,
                       "file_name": f"im{i}.png"})
        for _ in range(2):
            x, y = rng.uniform(2, 50), rng.uniform(2, 30)
            bw, bh = rng.uniform(14, 30), rng.uniform(14, 30)
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": int(rng.randint(1, 5)),
                         "iscrowd": 0, "bbox": [x, y, bw, bh],
                         "area": bw * bh})
        cv2.imwrite(os.path.join(root, "coco", "train_dp", f"im{i}.png"),
                    rng.randint(0, 255, (h, w, 3)).astype(np.uint8))
    with open(os.path.join(root, "coco", "annotations",
                           "instances_train_dp.json"), "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c, "name": f"c{c}"}
                                  for c in range(1, 5)]}, f)


CFG = """---
output_path: "{tmp}/output"
symbol: resnet_mx_50_e2e
network:
  pretrained: ""
  PIXEL_MEANS: [103.9, 116.8, 123.7]
  FIXED_PARAMS: [conv0, bn0, stage1, bn_data]
  ANCHOR_RATIOS: [0.5, 1, 2]
  ANCHOR_SCALES: [2, 4, 7]
  NUM_ANCHORS: 9
dataset:
  NUM_CLASSES: 5
  dataset: coco
  dataset_path: "{tmp}/coco"
  image_set: train_dp
  root_path: "{tmp}"
TRAIN:
  bf16: false
  CPP_CHIPS: false
  USE_NEG_CHIPS: false
  SCALES: [[64, 96]]
  VALID_RANGES: [[-1, -1]]
  CHIP_SIZE: 64
  lr: 0.001
  lr_step: ''
  warmup: false
  end_epoch: 1
  FLIP: false
  BATCH_IMAGES: 1
  NUM_THREAD: 1
  RPN_BATCH_SIZE: 64
  RPN_PRE_NMS_TOP_N: 200
  RPN_POST_NMS_TOP_N: 16
"""


def _dp_yml(tmp):
    _coco(tmp)
    cfg_path = os.path.join(tmp, "dp.yml")
    with open(cfg_path, "w") as f:
        f.write(CFG.format(tmp=tmp))
    return cfg_path


def _check_run(tmp, cfg_path):
    out = os.path.join(tmp, "output", "dp", "train_dp")
    logs = [f for f in os.listdir(out) if f.endswith(".log")]
    assert len(logs) == 1  # rank 0's
    with open(os.path.join(out, logs[0])) as f:
        text = f.read()
    assert "rank 0 of 2: 3 roidb images, global batch 2" in text
    ckpt = torch.load(os.path.join(out, "checkpoints", "epoch_0001.pt"),
                      weights_only=True)
    assert not any(k.startswith("module.") for k in ckpt["model"])
    # one chip per image at this scale and one chip per step: rank 0 has 3
    # images, rank 1 has 2, and both ranks stop at the smaller count
    assert ckpt["step"] == 2
    model = get_model(load_config(cfg_path))
    model.load_state_dict(ckpt["model"])  # strict


def test_main_train_trains_on_two_ranks(tmp_path):
    cfg_path = _dp_yml(str(tmp_path))
    main_train.main(["--cfg", cfg_path, "--device", "cpu", "--set",
                     "parallel.num_devices", "2"])
    _check_run(str(tmp_path), cfg_path)


def test_main_train_one_process_per_rank(tmp_path):
    tmp = str(tmp_path)
    cfg_path = _dp_yml(tmp)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sniper_tpu_torch.main_train", "--cfg",
         cfg_path, "--device", "cpu", "--set", "parallel.num_processes", "2",
         "parallel.process_id", str(r), "parallel.coordinator_address",
         f"file://{tmp}/store"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}"
    _check_run(tmp, cfg_path)


def test_loader_process_epochs_follow_the_thread_loader(tmp_path):
    """Rank 0's 3 chips are cut to rank 1's 2 every epoch. A loader process
    whose cut epoch killed its child would replay its second roll from the
    third epoch on."""
    import torch_dp

    tmp = str(tmp_path)
    cfg_path = _dp_yml(tmp)
    with open(cfg_path) as f:
        text = f.read()
    with open(cfg_path, "w") as f:
        f.write(text.replace("end_epoch: 1", "end_epoch: 3"))
    torch_dp.launch(torch_dp.loader_epochs_rank, 2, tmp_path, cfg_path, tmp)
    for r in range(2):
        got = torch.load(os.path.join(tmp, f"epochs_rank{r}.pt"))
        assert [len(e) for e in got["thread"]] == [2, 2, 2], r
        assert got["process"] == got["thread"], r
        digests = [d for e in got["thread"] for d in e]
        assert len(set(digests)) == len(digests), r
