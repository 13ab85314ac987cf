"""TRAIN.VISUALIZE in the port against the JAX package, on the CPU.

- ``draw_detections`` and ``save_training_chip`` (uint8 and fp32 chips):
  the same pixels as sniper_tpu/utils/visualization.py's.
- The chip loader's renderings: one epoch of both loaders with
  TRAIN.VISUALIZE writes the same file names, and the images read back
  equal, pixel for pixel.
- ``PredictionDumper`` against the JAX dumper on converted weights and the
  same uint8 batch (its content extent smaller than im_info, so a dump
  normalized over im_info would differ): the same payload keys, step and
  batch_seq; the same rois in the same order within 1e-3 px, and the
  detections' boxes within 1e-3 px (the frameworks' fp32 RPN convolutions
  differ in the last bits, which moves the decoded rois by up to ~1e-4 px
  here, as in test_torch_detector); cls_prob, bbox_pred and the
  detections' scores within 1e-5.
- ``run_training`` with VISUALIZE on and off: the parameters and
  statistics after 3 steps identical, bit for bit (the dumps run the model
  in eval mode and touch neither its statistics nor the sampler's
  generator), with the renderings and dumps written.
"""

import copy
import glob
import os
import pickle
import types

import cv2
import numpy as np
import pytest
import torch

from sniper_tpu.config import default_config as jdefault_config
from sniper_tpu.data.loader import ChipLoader as JChipLoader
from sniper_tpu.train.vis_dump import PredictionDumper as JDumper
from sniper_tpu.utils import visualization as jvis
from sniper_tpu_torch.config import default_config
from sniper_tpu_torch.data.loader import ChipLoader
from sniper_tpu_torch.train.vis_dump import PredictionDumper
from sniper_tpu_torch.utils import visualization as tvis
from test_torch_detector import _perturb
from test_torch_loader import make_gt_roidb
from torch_port import synth_image_loader, tiny_jax_detector, \
    tiny_torch_detector

MEANS = (103.939, 116.779, 123.68)


def _dets(rng, n_cls=4, h=120, w=160):
    out = [np.zeros((0, 5), np.float32)]
    for j in range(1, n_cls):
        n = rng.randint(0, 5)
        x1, y1 = rng.uniform(-5, w - 20, n), rng.uniform(-5, h - 20, n)
        out.append(np.stack([x1, y1, x1 + rng.uniform(5, 60, n),
                             y1 + rng.uniform(5, 60, n), rng.rand(n)], 1)
                   .astype(np.float32))
    return out


@pytest.mark.parametrize("names", [False, True])
def test_draw_detections_matches_jax(rng, names):
    im = rng.randint(0, 255, (120, 160, 3)).astype(np.uint8)
    dets = _dets(rng)
    cls = ["bg", "a", "b", "c"] if names else None
    got = tvis.draw_detections(im, dets, cls, threshold=0.3)
    want = jvis.draw_detections(im, dets, cls, threshold=0.3)
    assert not np.array_equal(got, im)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_save_training_chip_matches_jax(rng, tmp_path, dtype):
    rgb = rng.randint(0, 255, (96, 96, 3)).astype(np.uint8)
    data = rgb if dtype == "uint8" else (
        rgb.astype(np.float32) - np.asarray(MEANS, np.float32)[::-1])
    gt = np.full((4, 5), -1.0, np.float32)
    gt[:2] = [[5, 8, 40, 50, 3], [30, 2, 90, 70, 1]]
    sample = {"data": data, "gt_boxes": gt}
    paths = [mod.save_training_chip(sample, MEANS,
                                    str(tmp_path / name / "chip.png"))
             for mod, name in ((tvis, "torch"), (jvis, "jax"))]
    got, want = (cv2.imread(p) for p in paths)
    assert got is not None and not np.array_equal(got[..., ::-1], rgb)
    np.testing.assert_array_equal(got, want)


def test_chip_loader_renderings_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    gt = make_gt_roidb(rng, n_images=2)
    files = []
    for make, cls, name in ((jdefault_config, JChipLoader, "jax"),
                            (default_config, ChipLoader, "torch")):
        cfg = make()
        cfg.TRAIN.SCALES = [(1400, 2000), (800, 1280), (-1, 256)]
        cfg.TRAIN.VALID_RANGES = [(-1, 80), (32, 150), (120, -1)]
        cfg.TRAIN.CHIP_SIZE = 256
        cfg.TRAIN.USE_NEG_CHIPS = False
        cfg.TRAIN.CPP_CHIPS = False
        cfg.TRAIN.NUM_THREAD = 2
        cfg.network.ANCHOR_SCALES = (2, 4, 7)
        cfg.network.NUM_ANCHORS = 9
        cfg.dataset.NUM_CLASSES = 5
        cfg.TRAIN.VISUALIZE = True
        cfg.TRAIN.visualization_freq = 3
        cfg.TRAIN.visualization_path = str(tmp_path / name)
        loader = cls(copy.deepcopy(gt), cfg, 2,
                     image_loader=synth_image_loader, seed=1)
        n = loader.reset()
        for _ in loader:
            pass
        files.append(sorted(os.path.basename(p) for p in glob.glob(
            os.path.join(cfg.TRAIN.visualization_path, "*.jpg"))))
    assert files[0] == files[1]
    assert len(files[1]) == (n - 1) // 3 + 1
    assert files[1][0] == "chip_e1_s0.jpg"
    for f in files[1]:
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / "torch" / f)),
            cv2.imread(str(tmp_path / "jax" / f)), err_msg=f)


def _dump_batch(rng, h=64, w=96):
    """Two uint8 chips of low contrast around PIXEL_MEANS (unit-scale input
    once normalized: the random RPN's scores stay apart), each with its
    content extent a few pixels smaller than its im_info."""
    means = np.asarray(MEANS)[::-1].round()
    data = np.clip(means + rng.randint(-2, 3, (2, h, w, 3)), 0, 255)
    return {"data": data.astype(np.uint8),
            "im_info": np.array([[h, w, 1.0], [h - 8, w - 4, 1.0]],
                                np.float32),
            "data_extent": np.array([[h - 3, w - 5], [h - 8, w - 4]],
                                    np.float32)}


def test_prediction_dumper_matches_jax(tmp_path):
    rng = np.random.RandomState(11)
    jmodel, variables = tiny_jax_detector(5)
    variables = _perturb(variables, rng)
    model = tiny_torch_detector(variables)
    model.train()  # as the training loop leaves it
    batch = _dump_batch(rng)
    payloads = []
    for name in ("jax", "torch"):
        cfg = (jdefault_config if name == "jax" else default_config)()
        cfg.network.PIXEL_MEANS = MEANS
        cfg.TRAIN.visualization_freq = 4
        cfg.TRAIN.visualization_path = str(tmp_path / name)
        if name == "jax":
            state = types.SimpleNamespace(
                params=variables["params"],
                batch_stats=variables["batch_stats"])
            dumper = JDumper(jmodel, cfg)
            assert dumper.maybe_dump(state, batch, 6) is None
            pkl = dumper.maybe_dump(state, batch, 8, batch_seq=5)
        else:
            dumper = PredictionDumper(model, cfg)
            assert dumper.maybe_dump(batch, 6) is None
            pkl = dumper.maybe_dump(batch, 8, batch_seq=5)
        assert os.path.exists(pkl.replace(".pkl", ".jpg"))
        with open(pkl, "rb") as f:
            payloads.append(pickle.load(f))
    assert model.training  # back in the mode it was in
    want, got = payloads
    assert got.keys() == want.keys()
    assert (got["step"], got["batch_seq"]) == (want["step"],
                                               want["batch_seq"]) == (8, 5)
    assert got["rois"].shape == want["rois"].shape and len(got["rois"]) > 0
    np.testing.assert_allclose(got["rois"], want["rois"], atol=1e-3,
                               rtol=1e-5)
    for key in ("cls_prob", "bbox_pred"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-5,
                                   err_msg=key)
    assert len(got["dets"]) == len(want["dets"]) == model.num_classes
    assert sum(len(d) for d in got["dets"]) > 0
    for j, (g, w) in enumerate(zip(got["dets"], want["dets"])):
        assert g.shape == w.shape, j
        np.testing.assert_allclose(g[:, :4], w[:, :4], atol=1e-3, rtol=1e-5,
                                   err_msg=f"class {j} boxes")
        np.testing.assert_allclose(g[:, 4], w[:, 4], atol=1e-5,
                                   err_msg=f"class {j} scores")


def test_visualize_trains_like_without(tmp_path):
    from sniper_tpu_torch.main_train import build_roidb, run_training
    from sniper_tpu_torch.models.init import init_detector
    from test_torch_train_cli import SynthDataset, make_cfg

    states, logs = [], []
    for vis in (False, True):
        cfg = make_cfg()
        cfg.TRAIN.VISUALIZE = vis
        cfg.TRAIN.visualization_freq = 2
        cfg.TRAIN.visualization_path = str(tmp_path / "vis")
        roidb = build_roidb(cfg, lambda *_: None, datasets=[SynthDataset()])
        model = init_detector(tiny_torch_detector(
            num_rois=16, train_pre_nms=100, train_post_nms=12), seed=0)
        log = []
        res = run_training(cfg, model, ChipLoader(
            roidb, cfg, 2, seed=0, image_loader=synth_image_loader),
            torch.device("cpu"), log=log.append, max_steps=3)
        assert res["step"] == 3
        states.append(model.state_dict())
        logs.append(log)
    off, on = states
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k
    vis = tmp_path / "vis"
    assert (vis / "chip_e1_s0.jpg").exists()
    assert sorted(os.listdir(vis / "preds")) == ["preds_step2.jpg",
                                                 "preds_step2.pkl"]
    with open(vis / "preds" / "preds_step2.pkl", "rb") as f:
        payload = pickle.load(f)
    # the loader's latest batch: the stepped one (seq 1) or one prefetched
    assert payload["step"] == 2 and payload["batch_seq"] >= 1
    assert any("dumped predictions" in m for m in logs[1])
    assert not any("dumped predictions" in m for m in logs[0])


def test_only_rank_0_renders_and_dumps(tmp_path, monkeypatch):
    """Under data parallelism the ranks would write the same file names:
    rank 0 alone renders chips (make_loader turns VISUALIZE off in the
    other ranks' loader config, which a loader process receives too) and
    dumps predictions."""
    from sniper_tpu_torch import main_train
    from sniper_tpu_torch.models.init import init_detector
    from test_torch_train_cli import SynthDataset, make_cfg

    cfg = make_cfg()
    cfg.TRAIN.VISUALIZE = True
    cfg.TRAIN.visualization_freq = 1
    cfg.TRAIN.visualization_path = str(tmp_path / "vis")
    roidb = main_train.build_roidb(cfg, lambda *_: None,
                                   datasets=[SynthDataset()])
    assert main_train.make_loader(roidb, cfg, 0).vis_path is not None
    monkeypatch.setattr(main_train.distributed, "rank", lambda: 1)
    loader = main_train.make_loader(roidb, cfg, 0,
                                    image_loader=synth_image_loader)
    assert loader.vis_path is None and cfg.TRAIN.VISUALIZE
    model = init_detector(tiny_torch_detector(
        num_rois=16, train_pre_nms=100, train_post_nms=12), seed=0)
    res = main_train.run_training(cfg, model, loader, torch.device("cpu"),
                                  max_steps=2)
    assert res["step"] == 2 and not (tmp_path / "vis").exists()
