"""Data-parallel inference of the port (main_test), on CPU replicas: the
counterparts of tests/test_multichip_infer.py:49-89.

- ``_test_num_devices``: an explicit opt-in, -1 (the default) is one
  device, as the JAX CLI reads it (both CLIs agree on every value);
- ``make_forward`` over two replicas equals one replica on the same batch
  (atol 1e-4, the JAX test's; the replicas run the same CPU arithmetic on
  half the batch), with the rois' batch-index column global, on fp32 input
  and on uint8 canvases normalized on the device;
- a batch that does not divide the replica count raises the JAX CLI's
  ValueError;
- ``inference_devices``: the cards 0..N-1, ValueError for more cards than
  visible, N replicas on the CPU;
- run_detection and run_proposal_extraction with parallel.num_devices 2
  serve over two replicas and give one replica's detections and proposals
  (boxes within 0.05 px, scores within 1e-3: tests/test_torch_pipeline.py's
  bounds).
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from sniper_tpu_torch import main_test
from sniper_tpu_torch.config import default_config
from sniper_tpu_torch.main_test import (
    _test_num_devices,
    inference_devices,
    make_forward,
    run_detection,
    run_proposal_extraction,
)
from sniper_tpu_torch.models.init import init_detector
from torch_port import tiny_torch_detector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 64
KEYS = ("rois", "roi_scores", "roi_valid", "cls_prob", "bbox_pred")


@pytest.fixture(scope="module")
def model():
    return init_detector(tiny_torch_detector(), seed=0, offset_std=1e-3)


@pytest.mark.parametrize("n", [-1, 0, 1, 2, 4])
def test_num_devices_requires_explicit_opt_in(n):
    from main_test import _test_num_devices as jax_rule
    from sniper_tpu.config import default_config as jax_config

    cfg, jcfg = default_config(), jax_config()
    assert _test_num_devices(cfg) == 1  # the default -1 is one device
    cfg.parallel.num_devices = jcfg.parallel.num_devices = n
    assert _test_num_devices(cfg) == jax_rule(jcfg) == max(n, 1)


@pytest.mark.parametrize("uint8", [False, True])
def test_two_replicas_match_one(model, uint8):
    rng = np.random.RandomState(3)
    if uint8:
        data = rng.randint(0, 255, (4, H, W, 3)).astype(np.uint8)
        means = (103.9, 116.8, 123.7)
    else:
        data = rng.randn(4, H, W, 3).astype(np.float32) * 50
        means = (0.0, 0.0, 0.0)
    im_info = np.array([[H, W, 1.0], [H - 8, W, 1.0], [H, W - 4, 1.0],
                        [H - 12, W - 8, 1.0]], np.float32)
    cpu = torch.device("cpu")
    one = make_forward(model, None, cpu, means)(data, im_info)
    two = make_forward(model, None, [cpu, cpu], means)(data, im_info)
    assert set(one) == set(two) == set(KEYS)
    for k in KEYS:
        assert one[k].shape == two[k].shape, k
        np.testing.assert_allclose(two[k].numpy(), one[k].numpy(),
                                   atol=1e-4, err_msg=k)
    # the batch-index column counts the images of the whole batch
    idx = two["rois"][..., 0]
    assert torch.equal(idx, torch.arange(4.0)[:, None].expand_as(idx))


def test_indivisible_batch_raises(model):
    rng = np.random.RandomState(1)
    data = rng.randn(3, H, W, 3).astype(np.float32)
    im_info = np.tile([[H, W, 1.0]], (3, 1)).astype(np.float32)
    fwd = make_forward(model, None, ["cpu", "cpu"], (0.0, 0.0, 0.0))
    with pytest.raises(ValueError, match="not divisible by 2 devices"):
        fwd(data, im_info)


@pytest.mark.parametrize("n,visible", [(2, 2), (2, 4), (4, 2)])
def test_inference_devices(monkeypatch, n, visible):
    cfg = default_config()
    cfg.parallel.num_devices = n
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    assert inference_devices(cfg, "cpu") == [torch.device("cpu")] * n
    if n > visible:
        with pytest.raises(ValueError, match="CUDA devices are visible"):
            inference_devices(cfg, "cuda")
    else:
        assert inference_devices(cfg, "cuda") == [
            torch.device("cuda", i) for i in range(n)]
    cfg.parallel.num_devices = -1
    assert inference_devices(cfg, "cuda:0") == [torch.device("cuda", 0)]


class _Keep:
    def __init__(self, num_classes):
        self.num_classes = num_classes
        self.name = "keep"

    def evaluate_detections(self, all_boxes, roidb):
        return all_boxes


def _pipeline_cfg(tmp_path, n):
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import gen_golden_detections as gd

    cfg = default_config()
    for k in ("SCALES", "VALID_RANGES", "NMS", "NMS_SIGMA", "MAX_PER_IMAGE",
              "DO_PRUNING", "AUTO_FOCUS"):
        setattr(cfg.TEST, k, getattr(gd.make_cfg().TEST, k))
    cfg.TEST.BATCH_IMAGES = [2, 2]
    cfg.TEST.PROPOSAL_SAVE_PATH = str(tmp_path / f"props{n}")
    cfg.network.PIXEL_MEANS = [103.939, 116.779, 123.68]
    cfg.parallel.num_devices = n
    roidb = [{"image": f"im{i}", "width": gd.IM_W, "height": gd.IM_H,
              "flipped": False} for i in range(4)]
    return cfg, roidb, gd.synth_loader


def _spy_replicas(monkeypatch):
    counts = []
    real = main_test.replicate

    def spy(model, devices):
        counts.append(len(devices))
        return real(model, devices)

    monkeypatch.setattr(main_test, "replicate", spy)
    return counts


def test_run_detection_serves_over_two_replicas(model, tmp_path,
                                                monkeypatch):
    counts = _spy_replicas(monkeypatch)
    finals = {}
    for n in (1, 2):
        cfg, roidb, loader = _pipeline_cfg(tmp_path, n)
        out = tmp_path / f"out{n}"
        out.mkdir()
        finals[n] = run_detection(cfg, model, None, roidb,
                                  _Keep(model.num_classes), str(out), "cpu",
                                  image_loader=loader)
    assert counts == [1, 2]
    total = 0
    for c in range(1, model.num_classes):
        for i in range(4):
            a = np.asarray(finals[1][c][i], np.float32).reshape(-1, 5)
            b = np.asarray(finals[2][c][i], np.float32).reshape(-1, 5)
            assert a.shape == b.shape, (c, i)
            np.testing.assert_allclose(b[:, :4], a[:, :4], atol=0.05)
            np.testing.assert_allclose(b[:, 4], a[:, 4], atol=1e-3)
            total += len(a)
    assert total > 0
    # an indivisible TEST.BATCH_IMAGES stops the run
    cfg, roidb, loader = _pipeline_cfg(tmp_path, 2)
    cfg.TEST.BATCH_IMAGES = [3, 2]
    out = tmp_path / "out3"
    out.mkdir()
    with pytest.raises(ValueError, match="not divisible"):
        run_detection(cfg, model, None, roidb, _Keep(model.num_classes),
                      str(out), "cpu", image_loader=loader)


def test_proposal_extraction_serves_over_two_replicas(tmp_path, monkeypatch):
    counts = _spy_replicas(monkeypatch)
    rpn = init_detector(tiny_torch_detector(rpn_only=True), seed=2)
    boxes = {}
    for n in (1, 2):
        cfg, roidb, loader = _pipeline_cfg(tmp_path, n)
        path = run_proposal_extraction(cfg, rpn, None, roidb,
                                       _Keep(rpn.num_classes), "cpu",
                                       image_loader=loader)
        with open(path, "rb") as f:
            boxes[n] = pickle.load(f)["boxes"]
    assert counts == [1, 2]
    assert len(boxes[2]) == 4
    for a, b in zip(boxes[1], boxes[2]):
        assert a.shape == b.shape and len(a) > 0
        np.testing.assert_allclose(b[:, :4], a[:, :4], atol=0.05)
        np.testing.assert_allclose(b[:, 4], a[:, 4], atol=1e-3)
