"""The port's jax-free host plane (Tester, test-time batches, on-device
normalization) against the JAX package's, on the same inputs: the copies
must give identical results, with masks too (carried through the class
filter, the chip-border pruning, the NMS keep and the MAX_PER_IMAGE cap),
and with the per-chip NMS (``per_chip_nms``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sniper_tpu.config import default_config
from sniper_tpu.data import test_loader as jloader
from sniper_tpu.infer import tester as jtester
from sniper_tpu_torch.data import test_loader as tloader
from sniper_tpu_torch.infer import tester as ttester
from sniper_tpu_torch.main_test import _scale_post_nms
from conftest import random_boxes


def _loader(name):
    rng = np.random.RandomState(int(name[2:]))
    return rng.randint(0, 255, (90 + 7 * int(name[2:]), 130, 3), np.uint8)


def _roidb(n):
    return [{"image": f"im{i}", "width": 130, "height": 90 + 7 * i,
             "flipped": bool(i % 2)} for i in range(n)]


def test_device_normalize_matches_jax(rng):
    data = rng.randint(0, 255, (2, 16, 24, 3)).astype(np.uint8)
    info = np.array([[16, 24, 1.0], [11, 17, 1.0]], np.float32)
    means = [103.939, 116.779, 123.68]
    want = jtester.device_normalize(jnp.asarray(data), jnp.asarray(info),
                                    means)
    got = ttester.device_normalize(torch.from_numpy(data),
                                   torch.from_numpy(info), means)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scale", [0, 1])
def test_test_chip_iterator_matches_jax(scale):
    cfg = default_config()
    cfg.TEST.SCALES = [(-1, 192), (96, 160)]
    cfg.network.PIXEL_MEANS = [103.939, 116.779, 123.68]
    r1, r2 = _roidb(5), _roidb(5)
    jloader.init_inference_crops(r1)
    tloader.init_inference_crops(r2)
    a = list(jloader.TestChipIterator(r1, cfg, scale, 2,
                                      image_loader=_loader))
    b = list(tloader.TestChipIterator(r2, cfg, scale, 2,
                                      image_loader=_loader))
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_aggregate_matches_jax(rng):
    cfg = default_config()
    cfg.TEST.VALID_RANGES = [(-1, 90), (32, -1)]
    cfg.TEST.NMS = -1
    cfg.TEST.NMS_SIGMA = 0.55
    cfg.TEST.MAX_PER_IMAGE = 25
    ncls, nimg = 4, 3
    scale_dets = [[[[random_boxes(rng, int(rng.randint(0, 30)))]
                    for _ in range(nimg)] for _ in range(ncls)]
                  for _ in range(2)]
    want = jtester.Tester(None, cfg, ncls).aggregate(scale_dets, nimg)
    got = ttester.Tester(None, cfg, ncls).aggregate(scale_dets, nimg)
    for c in range(ncls):
        for i in range(nimg):
            np.testing.assert_array_equal(got[c][i], want[c][i])


def test_get_detections_matches_jax(rng):
    """The same forward outputs through both Testers' decode, class
    filter and chip-border pruning give the same per-chip detections."""
    cfg = default_config()
    cfg.TEST.NMS = -1
    n, ncls = 12, 4
    roidb = _roidb(2)
    tloader.init_inference_crops(roidb)
    rois = np.concatenate([np.zeros((2, n, 1), np.float32), np.stack(
        [random_boxes(rng, n, hw=(80, 120))[:, :4] for _ in range(2)])], -1)
    probs = rng.dirichlet(np.ones(ncls), (2, n)).astype(np.float32)
    out = {"rois": rois, "cls_prob": probs,
           "bbox_pred": (rng.randn(2, n, 4) * 0.1).astype(np.float32),
           "roi_valid": np.arange(n)[None].repeat(2, 0) < 10}
    batch = {"data": None, "im_info": np.array([[80, 120, 1.0]] * 2,
                                               np.float32),
             "im_scales": np.array([1.0, 1.3], np.float32),
             "im_ids": np.array([0, 1]), "chip_ids": np.array([0, 0]),
             "valid": np.array([True, True])}
    kw = dict(do_pruning=True)
    want, _ = jtester.Tester(lambda d, i: out, cfg, ncls).get_detections(
        [batch], roidb, **kw)
    got, maps, masks = ttester.Tester(
        lambda d, i: {k: torch.from_numpy(np.asarray(v)) for k, v in
                      out.items()}, cfg, ncls).get_detections([batch],
                                                              roidb, **kw)
    assert maps is None and masks is None
    for c in range(ncls):
        for i in range(2):
            np.testing.assert_array_equal(got[c][i][0], want[c][i][0])


def test_get_detections_with_masks_matches_jax(rng):
    cfg = default_config()
    cfg.TEST.NMS = -1
    n, ncls, S = 12, 4, 6
    roidb = _roidb(2)
    tloader.init_inference_crops(roidb)
    rois = np.concatenate([np.zeros((2, n, 1), np.float32), np.stack(
        [random_boxes(rng, n, hw=(80, 120))[:, :4] for _ in range(2)])], -1)
    out = {"rois": rois,
           "cls_prob": rng.dirichlet(np.ones(ncls), (2, n)).astype(np.float32),
           "bbox_pred": (rng.randn(2, n, 4) * 0.1).astype(np.float32),
           "roi_valid": np.arange(n)[None].repeat(2, 0) < 10,
           "mask_prob": rng.rand(2, n, S, S).astype(np.float32)}
    batch = {"data": None, "im_info": np.array([[80, 120, 1.0]] * 2,
                                               np.float32),
             "im_scales": np.array([1.0, 1.3], np.float32),
             "im_ids": np.array([0, 1]), "chip_ids": np.array([0, 0]),
             "valid": np.array([True, True])}
    kw = dict(do_pruning=True, with_masks=True)
    want_b, _, want_m = jtester.Tester(
        lambda d, i: out, cfg, ncls).get_detections([batch], roidb, **kw)
    got_b, maps, got_m = ttester.Tester(
        lambda d, i: {k: torch.from_numpy(np.asarray(v))
                      for k, v in out.items()}, cfg, ncls).get_detections(
        [batch], roidb, **kw)
    assert maps is None
    kept = 0
    for c in range(1, ncls):
        for i in range(2):
            np.testing.assert_array_equal(got_b[c][i][0], want_b[c][i][0])
            np.testing.assert_array_equal(got_m[c][i][0], want_m[c][i][0])
            assert len(got_m[c][i][0]) == len(got_b[c][i][0])
            kept += len(got_b[c][i][0])
    assert kept > 0


@pytest.mark.parametrize("nms,sigma", [(-1, 0.55), (0.3, -1)])
def test_aggregate_with_masks_matches_jax(rng, nms, sigma):
    cfg = default_config()
    cfg.TEST.VALID_RANGES = [(-1, 90), (32, -1)]
    cfg.TEST.NMS = nms
    cfg.TEST.NMS_SIGMA = sigma
    cfg.TEST.MAX_PER_IMAGE = 25
    ncls, nimg, S = 4, 3, 5
    scale_dets, scale_masks = [], []
    for _ in range(2):
        d = [[[random_boxes(rng, int(rng.randint(0, 30)))]
              for _ in range(nimg)] for _ in range(ncls)]
        scale_dets.append(d)
        scale_masks.append([[[rng.rand(len(x[0]), S, S).astype(np.float32)]
                             for x in dc] for dc in d])
    kw = dict(scale_cls_masks=scale_masks, mask_size=S)
    want_b, want_m = jtester.Tester(None, cfg, ncls).aggregate(
        scale_dets, nimg, **kw)
    got_b, got_m = ttester.Tester(None, cfg, ncls).aggregate(
        scale_dets, nimg, **kw)
    for c in range(1, ncls):
        for i in range(nimg):
            np.testing.assert_array_equal(got_b[c][i], want_b[c][i])
            for g, w in zip(got_m[c][i], want_m[c][i]):
                np.testing.assert_array_equal(g, w)
            assert len(got_m[c][i][1]) == len(got_b[c][i])


def test_scale_post_nms():
    cfg = default_config()
    cfg.TEST.N_PROPOSAL_PER_SCALE = [300, 200, 100]
    assert [_scale_post_nms(cfg, s, None) for s in range(3)] == [300, 200,
                                                                  100]
    with pytest.raises(ValueError):
        _scale_post_nms(cfg, 3, None)


@pytest.mark.parametrize("with_masks", [False, True])
@pytest.mark.parametrize("nms", [-1, 0.3])
def test_get_detections_per_chip_nms_matches_jax(rng, with_masks, nms):
    """per_chip_nms: each chip's per-class detections through the
    config's soft-NMS (TEST.NMS -1) or hard NMS, the masks of the kept rows
    with them, as the JAX Tester's."""
    cfg = default_config()
    cfg.TEST.NMS = nms
    cfg.TEST.NMS_SIGMA = 0.55 if nms < 0 else -1
    n, ncls, S = 30, 3, 5
    roidb = _roidb(2)
    tloader.init_inference_crops(roidb)
    # clustered boxes: many overlap within a class
    centres = rng.uniform(20, 100, (2, 4, 2))[:, rng.randint(0, 4, n)]
    half = rng.uniform(8, 20, (2, n, 2))
    rois = np.concatenate([np.zeros((2, n, 1)), centres - half,
                           centres + half], -1).astype(np.float32)
    out = {"rois": rois,
           "cls_prob": rng.dirichlet(np.ones(ncls), (2, n)).astype(np.float32),
           "bbox_pred": (rng.randn(2, n, 4) * 0.05).astype(np.float32),
           "roi_valid": np.arange(n)[None].repeat(2, 0) < n - 3}
    if with_masks:
        out["mask_prob"] = rng.rand(2, n, S, S).astype(np.float32)
    batch = {"data": None, "im_info": np.array([[90, 130, 1.0]] * 2,
                                               np.float32),
             "im_scales": np.array([1.0, 1.3], np.float32),
             "im_ids": np.array([0, 1]), "chip_ids": np.array([0, 0]),
             "valid": np.array([True, True])}
    kw = dict(with_masks=with_masks)
    want = jtester.Tester(lambda d, i: out, cfg, ncls).get_detections(
        [batch], roidb, per_chip_nms=True, **kw)
    tester = ttester.Tester(
        lambda d, i: {k: torch.from_numpy(np.asarray(v))
                      for k, v in out.items()}, cfg, ncls)
    got = tester.get_detections([batch], roidb, per_chip_nms=True, **kw)
    plain = tester.get_detections([batch], roidb, **kw)
    rows = plain_rows = 0
    for c in range(1, ncls):
        for i in range(2):
            np.testing.assert_array_equal(got[0][c][i][0], want[0][c][i][0])
            if with_masks:
                np.testing.assert_array_equal(got[2][c][i][0],
                                              want[2][c][i][0])
                assert len(got[2][c][i][0]) == len(got[0][c][i][0])
            rows += len(got[0][c][i][0])
            plain_rows += len(plain[0][c][i][0])
    # both NMS kinds drop rows here (soft-NMS those rescored under its
    # 1e-3 floor)
    assert 0 < rows < plain_rows
