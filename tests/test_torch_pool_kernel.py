"""network.POOL_KERNEL in the port: the registry's resolution, and the
``pallas`` route of the R-CNN head's inference pool (the patch route: ROI
patch extraction, then torch ops) against the JAX package's ``pallas``
route, on the CPU in fp32.

- The registry: "auto", "fused" and "einsum" resolve to the fused route,
  "pallas" to the patch route, anything else raises ValueError.
- ``rcnn_head_fused(extract="pallas")`` against the JAX
  ``rcnn_head_fused(..., extract="pallas")`` (its Pallas extraction in
  interpret mode, frozen in tests/fixtures/torch_pool_kernel_golden.json by
  scripts/gen_torch_pool_kernel_golden.py) at P=7, margin 1 and 2 bins,
  with a nonzero offset FC, within tests/test_torch_roi_patch.py's atol 3e-5
  / rtol 2e-4; and against the port's own fused route.
- The tiny detector of tests/test_torch_detector.py under ``pallas``
  against the JAX ``SNIPERDetector(pool_kernel="pallas")`` on the same
  variables (the same fixture), within that file's tolerances (rois 1e-3
  px; rtol 1e-4 with an atol of 1e-4 of the scale); its rois equal the
  fused route's bit for bit, since the pool comes after them.
- A training step under ``pallas`` equals one under ``auto`` bit for bit
  and extracts no patch: training pools through the fused route.
- On the card (``cuda``): the tiny detector under ``pallas`` against
  ``fused``, with the ROI patch kernel's launch count.
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from sniper_tpu_torch.config.defaults import default_config
from sniper_tpu_torch.models.init import init_detector
from sniper_tpu_torch.models.registry import _pool_kernel, get_model
from sniper_tpu_torch.ops import deform as tdeform
from torch_port import close_to_scale, cuda_or_skip, tiny_torch_detector

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import gen_torch_pool_kernel_golden as pg  # noqa: E402


@pytest.fixture(scope="module")
def golden():
    with open(pg.FIXTURE) as f:
        return json.load(f)


def _cfg(pool):
    cfg = default_config()
    cfg.symbol = "resnet_mx_101_e2e"
    cfg.network.POOL_KERNEL = pool
    return cfg


@pytest.mark.parametrize("pool,route", [("auto", "fused"), ("fused", "fused"),
                                        ("einsum", "fused"),
                                        ("pallas", "pallas")])
def test_registry_resolves_pool_kernel(pool, route):
    cfg = _cfg(pool)
    assert _pool_kernel(cfg) == route
    model = get_model(cfg, units=(1, 1, 1, 1), dtype=torch.float32)
    assert model.pool_kernel == route


def test_unknown_pool_kernel_raises():
    with pytest.raises(ValueError, match="POOL_KERNEL"):
        _pool_kernel(_cfg("mosaic"))
    with pytest.raises(ValueError, match="pool_kernel"):
        tiny_torch_detector(pool_kernel="einsum")
    feat, rois, params = pg.head_inputs(1)
    with pytest.raises(ValueError, match="extract"):
        tdeform.rcnn_head_fused(torch.from_numpy(feat),
                                torch.from_numpy(rois),
                                _torch_params(params),
                                rois_per_image=pg.HEAD["rpi"],
                                extract="einsum")


def _torch_params(params):
    return tuple((torch.from_numpy(w), torch.from_numpy(b))
                 for w, b in params)


def _head(margin_bins, extract):
    feat, rois, params = pg.head_inputs(margin_bins)
    with torch.no_grad():
        return tdeform.rcnn_head_fused(
            torch.from_numpy(feat), torch.from_numpy(rois),
            _torch_params(params), rois_per_image=pg.HEAD["rpi"],
            pooled_size=pg.HEAD["P"], margin_bins=margin_bins,
            extract=extract, return_offset=True)


@pytest.mark.parametrize("margin_bins", pg.MARGINS)
def test_pallas_head_matches_jax(golden, monkeypatch, margin_bins):
    # chunks of 5 rois cross the images' boundary
    monkeypatch.setattr(tdeform, "PATCH_ROI_CHUNK", 5)
    want = golden[f"head_margin{margin_bins}"]
    cls, bbox, off = _head(margin_bins, "pallas")
    for got, key in ((cls, "cls_score"), (bbox, "bbox_pred"),
                     (off, "offset")):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want[key], np.float32),
                                   atol=3e-5, rtol=2e-4, err_msg=key)


@pytest.mark.parametrize("margin_bins", pg.MARGINS)
def test_pallas_head_matches_fused_route(margin_bins):
    """The two routes pool the same tents in another order; the off-map
    rois pool to zero rows on both."""
    got = _head(margin_bins, "pallas")
    want = _head(margin_bins, "fused")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=3e-5,
                                   rtol=2e-4)
    feat, rois, params = pg.head_inputs(margin_bins)
    (off_w, off_b), *_ = _torch_params(params)
    kw = dict(rois_per_image=pg.HEAD["rpi"], pooled_size=pg.HEAD["P"],
              margin_bins=margin_bins)
    with torch.no_grad():
        for pool in (tdeform.patch_offset_pool, tdeform.fused_offset_pool):
            pooled = pool(torch.from_numpy(feat), torch.from_numpy(rois),
                          off_w, off_b, **kw)
            assert float(pooled[:2].abs().max()) == 0.0, pool.__name__


def _forward(model, **kw):
    data, im_info = pg.forward_inputs()
    with torch.inference_mode():
        return model(torch.from_numpy(data), torch.from_numpy(im_info), **kw)


def test_pallas_detector_matches_jax(golden, monkeypatch):
    monkeypatch.setattr(tdeform, "PATCH_ROI_CHUNK", 5)
    want = golden["forward"]
    variables = pg.forward_variables()
    model = tiny_torch_detector(variables, pool_kernel="pallas")
    got = _forward(model)
    np.testing.assert_array_equal(got["roi_valid"].numpy(),
                                  np.asarray(want["roi_valid"]))
    np.testing.assert_allclose(got["rois"].numpy(),
                               np.asarray(want["rois"], np.float32),
                               atol=1e-3, rtol=1e-5)
    for k in ("roi_scores", "cls_prob", "bbox_pred"):
        close_to_scale(got[k], np.asarray(want[k], np.float32))
    fused = _forward(tiny_torch_detector(variables))
    assert torch.equal(got["rois"], fused["rois"])
    for k in ("cls_prob", "bbox_pred"):
        close_to_scale(got[k], fused[k])


class _CountExtract:
    """Counts the patch extractions (the ROI patch kernel's wrapper)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        self.inner = tdeform.extract_patches
        monkeypatch.setattr(tdeform, "extract_patches", self)

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.inner(*args, **kwargs)


def test_pallas_training_step_equals_auto(monkeypatch):
    from sniper_tpu_torch.train.optimizer import make_optimizer
    from sniper_tpu_torch.train.trainer import make_train_step

    import gen_torch_train_golden as gg

    count = _CountExtract(monkeypatch)
    batch = {k: torch.from_numpy(v) for k, v in gg.make_batch().items()}
    runs = {}
    for pool in ("auto", "pallas"):
        torch.manual_seed(0)
        model = init_detector(tiny_torch_detector(
            pool_kernel=_pool_kernel(_cfg(pool)), **gg.model_kwargs()),
            seed=5, offset_std=1e-3).train()
        opt, sched, _ = make_optimizer(gg.make_cfg(), 100, model)
        step = make_train_step(model, opt, sched, gg.B,
                               pixel_means=(0.0, 0.0, 0.0))
        runs[pool] = step(batch), model.state_dict()
    assert count.calls == 0
    (m_a, s_a), (m_p, s_p) = runs["auto"], runs["pallas"]
    assert m_a.keys() == m_p.keys() and s_a.keys() == s_p.keys()
    for k in m_a:
        assert torch.equal(m_a[k], m_p[k]), k
    for k in s_a:
        assert torch.equal(s_a[k], s_p[k]), k
    # the same model's inference under pallas does extract, in chunks
    model.eval()
    n = 40
    _forward(model, post_nms_top_n=n)
    assert count.calls == math.ceil(2 * n / tdeform.PATCH_ROI_CHUNK)


def test_pallas_route_is_forward_only():
    model = init_detector(tiny_torch_detector(pool_kernel="pallas"), seed=1)
    data, im_info = pg.forward_inputs()
    with pytest.raises(NotImplementedError, match="forward only"):
        model(torch.from_numpy(data), torch.from_numpy(im_info))


@pytest.mark.cuda
def test_pallas_detector_on_the_card():
    """The tiny detector's forward on the card under pallas against fused:
    the ROI patch kernel launches once per PATCH_ROI_CHUNK rois, the fused
    pool kernel not at all."""
    from sniper_tpu_torch.ops import cuda

    dev = cuda_or_skip()
    model = init_detector(tiny_torch_detector(pool_kernel="pallas"), seed=1,
                          offset_std=1e-3).to(dev)
    fused = init_detector(tiny_torch_detector(), seed=1,
                          offset_std=1e-3).to(dev)
    data, im_info = (torch.from_numpy(a).to(dev)
                     for a in pg.forward_inputs())
    n = 100
    with torch.inference_mode():
        want = fused(data, im_info, post_nms_top_n=n)
        for k in cuda.KERNELS:
            k.launches = 0
        got = model(data, im_info, post_nms_top_n=n)
    torch.cuda.synchronize()
    assert cuda.ROI_PATCH.launches == math.ceil(
        2 * n / tdeform.PATCH_ROI_CHUNK)
    assert cuda.FUSED_POOL.launches == 0
    assert cuda.NMS.launches == 1
    assert torch.equal(got["rois"], want["rois"])
    for k in ("cls_prob", "bbox_pred"):
        torch.testing.assert_close(got[k], want[k], atol=1e-4, rtol=1e-4)

