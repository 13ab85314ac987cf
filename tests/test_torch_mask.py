"""The port's mask branch against the JAX package, on the CPU in fp32.

- MaskHead through convert against the flax MaskHead, on random kernels
  that are not symmetric (flax's ConvTranspose takes the kernel flipped
  against torch's, so a symmetric kernel would pass either way): fp32
  convolutions sum in another order, atol 1e-4 of the logits' scale.
- A tiny with_mask detector: rois, cls_prob, bbox_pred and mask_prob
  against the JAX forward at one canvas, with test_torch_detector's
  tolerances (rtol 1e-4, atol 1e-4 of the scale; boxes within 1e-3 px).
- The port's copies of the config loader and the COCO evaluator against
  the JAX package's and the reference protocol's golden numbers: identical.
- run_detection with the mask config over a tiny synthetic COCO dataset,
  through evaluate_segmentations.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sniper_tpu.config import load_config as jload_config
from sniper_tpu.models.heads import MaskHead as JMaskHead
from sniper_tpu_torch.config import load_config
from sniper_tpu_torch.convert import convert
from sniper_tpu_torch.models.heads import MaskHead
from torch_port import close_to_scale, synth_image_loader, \
    tiny_jax_detector, tiny_torch_detector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _randomize(params, rng):
    """He-scale random kernels (not symmetric) and small random biases."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            out[k] = (rng.randn(*v.shape) * np.sqrt(2.0 / fan_in)).astype(
                np.float32)
        else:
            out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    return out


def test_mask_head_matches_flax(rng):
    R, C, nfg = 3, 16, 4
    pooled = rng.randn(R, 14, 14, C).astype(np.float32)
    jhead = JMaskHead(nfg)
    params = jax.tree.map(np.asarray, jhead.init(
        jax.random.PRNGKey(0), jnp.asarray(pooled)))["params"]
    params = _randomize(params, rng)
    k = params["mask_deconv"]["kernel"]
    assert not np.allclose(k, k[::-1, ::-1])
    want = jhead.apply({"params": params}, jnp.asarray(pooled))
    head = MaskHead(nfg, in_channels=C)
    head.load_state_dict(convert({"params": params}, head), strict=True)
    with torch.inference_mode():
        got = head(torch.from_numpy(pooled))
    assert got.shape == (R, 28, 28, 2 * nfg)
    close_to_scale(got, want)


def _mask_variables(variables, rng):
    """Perturb what the flax init leaves trivial: BN statistics, the offset
    convs and FCs (mask_offset included) and the mask head's 0.01-scale
    kernels, which would leave every mask logit at its bias."""
    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            p = path + (k,)
            if isinstance(v, dict):
                out[k] = walk(v, p)
            elif p[0] == "batch_stats":
                out[k] = ((rng.randn(*v.shape) * 0.1) if k == "mean"
                          else rng.uniform(0.5, 1.5, v.shape)).astype(
                              np.float32)
            elif k == "kernel" and ("offset" in p or "mask_offset" in p):
                out[k] = (rng.randn(*v.shape) * 0.01).astype(np.float32)
            elif k == "kernel" and "mask" in p:
                fan_in = int(np.prod(v.shape[:-1]))
                out[k] = (rng.randn(*v.shape)
                          * np.sqrt(2.0 / fan_in)).astype(np.float32)
            elif k == "bias":
                out[k] = (v + rng.randn(*v.shape) * 0.01).astype(np.float32)
            else:
                out[k] = v
        return out

    return {c: walk(t, (c,)) for c, t in variables.items()}


def test_mask_detector_matches_jax():
    rng = np.random.RandomState(13)
    B, H, W = 2, 64, 96
    jmodel, variables = tiny_jax_detector(5, with_mask=True)
    variables = _mask_variables(variables, rng)
    model = tiny_torch_detector(variables, with_mask=True)
    data = rng.randn(B, H, W, 3).astype(np.float32)
    im_info = np.array([[H, W, 1.0], [H - 8, W - 20, 1.0]], np.float32)
    want = jmodel.apply(variables, jnp.asarray(data), jnp.asarray(im_info),
                        train=False)
    with torch.inference_mode():
        got = model(torch.from_numpy(data), torch.from_numpy(im_info))
    assert got["mask_prob"].shape == (B, 16, 28, 28)
    np.testing.assert_array_equal(got["roi_valid"].numpy(),
                                  np.asarray(want["roi_valid"]))
    np.testing.assert_allclose(got["rois"].numpy(), np.asarray(want["rois"]),
                               atol=1e-3, rtol=1e-5)
    close_to_scale(got["cls_prob"], want["cls_prob"])
    close_to_scale(got["bbox_pred"], want["bbox_pred"])
    # the masks must be informative, not a constant 0.5 plane
    assert float(np.asarray(want["mask_prob"]).std()) > 0.01
    close_to_scale(got["mask_prob"], want["mask_prob"])


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, np.ndarray)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(ROOT, "configs", "*.yml"))), ids=os.path.basename)
def test_load_config_matches_jax(path):
    assert _plain(load_config(path)) == _plain(jload_config(path))


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_coco_eval_matches_golden(iou_type):
    """The port's copy of the COCO evaluator gives the reference
    protocol's numbers (tests/fixtures/cocoeval_golden.json)."""
    from sniper_tpu_torch.data.coco_eval import COCOEvaluator
    from test_coco_eval_golden import FIXTURE, STAT_KEYS, _fake_dataset, \
        _roidb

    with open(FIXTURE) as f:
        fx = json.load(f)
    stats = COCOEvaluator(_fake_dataset(fx), _roidb(fx),
                          iou_type=iou_type).evaluate(fx[f"dts_{iou_type}"])
    np.testing.assert_allclose([stats[k] for k in STAT_KEYS],
                               fx[f"stats_{iou_type}"], atol=1e-9)


def _synth_coco(root, n_images=2):
    """A COCO-style annotation file of n_images 'img<i>:<h>x<w>' images
    (synth_image_loader draws them) with polygon masks, 4 categories."""
    os.makedirs(os.path.join(root, "annotations"))
    rng = np.random.RandomState(3)
    images, anns = [], []
    for i in range(n_images):
        h, w = 96, 128
        images.append({"id": i + 1, "file_name": f"img{i}:{h}x{w}",
                       "height": h, "width": w})
        for k in range(3):
            x, y = rng.uniform(0, 60), rng.uniform(0, 40)
            bw, bh = rng.uniform(20, 60), rng.uniform(20, 50)
            poly = [x, y, x + bw, y, x + bw, y + bh, x, y + bh]
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(rng.randint(1, 5)),
                         "bbox": [x, y, bw, bh], "area": bw * bh,
                         "iscrowd": 0, "segmentation": [poly]})
    cats = [{"id": c, "name": f"c{c}"} for c in range(1, 5)]
    with open(os.path.join(root, "annotations", "instances_val.json"),
              "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": cats}, f)


def test_mask_config_test_roidb_carries_masks(tmp_path):
    """build_test_dataset reads a mask config's test set with its masks,
    cached under the mask key, as the JAX CLI does."""
    from sniper_tpu_torch.main_test import build_test_dataset

    cfg = load_config(os.path.join(ROOT, "configs",
                                   "sniper_res101_e2e_mask.yml"))
    assert cfg.dataset.dataset == "coco" and cfg.TRAIN.WITH_MASK
    cfg.dataset.test_image_set = "val"
    cfg.dataset.root_path = str(tmp_path)
    cfg.dataset.dataset_path = str(tmp_path)
    _synth_coco(str(tmp_path))
    roidb = build_test_dataset(cfg).gt_roidb()
    assert len(roidb) == 2
    for entry in roidb:
        assert len(entry["gt_masks"]) == len(entry["boxes"]) == 3
    assert [os.path.basename(p) for p in glob.glob(
        str(tmp_path / "cache" / "*.pkl"))] == ["COCO_val_gt_roidb_mask.pkl"]


def test_run_detection_with_masks(tmp_path):
    """The mask config's inference chain on the CPU: detection with masks
    at two scales, aggregation, then both COCO evaluations of the port's
    own dataset reader."""
    from sniper_tpu_torch.data.coco import COCODataset
    from sniper_tpu_torch.main_test import run_detection
    from sniper_tpu_torch.models.init import init_detector

    cfg = load_config(os.path.join(ROOT, "configs",
                                   "sniper_res101_e2e_mask.yml"))
    assert cfg.symbol == "resnet_mx_101_e2e_mask" and cfg.TRAIN.WITH_MASK
    cfg.TEST.SCALES = [(96, 128), (-1, 96)]
    cfg.TEST.BATCH_IMAGES = [2, 2]
    cfg.TEST.N_PROPOSAL_PER_SCALE = [12, 8]
    cfg.TEST.VALID_RANGES = [(-1, 90), (32, -1)]
    _synth_coco(str(tmp_path))
    ds = COCODataset("val", str(tmp_path), str(tmp_path))
    roidb = ds.gt_roidb(use_cache=False)
    model = init_detector(tiny_torch_detector(with_mask=True), seed=0,
                          offset_std=1e-3)
    stats = run_detection(cfg, model, None, roidb, ds, str(tmp_path),
                          torch.device("cpu"),
                          image_loader=lambda p: synth_image_loader(
                              os.path.basename(p)))
    assert set(stats) == {"bbox", "segm"}
    for kind in ("bbox", "segm"):
        assert "AP" in stats[kind]
    with open(os.path.join(ds.result_path,
                           "segmentations_val_results.json")) as f:
        segm = json.load(f)
    assert segm and all(r["segmentation"]["size"] == [96, 128] for r in segm)
