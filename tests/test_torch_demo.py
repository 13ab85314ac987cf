"""The demo (sniper_tpu_torch/demo.py) against the JAX demo's chain, on the
CPU in fp32.

``detect`` on one 320x256 image against the top-level demo.py:58-89
composed with the JAX package (the same converted PRNGKey(42) tiny
detector of test_torch_pipeline, every TEST.SCALES entry at batch 1,
``aggregate``): the same detections per class, boxes within 0.05 px and
scores within 1e-3 (test_torch_pipeline's bounds: the frameworks' fp32
RPN differs in the last bits, and soft-NMS rescales scores by the IoU of
the boxes). Then the CLI, ``main`` over a yml whose registry symbol is
patched to a tiny R50 (test_torch_recipe's way), restores a training
checkpoint and writes the image that ``render`` of ``detect`` gives.
"""

import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import torch

from sniper_tpu_torch import demo
from torch_port import tiny_torch_detector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import gen_golden_detections as gd  # noqa: E402

KW = dict(num_classes=gd.NUM_CLASSES, num_anchors=9,
          anchor_scales=(2, 4, 7), anchor_ratios=(0.5, 1, 2),
          units=(1, 1, 1, 1), pre_nms_top_n=200, post_nms_top_n=24)


def _image(tmp_path):
    path = str(tmp_path / "im.png")
    cv2.imwrite(path, gd.synth_loader("im0"))
    return path


def _jax_demo(cfg, jmodel, variables, im_path):
    """demo.py:58-89 with the JAX package, variables given."""
    from sniper_tpu.data.test_loader import (
        TestChipIterator,
        init_inference_crops,
    )
    from sniper_tpu.infer.tester import Tester, device_normalize

    im = cv2.imread(im_path, cv2.IMREAD_COLOR)
    roidb = [{"image": im_path, "width": im.shape[1],
              "height": im.shape[0], "flipped": False}]
    init_inference_crops(roidb)

    @jax.jit
    def fwd(variables, data, im_info):
        data = device_normalize(data, im_info, cfg.network.PIXEL_MEANS)
        return jmodel.apply(variables, data, im_info, train=False)

    tester = Tester(lambda d, i: fwd(variables, d, i), cfg,
                    cfg.dataset.NUM_CLASSES)
    scale_dets = []
    for s in range(len(cfg.TEST.SCALES)):
        batches = TestChipIterator(roidb, cfg, s, 1)
        all_boxes, _ = tester.get_detections(iter(batches), roidb)
        scale_dets.append(all_boxes)
    final = tester.aggregate(scale_dets, 1)
    return [final[j][0] for j in range(len(final))]


def test_detect_matches_the_jax_demo(tmp_path):
    from sniper_tpu.models.detector import SNIPERDetector
    from sniper_tpu_torch.config import default_config

    jmodel = SNIPERDetector(dtype=jnp.float32, num_rois=24, **KW)
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(42)},
        jnp.zeros((1, 128, 128, 3), jnp.float32),
        jnp.asarray([[128.0, 128.0, 1.0]], jnp.float32), train=False)
    model = tiny_torch_detector(jax.tree.map(np.asarray, variables), **KW)
    im_path = _image(tmp_path)
    jcfg = gd.make_cfg()
    jcfg.dataset.NUM_CLASSES = gd.NUM_CLASSES
    want = _jax_demo(jcfg, jmodel, variables, im_path)

    cfg = default_config()
    for key in ("SCALES", "VALID_RANGES", "NMS", "NMS_SIGMA",
                "MAX_PER_IMAGE", "DO_PRUNING", "AUTO_FOCUS"):
        setattr(cfg.TEST, key, getattr(jcfg.TEST, key))
    cfg.network.PIXEL_MEANS = jcfg.network.PIXEL_MEANS
    cfg.dataset.NUM_CLASSES = gd.NUM_CLASSES
    got = demo.detect(cfg, model, None, im_path, torch.device("cpu"))
    assert len(got) == len(want) == gd.NUM_CLASSES
    assert sum(len(d) for d in want) > 0
    for j, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g).reshape(-1, 5), np.asarray(w).reshape(-1, 5)
        assert g.shape == w.shape, j
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=0.05,
                                   err_msg=f"class {j} boxes")
        np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=1e-3,
                                   err_msg=f"class {j} scores")


CFG = """---
output_path: "{tmp}/output"
symbol: resnet_mx_50_e2e
network:
  pretrained: ""
  PIXEL_MEANS: [103.939, 116.779, 123.68]
  ANCHOR_RATIOS: [0.5, 1, 2]
  ANCHOR_SCALES: [2, 4, 7]
  NUM_ANCHORS: 9
dataset:
  NUM_CLASSES: 4
  image_set: train_tiny
TEST:
  SCALES: [[-1, 320], [-1, 192]]
  VALID_RANGES: [[-1, 90], [60, -1]]
  RPN_PRE_NMS_TOP_N: 200
  RPN_POST_NMS_TOP_N: 24
  NMS: -1
  TEST_EPOCH: 1
"""


def test_cli_restores_and_writes_the_rendered_image(tmp_path, monkeypatch,
                                                    capsys):
    from sniper_tpu_torch.config import load_config
    from sniper_tpu_torch.models import registry
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.train.checkpoint import save_checkpoint

    cfg_path = str(tmp_path / "demo_tiny.yml")
    with open(cfg_path, "w") as f:
        f.write(CFG.format(tmp=tmp_path))
    build = registry._resnet((1, 1, 1, 1))
    monkeypatch.setitem(registry._REGISTRY, "resnet_mx_50_e2e", build)
    cfg = load_config(cfg_path)
    model = init_detector(build(cfg), seed=4)
    save_checkpoint(str(tmp_path / "output" / "demo_tiny" / "train_tiny"
                        / "checkpoints"), 1, model)
    im_path = _image(tmp_path)
    out = str(tmp_path / "out.jpg")
    demo.main(["--cfg", cfg_path, "--im_path", im_path, "--out_path", out,
               "--device", "cpu"])
    assert f"wrote {out}" in capsys.readouterr().out
    final = demo.detect(cfg, model.eval(), None, im_path,
                        torch.device("cpu"))
    ref = demo.render(cfg, cv2.imread(im_path), final,
                      str(tmp_path / "ref.jpg"))
    np.testing.assert_array_equal(cv2.imread(out), cv2.imread(ref))
