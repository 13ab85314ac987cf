"""The port's run_detection chain against the JAX pipeline's golden
detections.

scripts/gen_golden_detections.py froze tests/fixtures/golden_detections.json
from a PRNGKey(42) tiny detector run through the JAX 2-scale chain (per-chip
decode/clip/rescale, per-class score filter, VALID_RANGES, gaussian
soft-NMS, MAX_PER_IMAGE). Here the same flax variables, converted, run
through sniper_tpu_torch.main_test.run_detection on the CPU with the same
config, images and roidb. Tolerances: boxes within 0.05 px, scores within
1e-3 (in [0, 1]). The fp32 convolutions sum in another order than XLA's, so
the RPN deltas differ by about 1e-6 relative and the decoded boxes of these
256x320 images by up to about 0.01 px; soft-NMS then rescales scores by
exp(-IoU^2 / sigma), and the IoU of the sub-pixel-wide boxes this random
detector emits moves with those shifts (2.6e-4 measured). The rest of the
chain is the same arithmetic, and the emission order must match exactly.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sniper_tpu_torch.main_test import run_detection
from torch_port import tiny_torch_detector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "golden_detections.json")


class _Keep:
    """Dataset stand-in: evaluate_detections hands back the detections."""

    def __init__(self, num_classes):
        self.num_classes = num_classes

    def evaluate_detections(self, all_boxes, roidb):
        return all_boxes


def test_run_detection_matches_golden_fixture(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import gen_golden_detections as gg
    from sniper_tpu.models.detector import SNIPERDetector

    kw = dict(num_classes=gg.NUM_CLASSES, num_anchors=9,
              anchor_scales=(2, 4, 7), anchor_ratios=(0.5, 1, 2),
              units=(1, 1, 1, 1), pre_nms_top_n=200, post_nms_top_n=24)
    jmodel = SNIPERDetector(dtype=jnp.float32, num_rois=24, **kw)
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(42)},
        jnp.zeros((1, 128, 128, 3), jnp.float32),
        jnp.asarray([[128.0, 128.0, 1.0]], jnp.float32), train=False)
    model = tiny_torch_detector(jax.tree.map(np.asarray, variables), **kw)

    cfg = gg.make_cfg()
    roidb = [{"image": f"im{i}", "width": gg.IM_W, "height": gg.IM_H,
              "flipped": False} for i in range(gg.N_IMAGES)]
    final = run_detection(cfg, model, None, roidb, _Keep(gg.NUM_CLASSES),
                          str(tmp_path), torch.device("cpu"),
                          image_loader=gg.synth_loader)

    with open(FIXTURE) as f:
        want = json.load(f)
    total = 0
    for c in range(gg.NUM_CLASSES):
        for i in range(gg.N_IMAGES):
            got = np.asarray(final[c][i], np.float32).reshape(-1, 5)
            exp = np.asarray(want["dets"][c][i], np.float32).reshape(-1, 5)
            assert got.shape == exp.shape, f"class {c} image {i}"
            np.testing.assert_allclose(got[:, :4], exp[:, :4], rtol=0,
                                       atol=0.05, err_msg=f"class {c} "
                                       f"image {i} boxes")
            np.testing.assert_allclose(got[:, 4], exp[:, 4], rtol=0,
                                       atol=1e-3, err_msg=f"class {c} "
                                       f"image {i} scores")
            total += len(exp)
    assert total > 0
