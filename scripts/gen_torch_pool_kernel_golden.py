"""Generate the fixture that holds the port's network.POOL_KERNEL=pallas
route against the JAX package's.

On the CPU, with the Pallas patch extraction (ops/pallas/roi_patch.py) in
interpret mode, as the JAX package runs it there:

- ``sniper_tpu.ops.deform.rcnn_head_fused(..., extract="pallas",
  return_offset_stats=True)`` at P=7, margin 1 and 2 bins, on seeded
  inputs (head_inputs: a 20x28 map of 8 channels, 2 images of 6 rois with
  one fully off the map on each side and a sub-bin one, a nonzero offset FC
  and random FC weights): cls_score, bbox_pred and the raw offset-FC
  output;
- the inference forward of ``SNIPERDetector(pool_kernel="pallas")``, the
  tiny detector of tests/torch_port.py (TINY), on ``zoo_variables`` (the
  port's seeded init written into the flax tree) perturbed as
  tests/test_torch_detector.py does (BatchNorms, offset convs and the head's
  offset FC, biases), over seeded unit-noise 64x96 images: rois,
  roi_scores, roi_valid, cls_prob and bbox_pred.

tests/test_torch_pool_kernel.py runs the port on the same inputs and
compares. The JAX side takes about 40 s here (the interpret-mode kernel),
which is why its outputs are frozen. Regenerate (only after an intentional
change of the semantics):
    python scripts/gen_torch_pool_kernel_golden.py
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import gen_torch_train_golden as gg  # noqa: E402  (sets up jax on the CPU)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

FIXTURE = os.path.join(gg.ROOT, "tests", "fixtures",
                       "torch_pool_kernel_golden.json")
MARGINS = (1, 2)
HEAD = dict(B=2, H=20, W=28, C=8, rpi=6, P=7, fc=16, classes=5)
FWD_HW = (64, 96)
FWD_KEYS = ("rois", "roi_scores", "roi_valid", "cls_prob", "bbox_pred")


def head_inputs(margin_bins):
    """(feat [B,H,W,C], rois [B*rpi,5], the head's weights as the port takes
    them: ((w [out, in], b [out]), ...) for the offset FC, fc_new_1,
    fc_new_2, cls_score and bbox_pred), NumPy fp32."""
    h = HEAD
    rng = np.random.RandomState(40 + margin_bins)
    B, rpi, P, C = h["B"], h["rpi"], h["P"], h["C"]
    R = B * rpi
    feat = rng.randn(B, h["H"], h["W"], C).astype(np.float32)
    rois = np.zeros((R, 5), np.float32)
    rois[:, 0] = np.repeat(np.arange(B), rpi)
    rois[:, 1:3] = rng.uniform(-40, 400, (R, 2))
    rois[:, 3:5] = rois[:, 1:3] + rng.uniform(3, 400, (R, 2))
    # fully off the map on both sides, and a sub-bin roi
    rois[0, 1:] = [-500, -500, -400, -400]
    rois[1, 1:] = [5000, 5000, 6000, 6000]
    rois[2, 1:] = [40, 40, 41, 41]
    dims = ((P * P * C, 2 * P * P, 0.05), (P * P * C, h["fc"], 0.05),
            (h["fc"], h["fc"], 0.2), (h["fc"], h["classes"], 0.2),
            (h["fc"], 4, 0.2))
    params = tuple(((rng.randn(o, i) * s).astype(np.float32),
                    (rng.randn(o) * 0.1).astype(np.float32))
                   for i, o, s in dims)
    return feat, rois, params


def forward_inputs():
    h, w = FWD_HW
    rng = np.random.RandomState(33)
    data = rng.randn(2, h, w, 3).astype(np.float32)
    im_info = np.array([[h, w, 1.0], [h - 8, w - 20, 1.0]], np.float32)
    return data, im_info


def forward_variables():
    from test_torch_detector import _perturb
    from torch_port import zoo_variables

    return zoo_variables("resnet", seed=3, perturb=lambda v: _perturb(
        v, np.random.RandomState(7)))


def run_head(margin_bins):
    from sniper_tpu.ops.deform import rcnn_head_fused

    feat, rois, params = head_inputs(margin_bins)
    # the JAX head takes [in, out] kernels
    flat = tuple(jnp.asarray(a) for w, b in params for a in (w.T, b))
    cls, bbox, off = rcnn_head_fused(
        jnp.asarray(feat), jnp.asarray(rois), flat,
        rois_per_image=HEAD["rpi"], pooled_size=HEAD["P"],
        margin_bins=margin_bins, extract="pallas", return_offset_stats=True)
    return {"cls_score": np.asarray(cls).tolist(),
            "bbox_pred": np.asarray(bbox).tolist(),
            "offset": np.asarray(off).tolist()}


def run_forward():
    from torch_port import zoo_jax_detector

    model = zoo_jax_detector("resnet", pool_kernel="pallas")
    data, im_info = forward_inputs()
    out = jax.jit(lambda v, d, i: model.apply(v, d, i, train=False))(
        forward_variables(), data, im_info)
    return {k: np.asarray(out[k]).tolist() for k in FWD_KEYS}


def main():
    out = {f"head_margin{m}": run_head(m) for m in MARGINS}
    out["forward"] = run_forward()
    print("valid rois", np.sum(out["forward"]["roi_valid"], axis=1))
    with open(FIXTURE, "w") as f:
        json.dump(out, f)
        f.write("\n")
    print(f"wrote {FIXTURE}")


if __name__ == "__main__":
    main()
