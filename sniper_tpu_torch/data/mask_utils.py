"""Mask polygons on the host: into chip coordinates, then rasterized.

A jax-free copy of sniper_tpu/data/mask_utils.py:22-33,75-101 (the JAX
module imports no jax, but the port keeps its own copy of what it needs).
Each GT's polygons are rasterized once into a fixed box-normalized grid
(112^2 by default, 4x the 28^2 target resolution); the detector then
crop-resizes the matched GT's grid into every sampled roi's target
(ops/mask_target.py). The reference's fixed-size polygon encoding
(``poly_encoder`` / ``poly_decoder``) has no caller on this path and is
left out.
"""

from __future__ import annotations

import numpy as np


def crop_polys(polys, crop, im_scale):
    """Shift each GT's polygon segments into chip coordinates (``crop`` is
    the chip box in image coordinates) and scale them by ``im_scale``."""
    out = []
    for poly in polys:
        segs = []
        for seg in poly:
            s = np.array(seg, dtype=np.float32).copy()
            s[0::2] -= crop[0]
            s[1::2] -= crop[1]
            s *= im_scale
            segs.append(s)
        out.append(segs)
    return out


def rasterize_gt_masks(polys_per_gt, gt_boxes, grid=112, max_n_gts=100):
    """Rasterize each GT's polygons into a box-normalized [grid, grid]
    binary mask. polys_per_gt: list (per GT) of segment arrays in the
    coordinate frame of gt_boxes [N,4]. Returns [max_n_gts, grid, grid]
    uint8 in {0, 1}, zeros for missing GTs: uint8 keeps the host-to-device
    payload 4x smaller, and the detector casts it to float."""
    import cv2

    out = np.zeros((max_n_gts, grid, grid), np.uint8)
    for i, (segs, box) in enumerate(zip(polys_per_gt, gt_boxes)):
        if i >= max_n_gts or not segs:
            continue
        x1, y1, x2, y2 = box[:4]
        w = max(x2 - x1, 1e-3)
        h = max(y2 - y1, 1e-3)
        canvas = np.zeros((grid, grid), np.uint8)
        pts = []
        for seg in segs:
            p = np.asarray(seg, np.float64).reshape(-1, 2).copy()
            p[:, 0] = (p[:, 0] - x1) / w * grid
            p[:, 1] = (p[:, 1] - y1) / h * grid
            pts.append(np.round(p).astype(np.int32))
        cv2.fillPoly(canvas, pts, 1)
        out[i] = canvas
    return out
