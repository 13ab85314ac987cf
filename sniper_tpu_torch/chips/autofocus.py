"""AutoFocus inference chip generation (FocusPixels -> FocusChips).

A jax-free copy of sniper_tpu/chips/autofocus.py (rebuild of the
reference's lib/chips/chips_inference.py:12-173):

- gmask: threshold the FocusPixel probability map, dilate with a d x d
  kernel, take connected-component bounding rects, enforce a minimum
  chip size ``ms`` (grid cells) with boundary-aware placement, and
  iterate paint-and-merge until the chip set reaches a fixpoint; then
  map grid coords x16 back to (cropped) image pixels and divide by the
  current scale.
- add_chips: per image, replace roidb['inference_crops'] with next-scale
  FocusChips translated into image coordinates; report the % of pixels
  the next scale will process (the reference's speedup proxy).

Connected components use scipy.ndimage (label + find_objects) instead of
cv2.findContours: for filled binary masks the outer-contour bounding
rects are exactly the component bounding boxes. Integer arithmetic
follows the reference's Python-2 floor division. The resize rule is
data/test_loader.py's ``scale_for_image``, which reads [-1, hi] specs as
the test iterator does.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import ndimage

from sniper_tpu_torch.data.test_loader import scale_for_image


def _component_rects(mask: np.ndarray) -> list[tuple[int, int, int, int]]:
    """Bounding rects (x, y, w, h) of connected components (8-conn)."""
    lab, n = ndimage.label(mask > 0, structure=np.ones((3, 3), np.int32))
    rects = []
    for sl in ndimage.find_objects(lab):
        if sl is None:
            continue
        y, x = sl
        rects.append((x.start, y.start, x.stop - x.start, y.stop - y.start))
    return rects


def _place(cx, cy, w, h, iw, ih):
    """Boundary-aware placement of a w x h rect centered at (cx, cy)."""
    if cx + w // 2 >= iw:
        x = iw - w if iw - w >= 0 else 0
    elif cx - w // 2 < 0:
        x = 0
    else:
        x = cx - w // 2
    if cy + h // 2 >= ih:
        y = ih - h if ih - h >= 0 else 0
    elif cy - h // 2 < 0:
        y = 0
    else:
        y = cy - h // 2
    return int(x), int(y)


def gmask(mask, d, thresh_value=0.5, ms=16, im_width=0, im_height=0, cscale=1.0):
    """FocusPixel prob map [fh, fw] -> list of chips in unscaled-crop
    pixel coords (divided by cscale)."""
    iw = int(math.ceil(float(im_width) / 16))
    ih = int(math.ceil(float(im_height) / 16))
    m = (np.asarray(mask, np.float32) >= thresh_value).astype(np.uint8)
    if d > 1:
        m = ndimage.binary_dilation(m, structure=np.ones((d, d), bool)).astype(np.uint8)
    m = m * 255

    cnts = _component_rects(m)
    chips: list[list[int]] = []
    nchips = -1
    while nchips != len(chips):
        nchips = len(chips)
        # paint min-size-expanded rects, then re-extract merged components
        for x, y, w, h in cnts:
            cx = (x + x + w) // 2
            cy = (y + y + h) // 2
            w = max(ms, w)
            h = max(ms, h)
            px, py = _place(cx, cy, w, h, iw, ih)
            m[py : py + h, px : px + w] = 255
        cnts = _component_rects(m)
        chips = []
        for x, y, w, h in cnts:
            cx = (x + x + w) // 2
            cy = (y + y + h) // 2
            w = max(ms, w)
            h = max(ms, h)
            px, py = _place(cx, cy, w, h, iw, ih)
            chips.append([px, py, px + w, py + h])

    schips = []
    for c in chips:
        x1, y1, x2, y2 = c[0] * 16, c[1] * 16, c[2] * 16, c[3] * 16
        if x2 > im_width:
            x2 = im_width
            x1 = max(min(x1, x2 - ms * 16), 0)
        if y2 > im_height:
            y2 = im_height
            y1 = max(min(y1, y2 - ms * 16), 0)
        schips.append([x1 / cscale, y1 / cscale, x2 / cscale, y2 / cscale])
    return schips


def add_chips(roidb, maps, scale_id, cfg):
    """Replace roidb[i]['inference_crops'] with next-scale FocusChips.

    maps[i][j] is the FocusPixel fg-prob map of chip j of image i at the
    current scale. Returns [chip_area, total_area] (Mpx) and prints the
    percent-of-pixels proxy like the reference.
    """
    d, map_thresh, ms = cfg.TEST.CHIP_HYPERPARAMS[scale_id]
    total_area = 0.0
    chip_area = 0.0
    for i, r in enumerate(roidb):
        w, h = r["width"], r["height"]
        cscale = scale_for_image(w, h, cfg.TEST.SCALES[scale_id])
        tcscale = scale_for_image(w, h, cfg.TEST.SCALES[scale_id + 1])
        total_area += (w * h * tcscale * tcscale) / 1e6

        cur_chips = []
        for j, cmap in enumerate(maps[i]):
            if cmap is None:
                continue
            cur_crop = r["inference_crops"][j]
            crop_w = cur_crop[2] - cur_crop[0]
            crop_h = cur_crop[3] - cur_crop[1]
            chips = gmask(
                cmap, int(d), map_thresh, ms=int(ms),
                im_width=crop_w * cscale, im_height=crop_h * cscale,
                cscale=cscale,
            )
            for c in chips:
                c[0] += cur_crop[0]
                c[2] += cur_crop[0]
                c[1] += cur_crop[1]
                c[3] += cur_crop[1]
                chip_area += (c[2] - c[0]) * (c[3] - c[1]) * tcscale * tcscale / 1e6
            cur_chips += chips
        roidb[i]["inference_crops"] = np.array(cur_chips)

    pct = 100.0 * chip_area / max(total_area, 1e-9)
    print(f"Percent of pixels to be processed: {pct}")
    return [chip_area, total_area]
