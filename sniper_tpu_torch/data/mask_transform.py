"""Box-window mask intersection and cross-box mask IoU.

A NumPy copy of sniper_tpu/data/mask_transform.py, itself a rebuild of the
reference's lib/mask/mask_transform.py:11-70 and
lib/mask/mask_voc2coco.py:39-49: masks here are dense binary arrays whose
coordinate frame is the (integer) box that contains them, for VOC
SDS-style mask evaluation and for turning per-detection masks into COCO
RLE results. Neither package calls it yet.
"""

from __future__ import annotations

import numpy as np


def intersect_box_mask(ex_box, gt_box, gt_mask):
    """Paint the part of ``gt_mask`` (gt_box frame, full-image indexed)
    that falls inside ``ex_box`` onto an ex_box-sized canvas.

    Reference semantics (mask_transform.py:11-38): gt_mask is indexed by
    absolute image coordinates; boxes are integer, inclusive on both
    ends. Returns a float array [ex_h, ex_w]."""
    ex_box = np.asarray(ex_box, np.intp)
    gt_box = np.asarray(gt_box, np.intp)
    x1 = max(ex_box[0], gt_box[0])
    y1 = max(ex_box[1], gt_box[1])
    x2 = min(ex_box[2], gt_box[2])
    y2 = min(ex_box[3], gt_box[3])
    if x1 > x2 or y1 > y2:
        return np.zeros((21, 21), dtype=bool)
    w = x2 - x1 + 1
    h = y2 - y1 + 1
    out = np.zeros(
        (ex_box[3] - ex_box[1] + 1, ex_box[2] - ex_box[0] + 1)
    )
    sy, sx = y1 - ex_box[1], x1 - ex_box[0]
    out[sy : sy + h, sx : sx + w] = gt_mask[y1 : y2 + 1, x1 : x2 + 1]
    return out


def mask_overlap(box1, box2, mask1, mask2):
    """IoU of two masks living in different (integer, inclusive) boxes
    (mask_transform.py:41-70)."""
    box1 = np.asarray(box1, np.intp)
    box2 = np.asarray(box2, np.intp)
    x1 = max(box1[0], box2[0])
    y1 = max(box1[1], box2[1])
    x2 = min(box1[2], box2[2])
    y2 = min(box1[3], box2[3])
    if x1 > x2 or y1 > y2:
        return 0.0
    w = x2 - x1 + 1
    h = y2 - y1 + 1
    ya, xa = y1 - box1[1], x1 - box1[0]
    ia = mask1[ya : ya + h, xa : xa + w]
    yb, xb = y1 - box2[1], x1 - box2[0]
    ib = mask2[yb : yb + h, xb : xb + w]
    assert ia.shape == ib.shape
    inter = np.logical_and(ia, ib).sum()
    union = mask1.sum() + mask2.sum() - inter
    if union < 1.0:
        return 0.0
    return float(inter) / float(union)


def mask_voc2coco(voc_masks, voc_boxes, im_height, im_width,
                  binary_thresh=0.4):
    """Per-detection box-frame masks -> full-image COCO RLEs
    (mask_voc2coco.py:39-49): resize each soft mask to its (rounded,
    inclusive) box, threshold, paste into the image canvas, RLE-encode.
    Returns a list of RLE dicts."""
    import cv2

    from sniper_tpu_torch.infer.masks import binary_mask_to_rle

    voc_boxes = np.asarray(voc_boxes)
    assert len(voc_masks) == voc_boxes.shape[0]
    rles = []
    for i in range(len(voc_masks)):
        box = np.round(voc_boxes[i, :4]).astype(int)
        canvas = np.zeros((im_height, im_width), np.uint8)
        w = min(box[2] + 1, im_width) - max(box[0], 0)
        h = min(box[3] + 1, im_height) - max(box[1], 0)
        if w > 0 and h > 0:
            m = cv2.resize(
                np.asarray(voc_masks[i], np.float32),
                (box[2] - box[0] + 1, box[3] - box[1] + 1),
            )
            y0, x0 = max(box[1], 0), max(box[0], 0)
            my0, mx0 = y0 - box[1], x0 - box[0]
            canvas[y0 : y0 + h, x0 : x0 + w] = (
                m[my0 : my0 + h, mx0 : mx0 + w] >= binary_thresh
            )
        rles.append(binary_mask_to_rle(canvas.astype(bool)))
    return rles
