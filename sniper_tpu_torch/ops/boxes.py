"""Box geometry: NumPy and torch halves.

Port of sniper_tpu/ops/boxes.py:37-144 (box_area, bbox_overlaps,
ignore_overlaps, clip_boxes, filter_boxes_mask, bbox_transform, bbox_pred)
with the same legacy conventions: +1 widths, center = x1 + 0.5*(w-1), the
1e-7 eps in the encode denominators. Each function takes NumPy arrays (host
plane: the Tester, the chip loader) or torch tensors (device plane: the
proposal ops) and returns the same kind.
"""

from __future__ import annotations

import numpy as np
import torch


def _xp(*arrays):
    return torch if any(isinstance(a, torch.Tensor) for a in arrays) else np


def box_area(boxes):
    """Legacy (+1) area of [..., 4] xyxy boxes."""
    return (boxes[..., 2] - boxes[..., 0] + 1.0) * (
        boxes[..., 3] - boxes[..., 1] + 1.0
    )


def _stack(parts, like):
    if isinstance(like, torch.Tensor):
        return torch.stack(parts, dim=-1)
    return np.stack(parts, axis=-1)


def _intersection(boxes, query_boxes):
    xp = _xp(boxes, query_boxes)
    b = boxes[:, None, :]
    q = query_boxes[None, :, :]
    iw = xp.minimum(b[..., 2], q[..., 2]) - xp.maximum(b[..., 0], q[..., 0]) + 1.0
    ih = xp.minimum(b[..., 3], q[..., 3]) - xp.maximum(b[..., 1], q[..., 1]) + 1.0
    if xp is torch:
        return iw.clamp_min(0.0) * ih.clamp_min(0.0)
    return np.maximum(iw, 0.0) * np.maximum(ih, 0.0)


def bbox_overlaps(boxes, query_boxes):
    """IoU matrix. boxes [N,4], query_boxes [K,4] -> [N,K]."""
    inter = _intersection(boxes, query_boxes)
    union = box_area(boxes)[:, None] + box_area(query_boxes)[None, :] - inter
    if isinstance(inter, torch.Tensor):
        return torch.where(inter > 0.0, inter / union, 0.0)
    return np.where(inter > 0.0, inter / union, np.zeros_like(inter))


def ignore_overlaps(boxes, query_boxes):
    """Intersection area / query-box area. boxes [N,4], query [K,4] -> [N,K];
    1.0 iff the query box lies inside box n (chip coverage)."""
    return _intersection(boxes, query_boxes) / box_area(query_boxes)[None, :]


def filter_boxes_mask(boxes, min_size):
    """Boolean mask of boxes with both sides >= min_size."""
    ws = boxes[..., 2] - boxes[..., 0] + 1.0
    hs = boxes[..., 3] - boxes[..., 1] + 1.0
    return (ws >= min_size) & (hs >= min_size)


def bbox_transform(ex_rois, gt_rois, weights=(1.0, 1.0, 1.0, 1.0)):
    """Encode gt boxes relative to example rois -> deltas [..., 4]."""
    log = torch.log if isinstance(ex_rois, torch.Tensor) else np.log
    ew = ex_rois[..., 2] - ex_rois[..., 0] + 1.0
    eh = ex_rois[..., 3] - ex_rois[..., 1] + 1.0
    ex = ex_rois[..., 0] + 0.5 * (ew - 1.0)
    ey = ex_rois[..., 1] + 0.5 * (eh - 1.0)
    gw = gt_rois[..., 2] - gt_rois[..., 0] + 1.0
    gh = gt_rois[..., 3] - gt_rois[..., 1] + 1.0
    gx = gt_rois[..., 0] + 0.5 * (gw - 1.0)
    gy = gt_rois[..., 1] + 0.5 * (gh - 1.0)
    dx = weights[0] * (gx - ex) / (ew + 1e-7)
    dy = weights[1] * (gy - ey) / (eh + 1e-7)
    dw = weights[2] * log(gw / (ew + 1e-7))
    dh = weights[3] * log(gh / (eh + 1e-7))
    return _stack([dx, dy, dw, dh], ex_rois)


def clip_boxes(boxes, im_shape):
    """Clip [..., 4k] xyxy boxes to [0, H-1] x [0, W-1]. im_shape=(H, W);
    for torch, H and W may be tensors that broadcast against
    ``boxes[..., 0::4]``."""
    h, w = im_shape[0], im_shape[1]
    if isinstance(boxes, torch.Tensor):
        def clip(v, hi):
            return torch.minimum(v.clamp_min(0.0), torch.as_tensor(
                hi, dtype=v.dtype, device=v.device))
    else:
        def clip(v, hi):
            return np.clip(v, np.zeros_like(v), hi)
    out = _stack([
        clip(boxes[..., 0::4], w - 1.0),
        clip(boxes[..., 1::4], h - 1.0),
        clip(boxes[..., 2::4], w - 1.0),
        clip(boxes[..., 3::4], h - 1.0),
    ], boxes)  # [..., k, 4]
    return out.reshape(boxes.shape)


def bbox_pred(boxes, box_deltas):
    """Decode deltas on boxes. boxes [...,4], deltas [...,4k] -> [...,4k]."""
    exp = torch.exp if isinstance(box_deltas, torch.Tensor) else np.exp
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * (widths - 1.0)
    ctr_y = boxes[..., 1] + 0.5 * (heights - 1.0)

    dx = box_deltas[..., 0::4]
    dy = box_deltas[..., 1::4]
    dw = box_deltas[..., 2::4]
    dh = box_deltas[..., 3::4]

    pred_ctr_x = dx * widths[..., None] + ctr_x[..., None]
    pred_ctr_y = dy * heights[..., None] + ctr_y[..., None]
    pred_w = exp(dw) * widths[..., None]
    pred_h = exp(dh) * heights[..., None]

    out = _stack([
        pred_ctr_x - 0.5 * (pred_w - 1.0),
        pred_ctr_y - 0.5 * (pred_h - 1.0),
        pred_ctr_x + 0.5 * (pred_w - 1.0),
        pred_ctr_y + 0.5 * (pred_h - 1.0),
    ], box_deltas)  # [..., k, 4]
    return out.reshape(box_deltas.shape)
