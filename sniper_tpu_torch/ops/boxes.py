"""Box geometry for the inference path: NumPy and torch halves.

Port of sniper_tpu/ops/boxes.py:37-144 (box_area, bbox_pred, clip_boxes)
with the same legacy conventions: +1 widths, center = x1 + 0.5*(w-1). Each
function takes NumPy arrays (host plane: the Tester) or torch tensors
(device plane: the proposal op) and returns the same kind.
"""

from __future__ import annotations

import numpy as np
import torch


def box_area(boxes):
    """Legacy (+1) area of [..., 4] xyxy boxes."""
    return (boxes[..., 2] - boxes[..., 0] + 1.0) * (
        boxes[..., 3] - boxes[..., 1] + 1.0
    )


def _stack(parts, like):
    if isinstance(like, torch.Tensor):
        return torch.stack(parts, dim=-1)
    return np.stack(parts, axis=-1)


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
