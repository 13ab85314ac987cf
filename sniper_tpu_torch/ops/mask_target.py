"""Per-roi mask targets from the dense box-normalized GT masks.

Port of sniper_tpu/ops/mask_target.py:24-86. The host rasterizes each GT's
polygons once into a [D, D] grid over its box (data/mask_utils.py); here
the matched GT's grid is crop-resized bilinearly into each sampled roi's
S x S target grid, thresholded at 0.5 inside the GT's grid, with -1 on
every cell of an invalid roi (the mask loss ignores it).
"""

from __future__ import annotations

import torch


def mask_targets_from_dense(mask_rois, matched_gt, gt_boxes, gt_masks_dense,
                            mask_size: int = 28, thresh: float = 0.5):
    """mask_rois [B,M,5] (image index + xyxy, chip coordinates), matched_gt
    [B,M] GT index (-1 invalid), gt_boxes [B,G,5], gt_masks_dense
    [B,G,D,D] float in {0, 1}. Returns (targets [B,M,S,S] fp32 in
    {-1, 0, 1}, class_ids [B,M] int32, 0 for invalid rois)."""
    B, M = matched_gt.shape
    D = gt_masks_dense.shape[-1]
    S = mask_size
    dev = mask_rois.device
    valid = matched_gt >= 0
    g = matched_gt.long().clamp_min(0)
    boxes = torch.gather(gt_boxes[..., :4].float(), 1,
                         g[..., None].expand(B, M, 4))
    cls = torch.gather(gt_boxes[..., 4].float(), 1, g)
    masks = gt_masks_dense[torch.arange(B, device=dev)[:, None], g]
    masks = masks.float().reshape(B * M, D, D)
    rois = mask_rois.float().reshape(B * M, 5)
    boxes = boxes.reshape(B * M, 4)
    x1, y1, x2, y2 = rois[:, 1], rois[:, 2], rois[:, 3], rois[:, 4]
    # the S x S target cells' centres inside the roi
    f = (torch.arange(S, device=dev, dtype=torch.float32) + 0.5) / S
    py = y1[:, None] + f[None, :] * (y2 - y1)[:, None]  # [N,S]
    px = x1[:, None] + f[None, :] * (x2 - x1)[:, None]
    # into the GT box's dense-grid coordinates
    gw = (boxes[:, 2] - boxes[:, 0]).clamp_min(1e-3)
    gh = (boxes[:, 3] - boxes[:, 1]).clamp_min(1e-3)
    uy = (py - boxes[:, 1][:, None]) / gh[:, None] * D - 0.5
    ux = (px - boxes[:, 0][:, None]) / gw[:, None] * D - 0.5
    inside = ((uy[:, :, None] > -1.0) & (uy[:, :, None] < D)
              & (ux[:, None, :] > -1.0) & (ux[:, None, :] < D))  # [N,S,S]
    yc = uy.clamp(0.0, D - 1.0)
    xc = ux.clamp(0.0, D - 1.0)
    y0 = yc.floor().long()
    x0 = xc.floor().long()
    y1i = (y0 + 1).clamp_max(D - 1)
    x1i = (x0 + 1).clamp_max(D - 1)
    ly = (yc - y0)[:, :, None]  # [N,S,1]
    lx = (xc - x0)[:, None, :]  # [N,1,S]
    N = B * M

    def take(yy, xx):
        rows = torch.gather(masks, 1, yy[:, :, None].expand(N, S, D))
        return torch.gather(rows, 2, xx[:, None, :].expand(N, S, S))

    val = (take(y0, x0) * (1 - ly) * (1 - lx)
           + take(y0, x1i) * (1 - ly) * lx
           + take(y1i, x0) * ly * (1 - lx)
           + take(y1i, x1i) * ly * lx)
    tgt = torch.where(inside & (val >= thresh), 1.0, 0.0)
    tgt = torch.where(valid.reshape(N, 1, 1), tgt, -1.0)
    cls_ids = torch.where(valid, cls.to(torch.int32), 0)
    return tgt.reshape(B, M, S, S), cls_ids
