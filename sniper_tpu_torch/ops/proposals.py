"""RPN proposal ops: ``multi_proposal`` (inference) and
``multi_proposal_target`` (training).

Port of sniper_tpu/ops/proposals.py:80-282, batched over images with
explicit tensor ops in place of ``jax.vmap``:

- ``proposals``: decode -> clip -> min-size filter -> top-k -> greedy NMS ->
  a fixed ``post_nms`` boxes per image. The top-k keeps ``lax.top_k``'s tie
  order (lower index first), so its output is already in NMS order: the NMS
  is ``ops.nms.nms_sorted``, the CUDA kernel for CUDA tensors without a
  second sort, the plain version on the CPU.
- ``multi_proposal_target``: the same proposals, with the GT boxes appended
  as candidates, labelled by IoU matching under SNIPER's per-chip valid
  ranges, then a stratified fg/bg sample of ``num_rois`` per image with
  std-normalized regression targets. It runs under ``torch.no_grad()``: no
  gradient reaches the RPN through it (the JAX ``stop_gradient``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sniper_tpu_torch.ops.boxes import bbox_pred, bbox_transform, clip_boxes
from sniper_tpu_torch.ops.nms import NEG_INF, nms_sorted


def _decode(fg_probs, deltas, im_info, anchors, min_size):
    """[B,A,H,W] probs, [B,4A,H,W] deltas -> props [B,N,4], scores [B,N]."""
    B, A, H, W = fg_probs.shape
    scores = fg_probs.reshape(B, -1)  # (A,H,W) flat
    # conv channel c = a*4 + k
    d = deltas.reshape(B, A, 4, H, W).permute(0, 1, 3, 4, 2).reshape(B, -1, 4)
    props = bbox_pred(anchors[None], d)
    props = clip_boxes(props, (im_info[:, 0, None, None],
                               im_info[:, 1, None, None]))
    ws = props[..., 2] - props[..., 0] + 1.0
    hs = props[..., 3] - props[..., 1] + 1.0
    ms = min_size * im_info[:, 2:3]
    ok = (ws >= ms) & (hs >= ms)
    return props, torch.where(ok, scores, NEG_INF)


def _top_k(values, k):
    """lax.top_k over the last axis: descending, the lower index first
    among ties (torch.topk leaves the tie order unspecified)."""
    v, i = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def select(props, scores, *, pre_nms, post_nms, thresh):
    """Decoded props [B,N,4] and scores [B,N] -> the top ``pre_nms`` by
    score, then greedy NMS: (boxes [B,post_nms,4], scores [B,post_nms],
    valid [B,post_nms]), zeros where not valid."""
    B, N = scores.shape
    k = min(pre_nms, N)
    # a random RPN saturates many scores at exactly 1.0: the tie order
    # decides which boxes survive
    top_scores, top_idx = _top_k(scores, k)
    top_props = torch.gather(props, 1, top_idx[..., None].expand(B, k, 4))
    # sorted as nms_sorted takes it: descending, ties in index order, the
    # NEG_INF of filtered boxes last
    keep, valid = nms_sorted(top_props, top_scores.contiguous(), post_nms,
                             thresh)
    safe = keep.clamp_min(0).long()
    boxes = torch.where(
        valid[..., None],
        torch.gather(top_props, 1, safe[..., None].expand(B, post_nms, 4)),
        0.0)
    return boxes, torch.where(valid, torch.gather(top_scores, 1, safe),
                              0.0), valid


def proposals(fg_probs, deltas, im_info, anchors, *, pre_nms, post_nms,
              thresh, min_size):
    """Decode and select: (boxes [B,post_nms,4], scores, valid)."""
    props, scores = _decode(fg_probs, deltas, im_info, anchors, min_size)
    return select(props, scores, pre_nms=pre_nms, post_nms=post_nms,
                  thresh=thresh)


def _with_batch_idx(boxes):
    B, n = boxes.shape[:2]
    idx = torch.arange(B, dtype=boxes.dtype, device=boxes.device)
    return torch.cat([idx[:, None, None].expand(B, n, 1), boxes], dim=-1)


def multi_proposal(fg_probs, deltas, im_info, anchors, *, pre_nms=6000,
                   post_nms=300, thresh=0.7, min_size=0.0):
    """fg_probs [B,A,H,W], deltas [B,4A,H,W], im_info [B,3] (h, w, scale),
    anchors [A*H*W, 4] in (A,H,W) order. Returns rois [B, post_nms, 5]
    (batch idx + xyxy, zeros where not valid), scores [B, post_nms] and
    valid [B, post_nms] bool."""
    boxes, scores, valid = proposals(
        fg_probs, deltas, im_info, anchors, pre_nms=pre_nms,
        post_nms=post_nms, thresh=thresh, min_size=min_size)
    return _with_batch_idx(boxes), scores, valid


class ProposalTargets(NamedTuple):
    rois: torch.Tensor          # [B, R, 5] (batch idx + xyxy)
    labels: torch.Tensor        # [B, R] int64, -1 ignore / 0 bg / class fg
    bbox_targets: torch.Tensor  # [B, R, 4] std-normalized deltas
    bbox_weights: torch.Tensor  # [B, R, 4] 1.0 at fg rois
    matched_gt: torch.Tensor    # [B, R] gt index of fg rois, -1 else


def _gather_rows(x, idx):
    """x [B,N,...], idx [B,K] -> [B,K,...]."""
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(idx.shape + x.shape[2:]))


def _sample_rois(props, prop_valid, gt_boxes, valid_ranges, fg_u, bg_u, *,
                 num_rois, fg_fraction, fg_thresh, bg_thresh_hi,
                 bg_thresh_lo, bbox_stds, bbox_means):
    """Label and sample the candidates (proposals + GT boxes) of every
    image, as _sample_rois_single does per image. fg_u/bg_u [B, P+G] are
    the uniform priorities of the fg and the bg draw."""
    B, P = prop_valid.shape
    dev = props.device
    gt = gt_boxes[..., :4]
    gt_cls = gt_boxes[..., 4]
    gt_valid = gt_cls >= 0  # -1 padded rows

    # GT size validity in chip-scaled pixels (the reference's srange)
    gt_area = torch.sqrt((gt[..., 2] - gt[..., 0]).clamp_min(0.0)
                         * (gt[..., 3] - gt[..., 1]).clamp_min(0.0))
    gt_in_range = ((gt_area >= valid_ranges[:, 0:1])
                   & (gt_area <= valid_ranges[:, 1:2]))

    cand = torch.cat([props, gt], dim=1)  # [B, P+G, 4]
    cand_is_gt = torch.cat(
        [torch.zeros(B, P, dtype=torch.bool, device=dev), gt_valid], dim=1)
    cand_live = torch.cat([prop_valid, gt_valid & gt_in_range], dim=1)

    c = cand[:, :, None, :]
    g = gt[:, None, :, :]
    iw = (torch.minimum(c[..., 2], g[..., 2])
          - torch.maximum(c[..., 0], g[..., 0]) + 1.0)
    ih = (torch.minimum(c[..., 3], g[..., 3])
          - torch.maximum(c[..., 1], g[..., 1]) + 1.0)
    inter = iw.clamp_min(0) * ih.clamp_min(0)
    area_c = (cand[..., 2] - cand[..., 0] + 1) * (cand[..., 3] - cand[..., 1] + 1)
    area_g = (gt[..., 2] - gt[..., 0] + 1) * (gt[..., 3] - gt[..., 1] + 1)
    iou = inter / (area_c[:, :, None] + area_g[:, None, :] - inter)
    iou = torch.where(gt_valid[:, None, :], iou, 0.0)

    max_iou, argmax_gt = iou.max(dim=2)  # first index of the max, as jnp
    matched_cls = torch.gather(gt_cls, 1, argmax_gt)
    matched_in_range = torch.gather(gt_in_range, 1, argmax_gt)

    is_fg = (max_iou >= fg_thresh) & cand_live & matched_in_range
    # candidates leaning on out-of-range GTs are neither fg nor bg
    iou_invalid = torch.where((gt_valid & ~gt_in_range)[:, None, :], iou,
                              0.0).amax(dim=2)
    is_bg = ((max_iou < bg_thresh_hi) & (max_iou >= bg_thresh_lo)
             & cand_live & ~cand_is_gt & (iou_invalid <= 0.3))

    fg_pri = torch.where(is_fg, fg_u, -1.0)
    bg_pri = torch.where(is_bg, bg_u, -1.0)
    max_fg = int(np.round(num_rois * fg_fraction))
    fg_p, fg_idx = _top_k(fg_pri, max_fg)
    fg_take = fg_p > 0
    n_fg = fg_take.sum(dim=1, keepdim=True)
    bg_p, bg_idx = _top_k(bg_pri, num_rois)
    bg_rank = torch.arange(num_rois, device=dev)
    bg_take = (bg_p > 0) & (bg_rank[None] < (num_rois - n_fg))

    # slots: fg first, then bg; the taken slots compacted to the front by
    # a stable sort (fg before bg), leftovers are ignore
    sel_idx = torch.cat([fg_idx, bg_idx], dim=1)
    sel_take = torch.cat([fg_take, bg_take], dim=1)
    sel_is_fg = torch.cat(
        [torch.ones(B, max_fg, dtype=torch.bool, device=dev),
         torch.zeros(B, num_rois, dtype=torch.bool, device=dev)], dim=1)
    order = torch.sort((~sel_take).to(torch.uint8), dim=1,
                       stable=True)[1][:, :num_rois]
    sel_idx = torch.gather(sel_idx, 1, order)
    sel_take = torch.gather(sel_take, 1, order)
    sel_is_fg = torch.gather(sel_is_fg, 1, order)

    rois = _gather_rows(cand, sel_idx)
    sel_gt = torch.gather(argmax_gt, 1, sel_idx)
    labels = torch.where(
        sel_take,
        torch.where(sel_is_fg, torch.gather(matched_cls, 1, sel_idx).long(),
                    0),
        -1)
    tgt = bbox_transform(rois, _gather_rows(gt, sel_gt))
    # a tensor already on the device is used as it is: a host tuple would
    # be a copy, and a copy from pageable memory waits for the stream
    tgt = ((tgt - torch.as_tensor(bbox_means, dtype=torch.float32,
                                  device=dev))
           / torch.as_tensor(bbox_stds, dtype=torch.float32, device=dev))
    fg_slot = sel_is_fg & sel_take
    w = fg_slot.float()[..., None].expand(B, num_rois, 4)
    matched_gt = torch.where(fg_slot, sel_gt, -1)
    return rois, labels, tgt * w, w.contiguous(), matched_gt


@torch.no_grad()
def multi_proposal_target(
    fg_probs, deltas, im_info, gt_boxes, valid_ranges, anchors, *,
    generator=None, priorities=None, pre_nms=6000, post_nms=300, thresh=0.7,
    min_size=0.0, num_rois=300, fg_fraction=0.25, fg_thresh=0.5,
    bg_thresh_hi=0.5, bg_thresh_lo=0.0, bbox_stds=(0.1, 0.1, 0.2, 0.2),
    bbox_means=(0.0, 0.0, 0.0, 0.0),
):
    """Fused proposal + R-CNN target op (train-time).

    fg_probs [B,A,H,W], deltas [B,4A,H,W], im_info [B,3], gt_boxes [B,G,5]
    (-1 padded, class in column 4), valid_ranges [B,2] (chip-scaled
    sqrt-area bounds). The fg and bg priorities are uniform draws from
    ``generator`` (a torch.Generator on the tensors' device), or the
    ``priorities`` pair of [B, post_nms + G] tensors when given (tests feed
    the JAX package's draws). ``bbox_stds`` and ``bbox_means`` are
    sequences or tensors of 4. Returns ProposalTargets with ``num_rois``
    rois per image."""
    boxes, _, valid = proposals(
        fg_probs, deltas, im_info, anchors, pre_nms=pre_nms,
        post_nms=post_nms, thresh=thresh, min_size=min_size)
    B = boxes.shape[0]
    n_cand = post_nms + gt_boxes.shape[1]
    if priorities is None:
        fg_u = torch.rand(B, n_cand, generator=generator,
                          device=boxes.device)
        bg_u = torch.rand(B, n_cand, generator=generator,
                          device=boxes.device)
    else:
        fg_u, bg_u = priorities
    rois, labels, tgt, w, matched = _sample_rois(
        boxes, valid, gt_boxes.float(), valid_ranges.float(), fg_u, bg_u,
        num_rois=num_rois, fg_fraction=fg_fraction, fg_thresh=fg_thresh,
        bg_thresh_hi=bg_thresh_hi, bg_thresh_lo=bg_thresh_lo,
        bbox_stds=bbox_stds, bbox_means=bbox_means)
    return ProposalTargets(_with_batch_idx(rois), labels, tgt, w, matched)
