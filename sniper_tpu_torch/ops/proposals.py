"""RPN proposal op for inference: decode -> clip -> min-size filter ->
top-k -> greedy NMS -> a fixed ``post_nms`` rois per image.

Port of sniper_tpu/ops/proposals.py:80-126 (``multi_proposal``), batched
over images with explicit tensor ops in place of ``jax.vmap``. The top-k
keeps ``lax.top_k``'s tie order (lower index first). The NMS is
``ops.nms.nms``: the CUDA kernel for CUDA tensors, the plain version on the
CPU.
"""

from __future__ import annotations

import torch

from sniper_tpu_torch.ops.boxes import bbox_pred, clip_boxes
from sniper_tpu_torch.ops.nms import NEG_INF, nms


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


def multi_proposal(fg_probs, deltas, im_info, anchors, *, pre_nms=6000,
                   post_nms=300, thresh=0.7, min_size=0.0):
    """fg_probs [B,A,H,W], deltas [B,4A,H,W], im_info [B,3] (h, w, scale),
    anchors [A*H*W, 4] in (A,H,W) order. Returns rois [B, post_nms, 5]
    (batch idx + xyxy, zeros where not valid), scores [B, post_nms] and
    valid [B, post_nms] bool."""
    props, scores = _decode(fg_probs, deltas, im_info, anchors, min_size)
    B, N = scores.shape
    k = min(pre_nms, N)
    # lax.top_k's order: descending, the lower index first among ties (a
    # random RPN saturates many scores at exactly 1.0); torch.topk leaves
    # the tie order unspecified, a stable sort does not
    top_scores, top_idx = torch.sort(scores, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    top_props = torch.gather(props, 1, top_idx[..., None].expand(B, k, 4))
    keep, valid = nms(top_props.contiguous(), top_scores.contiguous(),
                      post_nms, thresh)
    safe = keep.clamp_min(0).long()
    rois = torch.where(
        valid[..., None],
        torch.gather(top_props, 1, safe[..., None].expand(B, post_nms, 4)),
        0.0)
    roi_scores = torch.where(valid, torch.gather(top_scores, 1, safe), 0.0)
    batch_idx = torch.arange(B, dtype=rois.dtype, device=rois.device)
    batch_idx = batch_idx[:, None, None].expand(B, post_nms, 1)
    return torch.cat([batch_idx, rois], dim=-1), roi_scores, valid
