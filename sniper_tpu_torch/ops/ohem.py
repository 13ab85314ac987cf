"""Online Hard Example Mining over the sampled rois (TRAIN.ENABLE_OHEM).

Port of sniper_tpu/ops/ohem.py:18-28 ``ohem_select``, the reference's
BoxAnnotatorOHEM op (box_annotator_ohem.py:27-78): of each image's rois,
only the ``roi_per_img`` hardest by summed classification and box loss keep
their labels and box weights; the rest become ignored (label -1, weights
0). ``torch.topk`` stands where the JAX package calls ``lax.top_k``.
"""

from __future__ import annotations

import torch


def ohem_select(cls_loss, bbox_loss, labels, bbox_weights, roi_per_img: int):
    """cls_loss [B,R], bbox_loss [B,R], labels [B,R], bbox_weights [B,R,4].
    Returns (labels, bbox_weights) with only the hardest ``roi_per_img``
    rois of each image kept.

    An invalid roi (label < 0) scores -inf. The threshold is each image's
    k-th largest score and every roi at or above it is kept, so all ties at
    the threshold survive (more than k rois may) and the order in which
    ``topk`` breaks ties cannot change the result. An image with fewer than
    k valid rois has a threshold of -inf and keeps them all. k above R
    raises ValueError, as ``lax.top_k`` refuses it."""
    r = labels.shape[-1]
    if roi_per_img > r:
        raise ValueError(f"OHEM keeps {roi_per_img} rois per image but the "
                         f"sampler gives {r} (TRAIN.BATCH_ROIS_OHEM above "
                         "TRAIN.BATCH_ROIS)")
    total = torch.where(labels >= 0, cls_loss + bbox_loss, -torch.inf)
    thresh = torch.topk(total, roi_per_img, dim=-1).values[:, -1:]
    keep = total >= thresh
    return (torch.where(keep, labels, -1),
            torch.where(keep[..., None], bbox_weights, 0.0))
