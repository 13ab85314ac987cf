"""roidb-level bbox regression targets + mean/std normalization.

A jax-free copy of sniper_tpu/data/bbox_regression.py, whose module reaches
jax through sniper_tpu.ops. Only the imports differ, and
``expand_bbox_regression_targets``, which no caller uses, is left out.

Rebuild of reference lib/bbox/bbox_regression.py:19-137. In the
e2e SNIPER path the per-roi targets are produced in-graph by
multi_proposal_target with config BBOX_MEANS/BBOX_STDS; this module
supplies the reference's roidb-level path — used for proposal-based
training and, when ``TRAIN.BBOX_NORMALIZATION_PRECOMPUTED`` is False,
to *measure* the empirical target statistics which then replace the
config constants (see main_train).

Semantics preserved:
- targets are computed for every roi with max_overlap >=
  BBOX_REGRESSION_THRESH against its max-IoU ground-truth roi
  (rows with overlap == 1),
- empirical means/stds are per-class accumulations of the target sums
  and squared sums over the whole roidb (class-agnostic: every fg roi
  counts toward one shared "fg" row),
- targets are normalized in place, (x - mean) / std.
"""

from __future__ import annotations

import numpy as np

from sniper_tpu_torch.ops.boxes import bbox_overlaps, bbox_transform


def compute_bbox_regression_targets(rois, overlaps, labels, thresh):
    """Per-roi [class, dx, dy, dw, dh] targets (reference :19-53).

    rois [k,4], overlaps [k] (max IoU with GT; GTs have exactly 1.0),
    labels [k] (max-overlap class). Rois under ``thresh`` get all-zero
    rows (class 0 = no regression)."""
    rois = np.asarray(rois, np.float64)
    overlaps = np.asarray(overlaps).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    targets = np.zeros((rois.shape[0], 5), dtype=np.float32)

    gt_inds = np.where(overlaps == 1)[0]
    ex_inds = np.where(overlaps >= thresh)[0]
    if gt_inds.size == 0 or ex_inds.size == 0:
        return targets

    ex_gt_overlaps = bbox_overlaps(rois[ex_inds], rois[gt_inds])
    gt_assignment = ex_gt_overlaps.argmax(axis=1)
    targets[ex_inds, 0] = labels[ex_inds]
    targets[ex_inds, 1:] = bbox_transform(
        rois[ex_inds], rois[gt_inds[gt_assignment]]
    )
    return targets


def add_bbox_regression_targets(roidb, cfg):
    """Add ``bbox_targets`` to every roidb entry and normalize them.

    Returns (means, stds) raveled over [num_classes, 4] like the
    reference (:56-113). num_classes is 2 when CLASS_AGNOSTIC."""
    assert len(roidb) > 0 and "max_classes" in roidb[0]
    agnostic = bool(cfg.CLASS_AGNOSTIC)
    num_classes = 2 if agnostic else roidb[0]["gt_overlaps"].shape[1]
    thresh = cfg.TRAIN.BBOX_REGRESSION_THRESH

    for r in roidb:
        r["bbox_targets"] = compute_bbox_regression_targets(
            r["boxes"], r["max_overlaps"], r["max_classes"], thresh
        )

    if cfg.TRAIN.BBOX_NORMALIZATION_PRECOMPUTED:
        means = np.tile(np.asarray(cfg.TRAIN.BBOX_MEANS, np.float64),
                        (num_classes, 1))
        stds = np.tile(np.asarray(cfg.TRAIN.BBOX_STDS, np.float64),
                       (num_classes, 1))
    else:
        counts = np.zeros((num_classes, 1)) + 1e-14
        sums = np.zeros((num_classes, 4))
        sq_sums = np.zeros((num_classes, 4))
        for r in roidb:
            t = r["bbox_targets"]
            fg = t[:, 0] > 0
            if not fg.any():
                continue
            # class-agnostic: one shared fg row (index 1); otherwise the
            # roi's own class row — vectorized np.add.at accumulation
            cls = np.ones(int(fg.sum()), np.intp) if agnostic else \
                t[fg, 0].astype(np.intp)
            np.add.at(counts, (cls, 0), 1)
            np.add.at(sums, cls, t[fg, 1:])
            np.add.at(sq_sums, cls, t[fg, 1:] ** 2)
        means = sums / counts
        stds = np.sqrt(np.maximum(sq_sums / counts - means**2, 0.0))

    # normalize in place, per class (agnostic: all fg rows share row 1)
    for r in roidb:
        t = r["bbox_targets"]
        fg = np.where(t[:, 0] > 0)[0]
        if fg.size == 0:
            continue
        cls = np.ones(fg.size, np.intp) if agnostic else \
            t[fg, 0].astype(np.intp)
        t[fg, 1:] = (t[fg, 1:] - means[cls]) / np.maximum(stds[cls], 1e-12)

    return means.ravel(), stds.ravel()
