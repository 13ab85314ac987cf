"""Per-chip RPN target assignment (SNIPER scale-validity aware).

A jax-free copy of sniper_tpu/data/anchor_targets.py, whose module reaches
jax through sniper_tpu.ops, in its sparse form: the training loader ships
(pid, value) pairs, and the loss gathers the predictions at the pids; with
``AutoFocusParams``, also the FocusPixel labels of the chip (``_focus_map``,
the reference's gen_mask). The dense target grids of the JAX copy have no
reader in the port.

Re-derivation of the reference anchor_worker
(reference lib/data_utils/data_workers.py:132-371) as a single
vectorized NumPy function with static-shape outputs.

SNIPER semantics preserved:
- anchors participate only within ±``allowed_border`` px of the chip
  canvas (reference hardcodes 32),
- GTs are shifted into chip coords, scaled, rounded, clipped to the
  square chip canvas, and dropped when min side < 10 px,
- GTs *valid for this chip's scale range* (ids in ``nids`` ∩ ``gtids``)
  are positives; remaining ("invalid") GTs poison anchors: any anchor
  with IoU > 0.3 against an invalid GT is ignored (label -1) — this is
  how SNIPER avoids training on out-of-range objects,
- labels: bg where max IoU < neg_thresh, fg for per-GT argmax anchors
  (with ties) and anchors above pos_thresh, applied in that order,
- random fg/bg subsampling to RPN_BATCH_SIZE with RPN_FG_FRACTION,
- regression targets for every in-border anchor toward its argmax GT,
  weighted only at fg anchors,
- padded GT output [max_n_gts, 5] filled -1,
- AutoFocus: each rounded, clipped GT box (before the min-size filter, in
  the roidb's order, later boxes painting over earlier ones) marks its
  stride-16 cells 1 when sqrt(area) lies in (dc_low, small_thresh), -1
  (don't care) in [small_thresh, dc_high) or at most dc_low; other cells
  stay 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from sniper_tpu_torch.ops.anchors import generate_anchors, shift_anchors
from sniper_tpu_torch.ops.boxes import (
    bbox_overlaps,
    bbox_transform,
    clip_boxes,
    filter_boxes_mask,
)


class AnchorTargets(NamedTuple):
    gt_boxes: np.ndarray        # [max_n_gts, 5] float32, -1 padded
    # pids are (A,H,W)-flat anchor indices, padded -1
    rpn_pids: np.ndarray        # [rpn_batch_size] int32
    rpn_label_vals: np.ndarray  # [rpn_batch_size] float32, {0, 1}, -1 pad
    fg_pids: np.ndarray         # [num_fg] int32
    fg_targets: np.ndarray      # [num_fg, 4] float32
    gt_keep: np.ndarray         # indices into gtids of the kept GT rows
    focus_label: np.ndarray | None = None  # [H*W] float32 in {-1, 0, 1}


class AutoFocusParams(NamedTuple):
    small_thresh: float
    dc_low: float
    dc_high: float


class AnchorTargetAssigner:
    def __init__(
        self,
        chip_size: int,
        anchor_scales=(8, 16, 32),
        anchor_ratios=(0.5, 1, 2),
        feat_stride: int = 16,
        rpn_batch_size: int = 256,
        fg_fraction: float = 0.5,
        pos_thresh: float = 0.7,
        neg_thresh: float = 0.3,
        allowed_border: int = 32,
        invalid_thresh: float = 0.3,
        min_gt_size: float = 10.0,
        max_n_gts: int = 100,
        autofocus: AutoFocusParams | None = None,
    ):
        self.feat_stride = feat_stride
        self.feat_h = chip_size // feat_stride
        self.feat_w = chip_size // feat_stride
        self.chip_size = chip_size
        base = generate_anchors(feat_stride, list(anchor_ratios), list(anchor_scales))
        self.num_anchors = base.shape[0]
        self.all_anchors = shift_anchors(base, self.feat_h, self.feat_w, feat_stride)
        self.rpn_batch_size = rpn_batch_size
        self.num_fg = int(rpn_batch_size * fg_fraction)
        self.pos_thresh = pos_thresh
        self.neg_thresh = neg_thresh
        self.allowed_border = allowed_border
        self.invalid_thresh = invalid_thresh
        self.min_gt_size = min_gt_size
        self.max_n_gts = max_n_gts
        self.autofocus = autofocus
        # in-border mask depends only on the (fixed, square) canvas
        a = self.all_anchors
        self.inside_mask = (
            (a[:, 0] >= -allowed_border)
            & (a[:, 1] >= -allowed_border)
            & (a[:, 2] < chip_size + allowed_border)
            & (a[:, 3] < chip_size + allowed_border)
        )
        self.inside_idx = np.where(self.inside_mask)[0]
        self.inside_anchors = a[self.inside_idx]

    def _focus_map(self, gt_boxes: np.ndarray) -> np.ndarray:
        """FocusPixel GT painting (reference gen_mask, :164-192)."""
        af = self.autofocus
        fh, fw = self.feat_h, self.feat_w
        cmask = np.zeros((fh, fw), dtype=np.float32)
        s = float(self.feat_stride)
        for b in gt_boxes:
            area = np.sqrt((b[2] - b[0]) * (b[3] - b[1]))
            if af.dc_low < area < af.small_thresh:
                flag = 1.0
            elif (af.small_thresh <= area < af.dc_high) or area <= af.dc_low:
                flag = -1.0
            else:
                continue
            x1, y1 = int(b[0] / s), int(b[1] / s)
            x2 = min(int(np.ceil(b[2] / s)) + 1, fw)
            y2 = min(int(np.ceil(b[3] / s)) + 1, fh)
            cmask[y1:y2, x1:x2] = flag
        return cmask.reshape(-1)

    def __call__(
        self,
        cur_crop: np.ndarray,
        im_scale: float,
        nids: np.ndarray,
        gtids: np.ndarray,
        boxes: np.ndarray,
        classes: np.ndarray,
        rng: np.random.RandomState,
    ) -> AnchorTargets:
        """Assign RPN targets for one chip.

        cur_crop: chip window [4] in image coords; nids: box ids valid in
        this chip (props_in_chips entry); gtids: GT row ids in ``boxes``;
        classes: per-GT class ids aligned with gtids.
        """
        canvas = (self.chip_size, self.chip_size)
        gt_boxes = boxes[gtids].astype(np.float64).copy()
        offset = np.array([cur_crop[0], cur_crop[1], cur_crop[0], cur_crop[1]])
        gt_boxes -= offset
        vgt_boxes = boxes[np.intersect1d(gtids, nids)].astype(np.float64) - offset

        gt_boxes = clip_boxes(np.round(gt_boxes * im_scale), canvas)
        vgt_boxes = clip_boxes(np.round(vgt_boxes * im_scale), canvas)

        focus = self._focus_map(gt_boxes) if self.autofocus else None

        keep = filter_boxes_mask(gt_boxes, self.min_gt_size)
        gt_keep = np.where(keep)[0]
        gt_boxes = gt_boxes[keep]
        cls = np.asarray(classes, dtype=np.float64).reshape(-1)[keep]
        agt_boxes = gt_boxes.copy()

        vkeep = filter_boxes_mask(vgt_boxes, self.min_gt_size)
        vgt_boxes = vgt_boxes[vkeep]

        # split chip GTs into valid (exactly matching a scale-valid GT) vs
        # invalid (present in the chip but out of scale range)
        if len(vgt_boxes) > 0 and len(gt_boxes) > 0:
            mov = bbox_overlaps(gt_boxes, vgt_boxes).max(axis=1)
        else:
            mov = np.zeros(len(gt_boxes))
        invalid_boxes = gt_boxes[mov < 1]
        gt_boxes = gt_boxes[mov == 1]

        n_in = len(self.inside_idx)
        labels = np.full(n_in, -1.0, dtype=np.float64)
        anchors = self.inside_anchors

        argmax_overlaps = np.zeros(n_in, dtype=np.int64)
        if gt_boxes.size > 0:
            overlaps = bbox_overlaps(anchors, gt_boxes)
            argmax_overlaps = overlaps.argmax(axis=1)
            max_overlaps = overlaps[np.arange(n_in), argmax_overlaps]
            gt_max = overlaps.max(axis=0)
            gt_argmax = np.where(overlaps == gt_max)[0]  # ties included
            labels[max_overlaps < self.neg_thresh] = 0
            labels[gt_argmax] = 1
            labels[max_overlaps >= self.pos_thresh] = 1
        else:
            labels[:] = 0
        if len(invalid_boxes) > 0:
            movn = bbox_overlaps(anchors, invalid_boxes).max(axis=1)
            labels[movn > self.invalid_thresh] = -1

        # subsample fg then bg to the RPN batch size
        fg_inds = np.where(labels == 1)[0]
        if len(fg_inds) > self.num_fg:
            labels[rng.choice(fg_inds, len(fg_inds) - self.num_fg, replace=False)] = -1
        num_bg = self.rpn_batch_size - int(np.sum(labels == 1))
        bg_inds = np.where(labels == 0)[0]
        if len(bg_inds) > num_bg:
            labels[rng.choice(bg_inds, len(bg_inds) - num_bg, replace=False)] = -1

        fh, fw, A = self.feat_h, self.feat_w, self.num_anchors
        fgt = np.full((self.max_n_gts, 5), -1.0, dtype=np.float32)
        n = min(len(agt_boxes), self.max_n_gts)
        if n > 0:
            fgt[:n, :4] = agt_boxes[:n]
            fgt[:n, 4] = cls[:n]

        # (A,H,W)-flat pid for full-grid (h,w,a)-flat index g:
        # j = a * (fh*fw) + (h*fw + w)
        def to_awh(g):
            return ((g % A) * (fh * fw) + g // A).astype(np.int32)

        sampled = np.where(labels >= 0)[0]
        pids = np.full(self.rpn_batch_size, -1, np.int32)
        vals = np.full(self.rpn_batch_size, -1.0, np.float32)
        pids[: len(sampled)] = to_awh(self.inside_idx[sampled])
        vals[: len(sampled)] = labels[sampled]
        fg = np.where(labels == 1)[0]
        fpids = np.full(self.num_fg, -1, np.int32)
        ftgts = np.zeros((self.num_fg, 4), np.float32)
        fpids[: len(fg)] = to_awh(self.inside_idx[fg])
        if len(fg) > 0 and gt_boxes.size > 0:
            ftgts[: len(fg)] = bbox_transform(
                anchors[fg], gt_boxes[argmax_overlaps[fg]]
            )
        return AnchorTargets(fgt, pids, vals, fpids, ftgts, gt_keep, focus)
