"""roidb schema + manipulation: flipping, merging, filtering, proposals.

A jax-free copy of sniper_tpu/data/roidb.py, whose module reaches
jax through sniper_tpu.ops. Only the imports differ, and what no caller
of the port uses is left out: ``remove_small_boxes`` and
``evaluate_recall``.

Rebuild of the reference IMDB roidb machinery
(reference lib/dataset/imdb.py:81-272,398-419 and
lib/data_utils/load_data.py:23-107). A roidb entry is a dict:

  image     path (or any key the image_loader understands)
  height, width
  boxes         [N,4] float32 xyxy (gt first when merged with proposals)
  gt_classes    [N] int32 (0 for proposals/bg)
  gt_overlaps   [N,C] float32 (1.0 at the gt class; -1 rows for crowd)
  max_classes   [N] argmax of gt_overlaps
  max_overlaps  [N] max of gt_overlaps  (== 1 identifies true GTs)
  flipped       bool
  [proposal_scores] optional

The SNIPER invariant used downstream: rows with max_overlaps == 1 are
ground truth; everything else is a proposal (chip_worker
data_workers.py:394 relies on it).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from sniper_tpu_torch.ops.boxes import bbox_overlaps
from sniper_tpu_torch.ops.nms import nms_np


def append_flipped_images(roidb):
    """Double the roidb with horizontally flipped copies (imdb.py:214-272)."""
    flipped = []
    for r in roidb:
        boxes = r["boxes"].copy()
        oldx1 = boxes[:, 0].copy()
        oldx2 = boxes[:, 2].copy()
        boxes[:, 0] = r["width"] - oldx2 - 1
        boxes[:, 2] = r["width"] - oldx1 - 1
        assert (boxes[:, 2] >= boxes[:, 0]).all()
        e = dict(r)
        e["boxes"] = boxes
        e["flipped"] = True
        if "gt_masks" in r:
            e["gt_masks"] = [
                [_flip_poly(p, r["width"]) for p in polys]
                for polys in r["gt_masks"]
            ]
        flipped.append(e)
    return roidb + flipped


def _flip_poly(poly, width):
    p = np.asarray(poly, dtype=np.float32).copy()
    p[0::2] = width - p[0::2] - 1
    return p


def compute_overlap_fields(boxes, gt_boxes, gt_classes, num_classes):
    """gt_overlaps/max_classes/max_overlaps for a proposal box list
    against GTs (imdb.create_roidb_from_box_list, imdb.py:145-204)."""
    n = boxes.shape[0]
    overlaps = np.zeros((n, num_classes), dtype=np.float32)
    if gt_boxes.size > 0 and n > 0:
        ov = bbox_overlaps(
            boxes.astype(np.float64), gt_boxes.astype(np.float64)
        )
        argmax = ov.argmax(axis=1)
        maxes = ov.max(axis=1)
        pos = np.where(maxes > 0)[0]
        overlaps[pos, gt_classes[argmax[pos]]] = maxes[pos]
    return {
        "gt_overlaps": overlaps,
        "max_classes": overlaps.argmax(axis=1),
        "max_overlaps": overlaps.max(axis=1),
    }


def merge_gt_and_proposals(gt_roidb_entry, boxes, scores=None,
                           num_classes=81):
    """One image's GT entry + proposal boxes -> merged entry
    (imdb.merge_roidbs semantics: vstack fields, GT rows first)."""
    r = gt_roidb_entry
    fields = compute_overlap_fields(
        boxes, r["boxes"], r["gt_classes"], num_classes
    )
    out = dict(r)
    out["boxes"] = np.vstack([r["boxes"], boxes]).astype(np.float32)
    out["gt_classes"] = np.concatenate(
        [r["gt_classes"], np.zeros(len(boxes), dtype=r["gt_classes"].dtype)]
    )
    out["gt_overlaps"] = np.vstack([r["gt_overlaps"], fields["gt_overlaps"]])
    out["max_classes"] = np.concatenate(
        [r["max_classes"], fields["max_classes"]]
    )
    out["max_overlaps"] = np.concatenate(
        [r["max_overlaps"], fields["max_overlaps"]]
    )
    if scores is not None:
        out["proposal_scores"] = np.concatenate(
            [np.ones(len(r["boxes"]), np.float32), scores.reshape(-1)]
        )
    return out


def load_rpn_proposals(pkl_path, roidb, num_classes, nms_thresh=0.7,
                       top_k=-1, use_cache=True):
    """Attach RPN proposal boxes from a pickle (imdb.load_rpn_data,
    imdb.py:81-118): {'boxes': [per-image [N,5] xyxy+score]} or a list.
    Proposals get NMS'd at 0.7 before merging.

    The per-image NMS of a large proposal file is the expensive part
    (the reference burns a Pool(32) on it and caches the result,
    imdb.py:83-117); here the post-NMS dets are cached next to the
    proposal pkl, keyed by the source file's (size, mtime) and the NMS
    params, so re-runs skip straight to the merge."""
    with open(pkl_path, "rb") as f:
        data = pickle.load(f)
    box_list = data["boxes"] if isinstance(data, dict) else data
    assert len(box_list) >= len(roidb), "proposal file shorter than roidb"

    st = os.stat(pkl_path)
    # mtime at ns resolution: a regenerated pkl is usually byte-identical
    # in SIZE (same shapes, new values), and whole-second mtimes collide
    # when the rewrite lands within the old file's second
    cache_key = (int(st.st_size), int(st.st_mtime_ns), float(nms_thresh),
                 int(top_k), len(roidb))
    # filename carries the full validity key (not just nms_thresh):
    # callers differing in top_k or roidb subset would otherwise share
    # one file and alternately overwrite it (correct, but thrashing)
    cache_path = (f"{pkl_path}.nms_{nms_thresh:g}"
                  f".top{top_k}.n{len(roidb)}.pkl")
    nmsed = None
    if use_cache and os.path.exists(cache_path):
        with open(cache_path, "rb") as f:
            cached = pickle.load(f)
        if cached.get("key") == cache_key:
            nmsed = cached["dets"]

    if nmsed is None:
        nmsed = []
        for dets in box_list[:len(roidb)]:
            dets = np.asarray(dets, dtype=np.float32)
            if dets.ndim == 2 and dets.shape[0] and dets.shape[1] == 5:
                keep = nms_np(dets, nms_thresh)
                dets = dets[keep]
            if top_k > 0 and dets.ndim == 2:
                dets = dets[:top_k]
            nmsed.append(dets)
        if use_cache:
            tmp = f"{cache_path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump({"key": cache_key, "dets": nmsed}, f)
            os.replace(tmp, cache_path)

    out = []
    for r, dets in zip(roidb, nmsed):
        if dets.ndim != 2 or dets.shape[0] == 0:
            out.append(dict(r))
            continue
        if dets.shape[1] == 5:
            boxes, scores = dets[:, :4], dets[:, 4]
        else:
            boxes, scores = dets[:, :4], None
        out.append(merge_gt_and_proposals(r, boxes, scores, num_classes))
    return out


def filter_roidb(roidb, fg_thresh=0.5, bg_thresh_hi=0.5, bg_thresh_lo=0.0):
    """Drop images with neither fg nor bg rois (load_data.py:91-107)."""

    def is_valid(entry):
        overlaps = entry["max_overlaps"]
        fg = np.where(overlaps >= fg_thresh)[0]
        bg = np.where(
            (overlaps < bg_thresh_hi) & (overlaps >= bg_thresh_lo)
        )[0]
        return len(fg) > 0 or len(bg) > 0

    kept = [r for r in roidb if is_valid(r)]
    return kept
