"""Chip extraction per pyramid scale + box-to-chip assignment + neg mining.

A jax-free copy of sniper_tpu/chips/assigner.py, whose module reaches
jax through sniper_tpu.ops; only the imports differ.

Re-derivation of the reference chip_worker
(reference lib/data_utils/data_workers.py:374-594) with the
per-box Python loops replaced by vectorized NumPy. Semantics preserved
exactly, including the reference's asymmetries (they affect which samples
the model sees and therefore parity):

- chip_extractor scale-validity (``:455-466``): finest scale has no lower
  area bound but requires w,h >= 2; intermediate scales bound area on both
  sides; coarsest only from below; non-coarsest scales also require
  max_side < (chip_size - stride - 1) / im_scale.
- box_assigner validity (``:506-512``) differs from chip_extractor: ALL
  non-coarsest scales use the finest-style test (area < hi, no lower
  bound, w,h >= 2).
- assignment (``:514-535``): each valid box goes to its max-ignore-overlap
  chip of that scale, then is accepted ("covered") only if the
  intersection has both sides >= 1 and sqrt(|inter area|) is <= hi
  (non-coarsest) / >= lo (coarsest). The neg-chip variant (``:556-572``)
  uses a strict < hi.
- neg mining (``:536-549,574-588``): chips are generated over the
  still-uncovered valid boxes per scale; a neg chip is kept if it holds
  > 25 proposals, or > 10 at any scale other than the finest.

Intersection side lengths here use raw differences (x2-x1), not the
legacy +1 — matching the reference's assignment check, which differs from
its own overlap kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from sniper_tpu_torch.chips.generator import ChipGenerator, compute_im_scales
from sniper_tpu_torch.ops.boxes import ignore_overlaps


class Chip(NamedTuple):
    """One training chip: crop window in image coords + its pyramid scale.

    Mirrors the reference's 5-list [box, im_scale, out_h, out_w, scale_idx]
    (data_workers.py:444-449). out_h/out_w are the post-resize pixel dims:
    chip_size x chip_size except at the coarsest scale, where the chip is
    the whole scaled image.
    """

    box: np.ndarray  # [4] xyxy, image coords (unscaled)
    im_scale: float
    out_h: int
    out_w: int
    scale_idx: int


def _valid_mask_extractor(area, ms, ws, hs, scale_i, n_scales, valid_ranges,
                          chip_size, chip_stride, im_scale):
    """chip_extractor's per-scale GT validity (data_workers.py:455-466)."""
    lo, hi = valid_ranges[scale_i]
    if scale_i == n_scales - 1:
        return area >= lo
    fits = ms < (chip_size - chip_stride - 1) / im_scale
    if scale_i == 0:
        return (area < hi) & fits & (ws >= 2) & (hs >= 2)
    return (area >= lo) & (area < hi) & fits


def _valid_mask_assigner(area, ms, ws, hs, scale_i, n_scales, valid_ranges,
                         chip_size, chip_stride, im_scale):
    """box_assigner's per-scale validity (data_workers.py:506-512)."""
    lo, hi = valid_ranges[scale_i]
    if scale_i == n_scales - 1:
        return area >= lo
    fits = ms < (chip_size - chip_stride - 1) / im_scale
    return (area < hi) & fits & (ws >= 2) & (hs >= 2)


def _box_stats(boxes):
    ws = (boxes[:, 2] - boxes[:, 0]).astype(np.int32)
    hs = (boxes[:, 3] - boxes[:, 1]).astype(np.int32)
    area = np.sqrt(ws * hs)
    ms = np.maximum(ws, hs)
    return ws, hs, area, ms


def extract_chips(r: dict, scales, valid_ranges, chip_size: int,
                  gen: ChipGenerator) -> list[Chip]:
    """Positive chips for one image record (needs width/height/boxes/
    max_overlaps). GTs are rows with max_overlaps == 1."""
    width, height = r["width"], r["height"]
    gt_boxes = r["boxes"][np.where(r["max_overlaps"] == 1)[0], :].astype(np.float64)
    ws, hs, area, ms = _box_stats(gt_boxes)
    im_scales = compute_im_scales(width, height, scales)
    n_scales = len(scales)

    chips: list[Chip] = []
    for i, im_scale in enumerate(im_scales):
        mask = _valid_mask_extractor(
            area, ms, ws, hs, i, n_scales, valid_ranges, chip_size,
            gen.chip_stride, im_scale,
        )
        cur = gen.generate(
            gt_boxes[mask] * im_scale,
            int(width * im_scale),
            int(height * im_scale),
            chip_size,
        )
        for chip in cur:
            box = np.asarray(chip, dtype=np.float64) / im_scale
            if i != n_scales - 1:
                chips.append(Chip(box, im_scale, chip_size, chip_size, i))
            else:
                chips.append(
                    Chip(box, im_scale, int(height * im_scale), int(width * im_scale), i)
                )
    return chips


def _assign_to_chips(chips_arr, chip_ids, boxes, box_ids, scale_i, n_scales,
                     valid_ranges, props_in_chips, covered=None,
                     strict_hi=False):
    """Vectorized max-overlap assignment with intersection validity check.

    For every box, pick its argmax-ignore-overlap chip, then accept iff
    the intersection has both sides >= 1 and sqrt(|area|) passes the
    scale's range test. Appends accepted box ids into props_in_chips and
    flags ``covered``.
    """
    if chips_arr.shape[0] == 0 or boxes.shape[0] == 0:
        return
    ov = ignore_overlaps(chips_arr, boxes)  # [C, N]
    max_ids = ov.argmax(axis=0)  # [N]
    ch = chips_arr[max_ids]  # [N, 4]
    x1 = np.maximum(ch[:, 0], boxes[:, 0])
    x2 = np.minimum(ch[:, 2], boxes[:, 2])
    y1 = np.maximum(ch[:, 1], boxes[:, 1])
    y2 = np.minimum(ch[:, 3], boxes[:, 3])
    inter_area = np.sqrt(np.abs((x2 - x1) * (y2 - y1)))
    sides_ok = (x2 - x1 >= 1) & (y2 - y1 >= 1)
    lo, hi = valid_ranges[scale_i]
    if scale_i == n_scales - 1:
        ok = sides_ok & (inter_area >= lo)
    elif strict_hi:
        ok = sides_ok & (inter_area < hi)
    else:
        ok = sides_ok & (inter_area <= hi)
    for pi in np.where(ok)[0]:
        props_in_chips[chip_ids[max_ids[pi]]].append(box_ids[pi])
        if covered is not None:
            covered[pi] = True


def assign_boxes(r: dict, scales, valid_ranges, chip_size: int,
                 gen: ChipGenerator, use_neg_chips: bool):
    """Assign all boxes (GT + proposals) to chips; mine negative chips.

    ``r['crops']`` must hold the Chip list from extract_chips. Returns
    (props_in_chips, neg_chips, neg_props_in_chips); the latter two are
    ([], []) when use_neg_chips is False. Also writes r['neg_chips'] /
    r['neg_props_in_chips'] like the reference.
    """
    width, height = r["width"], r["height"]
    boxes = r["boxes"].astype(np.float64)
    ws, hs, area, ms = _box_stats(boxes)
    im_scales = compute_im_scales(width, height, scales)
    n_scales = len(scales)
    crops = r["crops"]

    props_in_chips: list[list[int]] = [[] for _ in crops]

    # group positive chips by scale
    per_scale_chips = [[] for _ in range(n_scales)]
    per_scale_ids = [[] for _ in range(n_scales)]
    for ci, crop in enumerate(crops):
        per_scale_chips[crop.scale_idx].append(crop.box)
        per_scale_ids[crop.scale_idx].append(ci)

    valid_ids, valid_boxes, covered = [], [], []
    for i, im_scale in enumerate(im_scales):
        mask = _valid_mask_assigner(
            area, ms, ws, hs, i, n_scales, valid_ranges, chip_size,
            gen.chip_stride, im_scale,
        )
        ids = np.where(mask)[0]
        valid_ids.append(ids)
        valid_boxes.append(boxes[ids])
        covered.append(np.zeros(ids.shape[0], dtype=bool))

    for i in range(n_scales):
        _assign_to_chips(
            np.asarray(per_scale_chips[i], dtype=np.float64).reshape(-1, 4),
            np.asarray(per_scale_ids[i], dtype=np.int64),
            valid_boxes[i], valid_ids[i], i, n_scales, valid_ranges,
            props_in_chips, covered=covered[i], strict_hi=False,
        )

    neg_chips_out: list[Chip] = []
    neg_props_out: list[np.ndarray] = []
    if use_neg_chips:
        rem_boxes = [valid_boxes[i][~covered[i]] for i in range(n_scales)]
        rem_ids = [valid_ids[i][~covered[i]] for i in range(n_scales)]
        neg_chips, neg_props, neg_cids = [], [], []
        next_id = 0
        for i, im_scale in enumerate(im_scales):
            cur = gen.generate(
                rem_boxes[i] * im_scale,
                int(width * im_scale),
                int(height * im_scale),
                chip_size,
            )
            arr = (
                np.asarray(cur, dtype=np.float64).reshape(-1, 4) / im_scale
                if len(cur)
                else np.zeros((0, 4))
            )
            neg_chips.append(arr)
            neg_props += [[] for _ in range(arr.shape[0])]
            neg_cids.append(np.arange(next_id, next_id + arr.shape[0]))
            next_id += arr.shape[0]

        for i in range(n_scales):
            _assign_to_chips(
                neg_chips[i], neg_cids[i], rem_boxes[i], rem_ids[i], i,
                n_scales, valid_ranges, neg_props, covered=None, strict_hi=True,
            )

        counter = 0
        for i, arr in enumerate(neg_chips):
            im_scale = im_scales[i]
            for chip in arr:
                n_props = len(neg_props[counter])
                if n_props > 25 or (n_props > 10 and i != 0):
                    neg_props_out.append(np.array(neg_props[counter], dtype=int))
                    if i != n_scales - 1:
                        neg_chips_out.append(Chip(chip, im_scale, chip_size, chip_size, i))
                    else:
                        neg_chips_out.append(
                            Chip(chip, im_scale, int(height * im_scale),
                                 int(width * im_scale), i)
                        )
                counter += 1

        r["neg_chips"] = neg_chips_out
        r["neg_props_in_chips"] = neg_props_out

    return (
        [np.array(p, dtype=np.int32) for p in props_in_chips],
        neg_chips_out,
        neg_props_out,
    )
