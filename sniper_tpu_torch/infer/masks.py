"""Instance-mask post-processing: paste per-roi masks into image space
and encode COCO-style RLE.

Completes the mask branch's inference surface (the reference only
evaluates boxes for its published numbers, README.md:35-36; mask pixels
reach the user through these utilities).
"""

from __future__ import annotations

import numpy as np


def paste_mask(mask_prob, box, im_h: int, im_w: int, thresh: float = 0.5):
    """One [S,S] mask prob + its xyxy box -> full-image binary mask."""
    import cv2

    x1 = int(np.floor(box[0]))
    y1 = int(np.floor(box[1]))
    x2 = int(np.ceil(box[2])) + 1
    y2 = int(np.ceil(box[3])) + 1
    x1, y1 = max(x1, 0), max(y1, 0)
    x2, y2 = min(x2, im_w), min(y2, im_h)
    out = np.zeros((im_h, im_w), dtype=np.uint8)
    if x2 <= x1 or y2 <= y1:
        return out
    m = cv2.resize(
        np.asarray(mask_prob, np.float32), (x2 - x1, y2 - y1),
        interpolation=cv2.INTER_LINEAR,
    )
    out[y1:y2, x1:x2] = (m >= thresh).astype(np.uint8)
    return out


def binary_mask_to_rle(mask: np.ndarray) -> dict:
    """COCO uncompressed RLE: column-major run lengths starting with the
    zero-run (pycocotools 'counts' list form)."""
    m = np.asarray(mask, np.uint8)
    h, w = m.shape
    flat = m.T.reshape(-1)  # column-major (Fortran order)
    counts = []
    prev = 0
    run = 0
    for v in np.split(flat, np.where(np.diff(flat) != 0)[0] + 1):
        if len(counts) == 0 and v[0] == 1:
            counts.append(0)
        counts.append(int(len(v)))
        prev = v[0]
        run += 1
    if not counts:
        counts = [h * w]
    return {"size": [h, w], "counts": counts}


def rle_to_binary_mask(rle: dict) -> np.ndarray:
    h, w = rle["size"]
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in rle["counts"]:
        flat[pos : pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape(w, h).T


def masks_to_results(all_boxes_masks, roidb, class_to_cat_id,
                     num_classes: int, thresh: float = 0.5):
    """(dets, mask_probs) per class/image -> COCO segm results list.

    all_boxes_masks[cls][img] = (dets [N,5], masks [N,S,S]).
    """
    results = []
    for j in range(1, num_classes):
        for i, r in enumerate(roidb):
            entry = all_boxes_masks[j][i]
            if entry is None:
                continue
            dets, masks = entry
            for d, m in zip(dets, masks):
                full = paste_mask(m, d[:4], r["height"], r["width"], thresh)
                results.append({
                    "image_id": int(r.get("im_id", i)),
                    "category_id": int(class_to_cat_id[j]),
                    "segmentation": binary_mask_to_rle(full),
                    "score": float(d[4]),
                })
    return results
