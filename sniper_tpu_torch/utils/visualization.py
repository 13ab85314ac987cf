"""Detection and training-chip rendering with OpenCV (headless).

A copy of sniper_tpu/utils/visualization.py (the reference's
lib/data_utils/visualization.py, matplotlib there): ``draw_detections``
for the demo and the training prediction dumps, ``save_training_chip`` for
the chip loader's TRAIN.VISUALIZE renderings. The images are the JAX
package's, pixel for pixel.
"""

from __future__ import annotations

import os

import numpy as np


def draw_detections(im_rgb, all_cls_dets, class_names=None, threshold=0.5):
    """im_rgb uint8 [H,W,3]; all_cls_dets: a list over classes (index 0,
    the background, is skipped) of [N,5] detections. Returns an annotated
    copy: each class's boxes at or above ``threshold`` in its own colour
    (a RandomState(7) palette), labelled with the class name (or index) and
    the score."""
    import cv2

    out = np.ascontiguousarray(im_rgb).copy()
    rng = np.random.RandomState(7)
    colors = rng.randint(0, 255, (max(len(all_cls_dets), 2), 3))
    for j, dets in enumerate(all_cls_dets):
        if j == 0 or dets is None or len(dets) == 0:
            continue
        color = tuple(int(c) for c in colors[j])
        for d in dets:
            if d[4] < threshold:
                continue
            x1, y1, x2, y2 = (int(v) for v in d[:4])
            cv2.rectangle(out, (x1, y1), (x2, y2), color, 2)
            name = class_names[j] if class_names else str(j)
            cv2.putText(
                out, f"{name} {d[4]:.2f}", (x1, max(y1 - 4, 10)),
                cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1, cv2.LINE_AA,
            )
    return out


def save_training_chip(sample, pixel_means, path):
    """Render one chip loader sample, the chip with its GT boxes in green
    and their class indices (the reference's MNIteratorE2E.visualize,
    MNIteratorE2E.py:222-243), to ``path``; returns ``path``.

    uint8 RGB data (the loader's) is drawn as it is; fp32 data, RGB with
    the BGR-ordered PIXEL_MEANS subtracted reversed, gets them added back.
    gt_boxes rows are [x1, y1, x2, y2, class] with -1 padding."""
    import cv2

    data = np.asarray(sample["data"])
    if data.dtype == np.uint8:
        im = data.copy()
    else:
        im = np.clip(
            data + np.asarray(pixel_means, np.float32)[::-1], 0, 255
        ).astype(np.uint8)
    boxes = np.asarray(sample["gt_boxes"])
    valid = boxes[:, 4] >= 0
    for x1, y1, x2, y2, c in boxes[valid]:
        cv2.rectangle(im, (int(x1), int(y1)), (int(x2), int(y2)),
                      (0, 255, 0), 2)
        cv2.putText(im, str(int(c)), (int(x1), max(int(y1) - 4, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1,
                    cv2.LINE_AA)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2.imwrite(path, cv2.cvtColor(im, cv2.COLOR_RGB2BGR))
    return path
