"""Box-list helpers (reference lib/dataset/ds_utils.py)."""

from __future__ import annotations

import numpy as np


def unique_boxes(boxes, scale=1.0):
    """Indices of unique (up to scale-quantization) boxes."""
    v = np.array([1, 1e3, 1e6, 1e9])
    hashes = np.round(boxes * scale).dot(v)
    _, index = np.unique(hashes, return_index=True)
    return np.sort(index)


def filter_small_boxes(boxes, min_size):
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    return np.where((w >= min_size) & (h >= min_size))[0]
