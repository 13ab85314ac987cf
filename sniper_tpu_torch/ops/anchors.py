"""Anchor generation (pure NumPy).

A copy of sniper_tpu/ops/anchors.py, which is pure NumPy but cannot be
imported without jax (sniper_tpu/ops/__init__.py imports the jax modules),
plus ``make_anchors_ahw`` from sniper_tpu/ops/proposals.py:47-56. The
classic py-faster-rcnn enumeration: a ``base_size`` square at the origin is
warped to each aspect ratio with *rounded* widths/heights, then scaled;
anchors are xyxy in the legacy +1 convention.
"""

from __future__ import annotations

import numpy as np


def _mkanchors(ws, hs, x_ctr, y_ctr):
    """Build xyxy anchors around a center from widths/heights [K]."""
    ws = ws[:, None]
    hs = hs[:, None]
    return np.hstack(
        [
            x_ctr - 0.5 * (ws - 1),
            y_ctr - 0.5 * (hs - 1),
            x_ctr + 0.5 * (ws - 1),
            y_ctr + 0.5 * (hs - 1),
        ]
    )


def generate_anchors(base_size=16, ratios=(0.5, 1, 2), scales=(8, 16, 32)):
    """[len(ratios)*len(scales), 4] anchors centered on the base cell,
    ratio-major (all scales for ratio 0, then ratio 1, ...)."""
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    base = np.array([1, 1, base_size, base_size], dtype=np.float64) - 1
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    x_ctr = base[0] + 0.5 * (w - 1)
    y_ctr = base[1] + 0.5 * (h - 1)

    size = w * h
    size_ratios = size / ratios
    ws = np.round(np.sqrt(size_ratios))  # [R]
    hs = np.round(ws * ratios)  # [R]

    ws_s = (ws[:, None] * scales[None, :]).reshape(-1)  # [R*S]
    hs_s = (hs[:, None] * scales[None, :]).reshape(-1)
    return _mkanchors(ws_s, hs_s, x_ctr, y_ctr)


def shift_anchors(base_anchors, feat_height, feat_width, feat_stride):
    """Dense grid [feat_height * feat_width * A, 4], position-major with the
    A anchors of a position contiguous."""
    a = np.asarray(base_anchors, dtype=np.float64)
    shift_x = np.arange(feat_width) * feat_stride
    shift_y = np.arange(feat_height) * feat_stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    all_anchors = a[None, :, :] + shifts[:, None, :]  # [K, A, 4]
    return all_anchors.reshape(-1, 4)


def make_anchors_ahw(feat_h: int, feat_w: int, feat_stride: int,
                     ratios, scales) -> np.ndarray:
    """Anchor grid in (A, H, W)-flattened order, matching conv channels."""
    base = generate_anchors(feat_stride, list(ratios), list(scales))
    a_khw = shift_anchors(base, feat_h, feat_w, feat_stride)  # [K*A,4]
    A = base.shape[0]
    k = feat_h * feat_w
    return (
        a_khw.reshape(k, A, 4).transpose(1, 0, 2).reshape(A * k, 4)
        .astype(np.float32)
    )
