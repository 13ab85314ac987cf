"""SNIPER chip generation: greedy max-set-cover over candidate windows.

A jax-free copy of sniper_tpu/chips/generator.py, whose module reaches
jax through sniper_tpu.ops. Only the imports differ, and ``with_rng``,
which no caller uses, is left out.

Re-derivation of the reference algorithm
(reference lib/chips/chip_generator.py:29-93 and its C++ twin
lib/chips/cchips.cpp:54-177) with the per-candidate Python loops replaced
by vectorized NumPy over a [C] candidates x [N] boxes containment matrix;
the greedy cover loop itself is sequential (as it must be) but each
iteration is O(C*N) boolean vector work.

Semantics preserved exactly, including reference quirks that affect which
boxes count as covered:
- boxes are pre-clipped with im_shape=(height-1, width-1), i.e. to
  [0, W-2] x [0, H-2] (chip_generator.py:31 passing [height-1, width-1]
  into a clip that subtracts another 1),
- candidate set = 3 corner chips + a stride grid over
  range(0, dim - chipsize) + right-edge column + bottom-edge row
  (chip_generator.py:33-58),
- candidates are randomly permuted before the cover loop, which breaks
  argmax ties randomly (chip_generator.py:62),
- a box is "contained" iff intersection == box area exactly
  (ignore-overlap == 1).

An optional C++ backend (native/libsniper_chips.so via ctypes) mirrors the
reference's CPP_CHIPS switch; the NumPy path is the oracle.
"""

from __future__ import annotations

import numpy as np

from sniper_tpu_torch.ops.boxes import clip_boxes, ignore_overlaps


def enumerate_candidate_chips(width: int, height: int, chipsize: int, stride: int):
    """All candidate chip windows, reference order: corners, grid, edges."""
    w, h, cs = int(width), int(height), int(chipsize)
    cands = [
        [max(w - cs, 0), 0, w - 1, min(cs, h - 1)],
        [0, max(h - cs, 0), min(cs, w - 1), h - 1],
        [max(w - cs, 0), max(h - cs, 0), w - 1, h - 1],
    ]
    xs = np.arange(0, w - cs, stride)
    ys = np.arange(0, h - cs, stride)
    if xs.size and ys.size:
        gx, gy = np.meshgrid(xs, ys, indexing="ij")  # x-major like the ref loops
        grid = np.stack(
            [gx.ravel(), gy.ravel(), gx.ravel() + cs - 1, gy.ravel() + cs - 1], axis=1
        )
        cands.extend(grid.tolist())
    # right-edge column
    for j in ys:
        cands.append([max(w - cs - 1, 0), j, w - 1, j + cs - 1])
    # bottom-edge row
    for i in xs:
        cands.append([i, max(h - cs - 1, 0), i + cs - 1, h - 1])
    return np.array(cands, dtype=np.float64)


def greedy_cover(contain: np.ndarray) -> list[int]:
    """Greedy max-cover: contain [C, N] bool -> picked candidate indices.

    Each round picks the candidate covering the most still-uncovered boxes
    (first argmax wins ties — candidates are pre-shuffled by the caller)
    and removes the covered boxes; stops when no candidate adds coverage.
    """
    live = contain.copy()
    picked = []
    while True:
        counts = live.sum(axis=1)
        best = int(np.argmax(counts))
        if counts[best] == 0:
            break
        picked.append(best)
        live &= ~live[best]
    return picked


class ChipGenerator:
    """Generates covering chips for a set of boxes.

    use_cpp selects the native C++ set-cover (config TRAIN.CPP_CHIPS);
    falls back to NumPy transparently when the shared library is absent.
    """

    def __init__(self, chip_stride: int = 32, use_cpp: bool = False,
                 rng: np.random.RandomState | None = None):
        self.chip_stride = int(chip_stride)
        self.rng = rng if rng is not None else np.random.RandomState()
        self._cpp = None
        if use_cpp:
            from sniper_tpu_torch.chips import _native

            self._cpp = _native.load()  # None if the .so isn't built

    def generate(self, boxes: np.ndarray, width: int, height: int, chipsize: int):
        """boxes [N,4] (already scaled) -> list of chip xyxy arrays."""
        boxes = np.asarray(boxes, dtype=np.float64).reshape(-1, 4)
        if boxes.shape[0]:
            # reference quirk: clip against (height-1, width-1) canvas
            boxes = clip_boxes(boxes, np.array([height - 1, width - 1]))
        cands = enumerate_candidate_chips(width, height, chipsize, self.chip_stride)
        perm = self.rng.permutation(cands.shape[0])
        cands = cands[perm]
        if boxes.shape[0] == 0:
            return []
        if self._cpp is not None:
            picked = self._cpp.greedy_cover(cands, boxes)
        else:
            contain = ignore_overlaps(cands, boxes) == 1.0
            picked = greedy_cover(contain)
        return [cands[i] for i in picked]


def compute_im_scales(width: int, height: int, scales) -> list[float]:
    """Per-pyramid-scale resize factor for one image.

    Supports both reference modes
    (reference lib/data_utils/data_workers.py:409-426,467-493):
    - resolution-based: scale spec (min_res, max_res); shortest side ->
      min_res, capped so the longest side stays <= max_res; -1 disables
      a bound,
    - factor-based: floats, except the last entry which is the target
      max side in pixels and is divided by the image's max side.
    """
    im_size_max = float(max(width, height))
    im_size_min = float(min(width, height))
    res_based = isinstance(scales[0], (list, tuple))
    out = []
    for i, s in enumerate(scales):
        if res_based:
            lo, hi = float(s[0]), float(s[1])
            if lo > 0:
                sc = lo / im_size_min
                if hi > 0 and np.round(sc * im_size_max) > hi:
                    sc = hi / im_size_max
            else:
                sc = hi / im_size_max
            out.append(sc)
        else:
            out.append(float(s) / im_size_max if i == len(scales) - 1 else float(s))
    return out
