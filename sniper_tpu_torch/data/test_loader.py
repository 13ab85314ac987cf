"""Test-time batches: full images or AutoFocus chips per scale.

A jax-free copy of sniper_tpu/data/test_loader.py:33-190
(``init_inference_crops``, ``scale_for_image``, ``canvas_for_scale``,
``tier_canvases``, ``TestChipIterator``) and of the pieces of
sniper_tpu/data/loader.py it needs (``load_image_cv2``,
``process_chip_image_rect`` and ``Prefetcher``), whose module cannot be
imported without jax. Every scale has a bounded ladder of canvases: two
orientations x three size tiers (1, 1/2, 1/4 of each canvas dim, rounded
up to multiples of 64); full images land in tier 1, AutoFocus chips in the
smallest tier that holds them. Batches are uint8 RGB canvases.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


def load_image_cv2(path):
    import cv2

    im = cv2.imread(path, cv2.IMREAD_COLOR)
    if im is None:
        raise FileNotFoundError(path)
    return im


def process_chip_image_rect(im_bgr, chip_box, im_scale, canvas_hw,
                            pixel_means, flipped=False, as_uint8=False):
    """Test-time variant: crop->resize->RGB->mean-subtract->pad into a
    rectangular [H,W] canvas. Returns (img [H,W,3], out_h, out_w) where
    out_h/out_w are the content dims (the im_info extent).

    ``as_uint8=True`` skips the mean subtraction and returns the RGB
    canvas as uint8 — 4x fewer host->device bytes. The device side then
    applies infer.tester.device_normalize, which reproduces the fp32 path
    (mean-subtract on the content extent, exact zeros on the padding)."""
    import cv2

    im = im_bgr[:, ::-1, :] if flipped else im_bgr
    x1 = max(int(chip_box[0]), 0)
    y1 = max(int(chip_box[1]), 0)
    x2 = min(int(chip_box[2]), im.shape[1])
    y2 = min(int(chip_box[3]), im.shape[0])
    im = im[y1:y2, x1:x2, :]
    im = cv2.resize(im, None, None, fx=im_scale, fy=im_scale,
                    interpolation=cv2.INTER_LINEAR)
    h, w = canvas_hw
    d1 = min(im.shape[0], h)
    d2 = min(im.shape[1], w)
    if as_uint8:
        out = np.zeros((h, w, 3), dtype=np.uint8)
        # cv2's SIMD BGR->RGB is faster than a ::-1 copy
        out[:d1, :d2] = cv2.cvtColor(im[:d1, :d2], cv2.COLOR_BGR2RGB)
        return out, d1, d2
    out = np.zeros((h, w, 3), dtype=np.float32)
    means = np.asarray(pixel_means, np.float32)[::-1]
    np.subtract(im[:d1, :d2, ::-1], means, out=out[:d1, :d2],
                casting="unsafe")
    return out, d1, d2


class Prefetcher:
    """Background-thread batch prefetch (PrefetchingIter equivalent).

    Producer exceptions (failed imread, decode error, ...) are captured
    and re-raised in the CONSUMER thread — a run must abort, not return
    silently truncated results."""

    def __init__(self, iterable, depth: int = 2):
        self.iterable = iterable
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.error: BaseException | None = None
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        try:
            for item in self.iterable:
                self.q.put(item)
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            self.error = e
        finally:
            self.q.put(None)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                if self.error is not None:
                    raise self.error
                return
            yield item


def init_inference_crops(roidb):
    """Start AutoFocus/multi-scale inference from full-image crops."""
    for r in roidb:
        r["inference_crops"] = np.array(
            [[0.0, 0.0, r["width"], r["height"]]], np.float64
        )
    return roidb


def scale_for_image(width, height, spec):
    """(min_res, max_res) resize rule (MNIteratorTest.py:31-46)."""
    lo, hi = float(spec[0]), float(spec[1])
    mn, mx = float(min(width, height)), float(max(width, height))
    if lo > 0:
        s = lo / mn
        if hi > 0 and np.round(s * mx) > hi:
            s = hi / mx
    else:
        s = hi / mx
    return s


def canvas_for_scale(spec, round_to=64):
    """(landscape_hw, portrait_hw) static canvases for a scale spec."""
    lo, hi = int(spec[0]), int(spec[1])
    short = lo if lo > 0 else hi
    lng = hi if hi > 0 else lo

    def r(v):
        return (v + round_to - 1) // round_to * round_to

    return (r(short), r(lng)), (r(lng), r(short))


# canvas size tiers (fractions of each full-canvas dim). Chips bin to
# the smallest tier that holds them; full images always hit tier 1.0.
CANVAS_TIERS = (0.25, 0.5, 1.0)


def tier_canvases(full_hw, round_to=64):
    """Ascending list of static canvases for one orientation."""
    def r(v):
        return max(round_to, (int(v) + round_to - 1) // round_to * round_to)

    out = []
    for f in CANVAS_TIERS:
        hw = (r(full_hw[0] * f), r(full_hw[1] * f))
        if hw not in out:
            out.append(hw)
    return out


class TestChipIterator:
    """Yields batch dicts over all (image, chip) pairs at one scale."""

    # "Test" prefix = test-TIME iterator (reference MNIteratorTest
    # naming), not a pytest test class
    __test__ = False

    def __init__(self, roidb, cfg, scale_idx, batch_size,
                 image_loader=load_image_cv2, pixel_means=None):
        self.roidb = roidb
        self.cfg = cfg
        self.scale_idx = scale_idx
        self.batch_size = batch_size
        self.image_loader = image_loader
        self.spec = cfg.TEST.SCALES[scale_idx]
        self.pixel_means = (
            pixel_means if pixel_means is not None
            else cfg.network.PIXEL_MEANS
        )
        self.land_hw, self.port_hw = canvas_for_scale(self.spec)
        land_tiers = tier_canvases(self.land_hw)
        port_tiers = tier_canvases(self.port_hw)

        # enumerate (im_id, chip_id, area) and bin each chip into the
        # smallest (orientation, tier) canvas that holds it; groups are
        # emitted in ascending canvas area, largest chips first within
        def smallest_tier(tiers, h, w):
            for k, (th, tw) in enumerate(tiers):
                if h <= th and w <= tw:
                    return k
            return len(tiers) - 1  # oversize clamps like before

        groups = {}  # (is_land, tier_idx) -> [(i, j, area), ...]
        for i, r in enumerate(roidb):
            s = scale_for_image(r["width"], r["height"], self.spec)
            for j, c in enumerate(r.get("inference_crops", [])):
                # bin by the ACTUAL content extent: the crop truncates
                # fractional chip coords to ints (can widen the span by
                # up to 1 px vs c2-c0) and cv2 rounds the resize — ceil
                # of the int-span upper-bounds it, so a tier never clips
                # content (process_chip_image_rect semantics)
                x1 = max(int(c[0]), 0)
                y1 = max(int(c[1]), 0)
                x2 = min(int(c[2]), int(r["width"]))
                y2 = min(int(c[3]), int(r["height"]))
                w = float(np.ceil((x2 - x1) * s))
                h = float(np.ceil((y2 - y1) * s))
                land = w >= h
                tiers = land_tiers if land else port_tiers
                k = smallest_tier(tiers, h, w)
                groups.setdefault((land, k), []).append((i, j, w * h))
        for g in groups.values():
            g.sort(key=lambda t: -t[2])
        # [(canvas_hw, items)] ascending canvas area
        self.groups = sorted(
            (
                ((land_tiers if land else port_tiers)[k], items)
                for (land, k), items in groups.items()
            ),
            key=lambda t: t[0][0] * t[0][1],
        )

    def __len__(self):
        bs = self.batch_size
        return sum(
            (len(items) + bs - 1) // bs for _, items in self.groups
        )

    def _emit(self, group, hw):
        bs = self.batch_size
        for start in range(0, len(group), bs):
            chunk = group[start : start + bs]
            n = len(chunk)
            # uint8 canvases: 4x fewer host->device bytes; the forward
            # normalizes on the device (infer.tester.device_normalize)
            data = np.zeros((bs, hw[0], hw[1], 3), np.uint8)
            im_info = np.zeros((bs, 3), np.float32)
            im_scales = np.ones(bs, np.float32)
            im_ids = np.zeros(bs, int)
            chip_ids = np.zeros(bs, int)
            valid = np.zeros(bs, bool)
            for k, (i, j, _) in enumerate(chunk):
                r = self.roidb[i]
                chip = r["inference_crops"][j]
                s = scale_for_image(r["width"], r["height"], self.spec)
                im = self.image_loader(r["image"])
                img, out_h, out_w = process_chip_image_rect(
                    im, chip, s, hw, self.pixel_means,
                    flipped=r.get("flipped", False), as_uint8=True,
                )
                data[k] = img
                im_info[k] = [out_h, out_w, s]
                im_scales[k] = s
                im_ids[k] = i
                chip_ids[k] = j
                valid[k] = True
            if n < bs:  # pad the batch; padded entries carry valid=False
                im_info[n:] = [hw[0], hw[1], 1.0]
            yield {
                "data": data, "im_info": im_info, "im_scales": im_scales,
                "im_ids": im_ids, "chip_ids": chip_ids, "valid": valid,
            }

    def __iter__(self):
        for hw, items in self.groups:
            yield from self._emit(items, hw)
