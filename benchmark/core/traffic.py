"""The one traffic generator: images and training chips from a traffic
file's parameters and the run's seed.

- ``image_pool``: the pyramid's pool of distinct images, resized to each
  test scale's canvas on the device, and the sequence of rounds that draws
  from it;
- ``chip_pool``: training batches of SNIPER chips with GT boxes inside
  each chip's valid range, their RPN targets from a frozen copy of the
  port's anchor-target assigner (data/anchor_targets.py, PR 7), and the
  R-CNN sampler's priorities.

Pixels are smooth noise: uniform values on a grid PIXEL_CELL times coarser
than the image, bilinearly upsampled, so that the trunk sees edges and
flat regions rather than white noise. The same seed gives the same
images, boxes and order; another seed the same sizes and counts in
another draw.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.core.weights import subseed
from benchmark.reference import ops

PIXEL_CELL = 8


def smooth_images(n, h, w, seed, stream, device):
    """n uint8 RGB images [n, h, w, 3] on ``device``."""
    gen = torch.Generator(device=device).manual_seed(subseed(seed, stream))
    low = torch.rand(n, 3, -(-h // PIXEL_CELL) + 1, -(-w // PIXEL_CELL) + 1,
                     generator=gen, device=device) * 255.0
    up = F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    return up.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1) \
        .contiguous()


def scale_for_image(width, height, spec):
    """The (min_res, max_res) resize rule of the test loader."""
    lo, hi = float(spec[0]), float(spec[1])
    mn, mx = float(min(width, height)), float(max(width, height))
    if lo > 0:
        s = lo / mn
        if hi > 0 and np.round(s * mx) > hi:
            s = hi / mx
    else:
        s = hi / mx
    return s


def scale_specs(yml, width, height):
    """Per TEST.SCALES entry: canvas (the resized image rounded up to 64),
    batch, scale, resized (h, w) and post-NMS rois."""
    t = yml["TEST"]
    n = t.get("N_PROPOSAL_PER_SCALE")
    post = list(n) if n else [int(t["RPN_POST_NMS_TOP_N"])] * len(t["SCALES"])
    specs = []
    for spec, b, rois in zip(t["SCALES"], t["BATCH_IMAGES"], post):
        s = scale_for_image(width, height, spec)
        h, w = int(np.round(height * s)), int(np.round(width * s))
        specs.append(dict(canvas=((h + 63) // 64 * 64, (w + 63) // 64 * 64),
                          batch=int(b), scale=s, hw=(h, w),
                          post_nms=int(rois)))
    return specs


def image_pool(traffic, specs, seed, device):
    """Per scale, the pool's canvases [n, ch, cw, 3] uint8 (the resized
    image at the top left, zeros beyond) and its im_info row."""
    n, w, h = traffic["pool_images"], traffic["width"], traffic["height"]
    images = smooth_images(n, h, w, seed, "images", device)
    out = []
    for sp in specs:
        (ch, cw), (rh, rw) = sp["canvas"], sp["hw"]
        canvas = torch.zeros((n, ch, cw, 3), dtype=torch.uint8, device=device)
        for i in range(0, n, 16):  # bounded fp32 intermediates
            x = images[i:i + 16].permute(0, 3, 1, 2).float()
            x = F.interpolate(x, size=(rh, rw), mode="bilinear",
                              align_corners=False)
            canvas[i:i + 16, :rh, :rw] = x.round().clamp(0, 255).to(
                torch.uint8).permute(0, 2, 3, 1)
        info = np.array([rh, rw, sp["scale"]], np.float32)
        out.append((canvas, info))
    return out


class Rounds:
    """The images of each round: ``round_images`` distinct pool indices a
    round, drawn from the seed, as many rounds as asked."""

    def __init__(self, traffic, seed):
        self.n = traffic["pool_images"]
        self.k = traffic["round_images"]
        self.rng = np.random.default_rng(subseed(seed, "rounds"))

    def next(self):
        return self.rng.choice(self.n, self.k, replace=False)


# ---------------------------------------------------------------------------
# training chips
# ---------------------------------------------------------------------------


def _filter(boxes, min_size):
    return ((boxes[:, 2] - boxes[:, 0] + 1 >= min_size)
            & (boxes[:, 3] - boxes[:, 1] + 1 >= min_size))


class AnchorTargets:
    """RPN targets of one chip whose GT boxes all lie in its valid range:
    a frozen copy of the port's assigner (anchors within 32 px of the
    canvas, GTs rounded and clipped and dropped under 10 px, bg below
    neg_thresh, fg at each GT's best anchors and at pos_thresh, fg then bg
    subsampled to the RPN batch)."""

    def __init__(self, chip, stride, ratios, scales, rpn_batch, fg_fraction,
                 pos, neg, max_gts, border=32):
        base = ops.generate_anchors(stride, list(ratios), list(scales))
        self.A = base.shape[0]
        self.f = chip // stride
        a = ops.shift_anchors(base, self.f, self.f, stride)
        inside = ((a[:, 0] >= -border) & (a[:, 1] >= -border)
                  & (a[:, 2] < chip + border) & (a[:, 3] < chip + border))
        self.idx = np.where(inside)[0]
        self.anchors = a[self.idx]
        self.chip = chip
        self.rpn_batch = rpn_batch
        self.num_fg = int(rpn_batch * fg_fraction)
        self.pos, self.neg, self.max_gts = pos, neg, max_gts

    def __call__(self, boxes, classes, rng):
        gt = ops.clip_boxes(np.round(boxes.astype(np.float64)),
                            (self.chip, self.chip))
        keep = _filter(gt, 10.0)
        gt, cls = gt[keep], classes[keep]
        n_in = len(self.idx)
        labels = np.full(n_in, -1.0)
        argmax = np.zeros(n_in, np.int64)
        if len(gt):
            ov = ops.bbox_overlaps(self.anchors, gt)
            argmax = ov.argmax(1)
            best = ov[np.arange(n_in), argmax]
            labels[best < self.neg] = 0
            labels[np.where(ov == ov.max(0))[0]] = 1
            labels[best >= self.pos] = 1
        else:
            labels[:] = 0
        fg = np.where(labels == 1)[0]
        if len(fg) > self.num_fg:
            labels[rng.choice(fg, len(fg) - self.num_fg, replace=False)] = -1
        num_bg = self.rpn_batch - int(np.sum(labels == 1))
        bg = np.where(labels == 0)[0]
        if len(bg) > num_bg:
            labels[rng.choice(bg, len(bg) - num_bg, replace=False)] = -1
        fgt = np.full((self.max_gts, 5), -1.0, np.float32)
        n = min(len(gt), self.max_gts)
        fgt[:n, :4], fgt[:n, 4] = gt[:n], cls[:n]
        A, hw = self.A, self.f * self.f

        def to_awh(g):
            return ((g % A) * hw + g // A).astype(np.int32)

        sampled = np.where(labels >= 0)[0]
        pids = np.full(self.rpn_batch, -1, np.int32)
        vals = np.full(self.rpn_batch, -1.0, np.float32)
        pids[:len(sampled)] = to_awh(self.idx[sampled])
        vals[:len(sampled)] = labels[sampled]
        fg = np.where(labels == 1)[0]
        fpids = np.full(self.num_fg, -1, np.int32)
        ftgts = np.zeros((self.num_fg, 4), np.float32)
        fpids[:len(fg)] = to_awh(self.idx[fg])
        if len(fg) and len(gt):
            ftgts[:len(fg)] = ops.bbox_transform(self.anchors[fg],
                                                 gt[argmax[fg]])
        return dict(gt_boxes=fgt, rpn_pids=pids, rpn_label_vals=vals,
                    fg_pids=fpids, fg_targets=ftgts)


def chip_boxes(rng, n, lo, hi, chip):
    """n boxes whose sqrt(area) is uniform in [lo, hi], aspect ratio
    log-uniform in [1/2, 2], inside the chip."""
    side = rng.uniform(lo, hi, n)
    ar = np.exp(rng.uniform(np.log(0.5), np.log(2.0), n))
    w = np.minimum(side * np.sqrt(ar), chip - 2)
    h = np.minimum(side / np.sqrt(ar), chip - 2)
    x1 = rng.uniform(0, chip - 1 - w)
    y1 = rng.uniform(0, chip - 1 - h)
    return np.stack([x1, y1, x1 + w, y1 + h], 1)


def chip_pool(traffic, yml, seed, device):
    """``n_batches`` batches of ``batch`` chips (the chip loader's keys, on
    ``device``) and each batch's sampler priorities (fg_u, bg_u)."""
    tr, net = yml["TRAIN"], yml["network"]
    chip = int(traffic["chip"])
    B, nb = int(traffic["batch"]), int(traffic["n_batches"])
    assign = AnchorTargets(
        chip, net["RPN_FEAT_STRIDE"], net["ANCHOR_RATIOS"],
        net["ANCHOR_SCALES"], tr["RPN_BATCH_SIZE"], tr["RPN_FG_FRACTION"],
        tr["RPN_POSITIVE_OVERLAP"], tr["RPN_NEGATIVE_OVERLAP"],
        int(traffic["max_gts"]))
    rng = np.random.default_rng(subseed(seed, "chips"))
    images = smooth_images(nb * B, chip, chip, seed, "chip_pixels", device)
    n_cand = int(tr["RPN_POST_NMS_TOP_N"]) + int(traffic["max_gts"])
    gen = torch.Generator(device=device).manual_seed(
        subseed(seed, "priorities"))
    tiers = traffic["tiers"]
    g_lo, g_hi = traffic["gts_per_chip"]
    batches, priorities = [], []
    for k in range(nb):
        rows = []
        for _ in range(B):
            tier = tiers[rng.integers(len(tiers))]
            lo, hi = tier["valid_range"]
            n = int(rng.integers(g_lo, g_hi + 1))
            boxes = chip_boxes(rng, n, max(lo, traffic["min_box"]),
                               min(hi, traffic["max_box"]), chip)
            classes = rng.integers(1, yml["dataset"]["NUM_CLASSES"], n)
            t = assign(boxes, classes.astype(np.float64), rng)
            t["valid_ranges"] = np.array([lo, hi], np.float32)
            t["im_info"] = np.array([chip, chip, tier["scale"]], np.float32)
            t["data_extent"] = np.array([chip, chip], np.float32)
            rows.append(t)
        batch = {key: torch.as_tensor(np.stack([r[key] for r in rows]),
                                      device=device) for key in rows[0]}
        batch["data"] = images[k * B:(k + 1) * B]
        batches.append(batch)
        priorities.append(tuple(
            torch.rand(B, n_cand, generator=gen, device=device)
            for _ in range(2)))
    return batches, priorities
