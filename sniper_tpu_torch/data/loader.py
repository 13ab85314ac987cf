"""SNIPER training data engine: per-epoch chip pipeline + batch assembly.

A jax-free copy of sniper_tpu/data/loader.py:50-440 (``ChipLoader``,
``process_chip_image``) in the form the training step takes: uint8 chips,
normalized on the device, and the sparse RPN targets, plus under
TRAIN.WITH_MASK each chip's GT masks rasterized on the host
(data/mask_utils.py), and under TRAIN.AUTO_FOCUS each chip's FocusPixel
labels (``scale_label``). The image reader and ``Prefetcher`` are shared
with data/test_loader.py. With TRAIN.VISUALIZE every
TRAIN.visualization_freq-th schedule slot's chip is rendered with its GT
boxes to ``<TRAIN.visualization_path>/chip_e<epoch>_s<slot>.jpg``
(utils/visualization.save_training_chip; epochs count from 1).

Rebuild of the reference MNIteratorE2E + im_worker + PrefetchingIter
(reference lib/iterators/MNIteratorE2E.py:41-220,
lib/data_utils/data_workers.py:80-121, lib/iterators/PrefetchingIter.py):

per epoch (reset):
- re-roll the chip stride in [56, 60), re-extract positive chips for
  every image (greedy set-cover per scale), assign boxes, mine negative
  chips and sample at most 2 per image, pad the shuffled chip index to a
  batch multiple, and shuffle each image's chip visit order,

per batch:
- each index entry names an image; the image contributes its next chip
  (round-robin through its shuffled chip_order),
- image is read (BGR), optionally flipped, cropped to the chip, resized
  by the chip's im_scale, converted to RGB and padded into the fixed
  [chip, chip] uint8 canvas (NHWC here, vs reference NCHW); the mean
  subtraction runs on the device,
- RPN targets per chip via AnchorTargetAssigner (sparse pid/value pairs),
  and with TRAIN.AUTO_FOCUS the chip's FocusPixel labels [H*W] float32 in
  {-1, 0, 1} (``scale_label``),
- with TRAIN.WITH_MASK and polygons in the roidb entry, the kept GT rows'
  polygons in chip coordinates rasterized into [MAX_GT_BOXES, 112, 112]
  uint8 box-normalized masks,
- valid_ranges scaled into chip pixels (lo*scale or 0 / hi*scale or
  chip_size),

and a background prefetch thread overlaps host work with device steps.

Parallelism: the reference burns a 64-process pool on Python-2 loops
(MNIteratorE2E.py:139,173). Here the per-epoch schedule (which chip each
batch slot gets) is resolved serially at reset() so batch assembly is a
pure function of (im_idx, crop_id, per-slot rng); a thread pool then
assembles the samples of a batch concurrently — cv2 imread/resize and
the large-array NumPy work in the anchor assigner all release the GIL,
so threads scale without fork/pickle overhead. TRAIN.NUM_THREAD sets
the pool width (<=1 restores the serial path). Determinism is per-slot:
each schedule position derives its own RandomState from the epoch seed,
so results are independent of thread interleaving. TRAIN.NUM_PROCESS > 1
maps the per-epoch re-roll over a spawned process pool instead (the
reference's Pool(NUM_PROCESS)), created once, reused across epochs and
ended by ``close()``; per-image seeds make its results bit-identical to
the in-process re-roll.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from sniper_tpu_torch.chips.assigner import assign_boxes, extract_chips
from sniper_tpu_torch.chips.generator import ChipGenerator
from sniper_tpu_torch.data.anchor_targets import (
    AnchorTargetAssigner,
    AutoFocusParams,
)
from sniper_tpu_torch.data.mask_utils import crop_polys, rasterize_gt_masks
from sniper_tpu_torch.data.test_loader import Prefetcher, load_image_cv2

__all__ = ["ChipLoader", "Prefetcher", "load_image_cv2",
           "process_chip_image"]


def _reroll_image(args):
    """Per-image epoch re-roll unit: extract -> assign -> neg-sample.

    Takes a MINIMAL image record (width/height/boxes/max_overlaps) and
    returns (crops, props_in_chips, neg_chips, neg_props); the caller
    applies them to the real roidb row. Each image has its own
    RandomState, so the result does not depend on the thread order.
    """
    (rmin, scales, ranges, chip_size, stride, use_cpp, use_neg,
     n_neg_per_im, seed_i) = args
    rng_i = np.random.RandomState(seed_i)
    gen_i = ChipGenerator(chip_stride=stride, use_cpp=use_cpp, rng=rng_i)
    rmin["crops"] = extract_chips(rmin, scales, ranges, chip_size, gen_i)
    props, negs, negp = assign_boxes(
        rmin, scales, ranges, chip_size, gen_i, use_neg_chips=use_neg,
    )
    crops = rmin["crops"]
    props = list(props)
    if use_neg and len(negs) > 0:
        sel = np.arange(len(negs))
        if len(negs) > n_neg_per_im:
            sel = rng_i.permutation(sel)[:n_neg_per_im]
        for ind in sel:
            crops.append(negs[ind])
            props.append(negp[ind].astype(np.int32))
    return (crops, props, rmin.get("neg_chips"),
            rmin.get("neg_props_in_chips"))


def process_chip_image(im_bgr, chip_box, im_scale, chip_size, flipped=False):
    """Crop->resize->RGB->pad, reference im_worker.worker semantics
    (data_workers.py:80-121) without the mean subtraction. Returns
    ``(uint8 [chip, chip, 3] RGB, h, w)`` where h/w are the ACTUAL content
    dims (cv2's resize rounding can differ from the chip's nominal
    out_h/out_w): the train step mean-subtracts that extent on the device
    (infer.tester.device_normalize), 4x fewer host->device bytes than the
    reference's fp32 chips."""
    import cv2

    im = im_bgr[:, ::-1, :] if flipped else im_bgr
    x1, y1, x2, y2 = (int(v) for v in chip_box[:4])
    im = im[max(y1, 0) : y2, max(x1, 0) : x2, :]
    im = cv2.resize(im, None, None, fx=im_scale, fy=im_scale,
                    interpolation=cv2.INTER_LINEAR)
    h = min(im.shape[0], chip_size)
    w = min(im.shape[1], chip_size)
    out = np.zeros((chip_size, chip_size, 3), dtype=np.uint8)
    # SIMD BGR->RGB: the negative-stride fancy copy measured 2.7ms
    # per 512^2 chip vs 0.3ms for cvtColor (9x) — this copy was the
    # single hottest line of the sample assembly path
    out[:h, :w] = cv2.cvtColor(im[:h, :w], cv2.COLOR_BGR2RGB)
    return out, h, w


class ChipLoader:
    """Epoch-based chip batch iterator."""

    def __init__(self, roidb, cfg, batch_size, image_loader=load_image_cv2,
                 seed=0):
        self.roidb = roidb
        self.cfg = cfg
        self.batch_size = batch_size
        self.image_loader = image_loader
        self.rng = np.random.RandomState(seed)
        self.chip_size = cfg.TRAIN.CHIP_SIZE
        self.n_neg_per_im = 2
        af = None
        if cfg.TRAIN.AUTO_FOCUS:
            af = AutoFocusParams(
                small_thresh=cfg.TRAIN.AUTO_FOCUS_SMALL_THRESH,
                dc_low=cfg.TRAIN.AUTO_FOCUS_DC_LOW,
                dc_high=cfg.TRAIN.AUTO_FOCUS_DC_HIGH,
            )
        self.assigner = AnchorTargetAssigner(
            chip_size=self.chip_size,
            anchor_scales=cfg.network.ANCHOR_SCALES,
            anchor_ratios=cfg.network.ANCHOR_RATIOS,
            feat_stride=cfg.network.RPN_FEAT_STRIDE,
            rpn_batch_size=cfg.TRAIN.RPN_BATCH_SIZE,
            fg_fraction=cfg.TRAIN.RPN_FG_FRACTION,
            pos_thresh=cfg.TRAIN.RPN_POSITIVE_OVERLAP,
            neg_thresh=cfg.TRAIN.RPN_NEGATIVE_OVERLAP,
            max_n_gts=cfg.TRAIN.MAX_GT_BOXES,
            autofocus=af,
        )
        self.size = 0
        self._epoch = 0
        # the training-chip rendering (the reference's MNIteratorE2E
        # visualize under TRAIN.VISUALIZE)
        self.vis_path = (str(cfg.TRAIN.visualization_path)
                         if bool(getattr(cfg.TRAIN, "VISUALIZE", False))
                         else None)
        self.vis_freq = max(int(cfg.TRAIN.visualization_freq or 100), 1)
        self.num_workers = int(getattr(cfg.TRAIN, "NUM_THREAD", 1) or 1)
        self._pool = (
            ThreadPoolExecutor(max_workers=self.num_workers)
            if self.num_workers > 1 else None
        )
        self._reroll_pool = None  # spawned on first use, lives to close()

    def _mp_pool(self, nproc: int):
        """The TRAIN.NUM_PROCESS re-roll pool, created once and reused
        across epochs (spawning and importing take seconds)."""
        if self._reroll_pool is None:
            import multiprocessing as mp

            self._reroll_pool = mp.get_context("spawn").Pool(nproc)
        return self._reroll_pool

    def close(self):
        """End the re-roll process pool (idempotent)."""
        if getattr(self, "_reroll_pool", None) is not None:
            self._reroll_pool.terminate()
            self._reroll_pool.join()
            self._reroll_pool = None

    def __del__(self):
        self.close()

    def reset(self):
        """Per-epoch chip pipeline; returns total chip count.

        Images are independent: each derives its own RandomState from
        the epoch seed (so results don't depend on execution order) and
        runs extract -> assign -> neg-sample as one unit, mapped over
        the thread pool when TRAIN.NUM_THREAD > 1 (the reference burns
        a Pool(NUM_PROCESS=64) on the same per-epoch re-roll,
        MNIteratorE2E.py:47-69)."""
        cfg = self.cfg
        self._epoch += 1
        lo, hi = cfg.TRAIN.CHIP_STRIDE_RANGE
        stride = self.rng.randint(lo, hi)
        scales, ranges = cfg.TRAIN.SCALES, cfg.TRAIN.VALID_RANGES
        epoch_seed = int(self.rng.randint(0, 2**31 - 1))

        use_neg = bool(cfg.TRAIN.USE_NEG_CHIPS)

        def task(i):
            r = self.roidb[i]
            # a minimal record of the fields extract/assign read, which
            # _reroll_image writes into in place of the roidb row
            rmin = {k: r[k] for k in ("width", "height", "boxes",
                                      "max_overlaps") if k in r}
            seed_i = (epoch_seed + i) % (2**31 - 1)
            return (rmin, scales, ranges, self.chip_size, stride,
                    cfg.TRAIN.CPP_CHIPS, use_neg, self.n_neg_per_im,
                    seed_i)

        tasks = [task(i) for i in range(len(self.roidb))]
        nproc = int(getattr(cfg.TRAIN, "NUM_PROCESS", 0) or 0)
        if nproc > 1:
            # chunks amortize the pickling; per-image seeds keep the
            # results those of the in-process re-roll
            chunk = max(1, len(tasks) // (nproc * 4))
            results = self._mp_pool(nproc).map(_reroll_image, tasks,
                                               chunksize=chunk)
        elif self._pool is not None:
            results = list(self._pool.map(_reroll_image, tasks))
        else:
            results = [_reroll_image(t) for t in tasks]
        chip_count = 0
        for r, (crops, props, negs, negp) in zip(self.roidb, results):
            r["crops"] = crops
            r["props_in_chips"] = props
            if negs is not None:
                r["neg_chips"] = negs
                r["neg_props_in_chips"] = negp
            chip_count += len(crops)
        chipindex = []
        for i, r in enumerate(self.roidb):
            chipindex += [i] * len(r["crops"])

        chipindex = np.array(chipindex, dtype=int)
        if chipindex.size == 0:
            self.inds = chipindex
            self.size = 0
            return 0
        if chipindex.shape[0] % self.batch_size > 0:
            extra = self.batch_size - (chipindex.shape[0] % self.batch_size)
            # cyclic pad: 'extra' may exceed len(chipindex) when there are
            # fewer chips than one batch
            chipindex = np.resize(chipindex, chipindex.shape[0] + extra)
        self.inds = self.rng.permutation(chipindex)
        self.size = len(self.inds)
        self.crop_idx = [0] * len(self.roidb)
        for r in self.roidb:
            r["chip_order"] = self.rng.permutation(np.arange(len(r["crops"])))
        # Resolve the round-robin chip pick for every schedule slot now
        # (serial, cheap) so batch assembly below is pure + parallel.
        self.schedule = []
        for im_idx in self.inds:
            r = self.roidb[im_idx]
            order = r["chip_order"]
            crop_id = order[self.crop_idx[im_idx] % len(order)]
            self.crop_idx[im_idx] += 1
            self.schedule.append((int(im_idx), int(crop_id)))
        # per-slot RNG base: deterministic given the loader seed + epoch
        self._slot_seed = int(self.rng.randint(0, 2**31 - 1))
        return chip_count

    def _sample(self, pos):
        """Assemble the training sample for schedule slot ``pos``."""
        im_idx, crop_id = self.schedule[pos]
        rng = np.random.RandomState((self._slot_seed + pos) % (2**31 - 1))
        sample = self._build_sample(im_idx, crop_id, rng)
        if self.vis_path is not None and pos % self.vis_freq == 0:
            from sniper_tpu_torch.utils.visualization import (
                save_training_chip,
            )

            save_training_chip(
                sample, self.cfg.network.PIXEL_MEANS,
                os.path.join(self.vis_path,
                             f"chip_e{self._epoch}_s{pos}.jpg"))
        return sample

    def _build_sample(self, im_idx, crop_id, rng):
        """Pure sample assembly: imread -> chip crop/resize -> RPN targets."""
        cfg = self.cfg
        r = self.roidb[im_idx]
        chip = r["crops"][crop_id]

        im = self.image_loader(r["image"])
        data, eh, ew = process_chip_image(
            im, chip.box, chip.im_scale, self.chip_size,
            flipped=r.get("flipped", False))

        gtids = np.where(r["max_overlaps"] == 1)[0]
        tgt = self.assigner(
            np.asarray(chip.box), chip.im_scale,
            r["props_in_chips"][crop_id], gtids, r["boxes"],
            r["max_classes"][gtids], rng,
        )
        vr = cfg.TRAIN.VALID_RANGES[chip.scale_idx]
        valid_range = np.array(
            [
                0.0 if vr[0] < 0 else vr[0] * chip.im_scale,
                float(self.chip_size) if vr[1] < 0 else vr[1] * chip.im_scale,
            ],
            np.float32,
        )
        im_info = np.array(
            [min(chip.out_h, self.chip_size), min(chip.out_w, self.chip_size),
             chip.im_scale],
            np.float32,
        )
        sample = {
            "data": data,
            "im_info": im_info,
            "data_extent": np.array([eh, ew], np.float32),
            "valid_ranges": valid_range,
            "gt_boxes": tgt.gt_boxes,
            "rpn_pids": tgt.rpn_pids,
            "rpn_label_vals": tgt.rpn_label_vals,
            "fg_pids": tgt.fg_pids,
            "fg_targets": tgt.fg_targets,
        }
        if tgt.focus_label is not None:
            sample["scale_label"] = tgt.focus_label
        if cfg.TRAIN.WITH_MASK and "gt_masks" in r:
            # polygons into chip coordinates, aligned to the kept GT rows
            polys = crop_polys([r["gt_masks"][g] for g in gtids], chip.box,
                               chip.im_scale)
            kept_polys = [polys[k] for k in tgt.gt_keep]
            kept_boxes = tgt.gt_boxes[:len(tgt.gt_keep), :4]
            sample["gt_masks"] = rasterize_gt_masks(
                kept_polys, kept_boxes, grid=112,
                max_n_gts=cfg.TRAIN.MAX_GT_BOXES)
        return sample

    def __iter__(self):
        return self.batches()

    def batches(self, limit: int | None = None):
        """The epoch's batches, or its first ``limit``. Iterating reads no
        rng: the next epoch's roll is the same however far this one ran."""
        stop = self.size if limit is None else min(
            self.size, limit * self.batch_size)
        for start in range(0, stop, self.batch_size):
            positions = range(start, start + self.batch_size)
            if self._pool is not None:
                samples = list(self._pool.map(self._sample, positions))
            else:
                samples = [self._sample(p) for p in positions]
            yield {
                k: np.stack([s[k] for s in samples]) for k in samples[0]
            }

    def __len__(self):
        return self.size // self.batch_size if self.size else 0
