"""Multi-scale inference: per-chip detection, pruning, aggregation.

A jax-free copy of the box, mask and AutoFocus-map paths of
sniper_tpu/infer/tester.py:64-427 (``device_normalize`` in torch,
``check_valid`` and ``Tester``). The host plane is unchanged: decode the
class-agnostic deltas on the rois, clip to the chip canvas, rescale by
1/im_scale, per-class score threshold,
optional chip-border pruning (TEST.DO_PRUNING), then ``aggregate``: per
image and class, concat the scales under their VALID_RANGES area filters,
soft-NMS / NMS through the config-driven wrapper, and the MAX_PER_IMAGE
cap. With masks, each detection's [S,S] mask probabilities ride along
through the class filter, the pruning, the NMS keep and the cap. In the
map mode (AutoFocus), each chip's FocusPixel map, cropped to the chip's
content at stride 16, is kept for chips/autofocus.add_chips. The
forward returns torch tensors, which are brought to the host where the
host plane needs them. The JAX Tester's packed-array fetch and device
staging existed for its remote runtime and are not ported.

all_boxes layout: [class][image][chip] before aggregation, [class][image]
-> [N,5] after; all_masks the same nesting, [N,S,S] rows aligned with
all_boxes before aggregation and (dets, masks) pairs after; all_maps
[img][chip] -> [fh, fw] fp32 (None for a chip not yet run).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sniper_tpu_torch.data.test_loader import Prefetcher
from sniper_tpu_torch.ops.boxes import bbox_pred, clip_boxes
from sniper_tpu_torch.ops.nms import NMSWrapper
from sniper_tpu_torch.utils.profiler import span


def _host(x):
    """A forward output as a NumPy array (tensors are copied off the
    device, which waits for the work that produces them)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@functools.lru_cache(maxsize=8)
def _rgb_means(bgr_means: tuple, device: torch.device) -> torch.Tensor:
    """The means as an RGB tensor on ``device``, made once: a copy from
    pageable host memory would wait for the device at every batch."""
    return torch.tensor(bgr_means[::-1], dtype=torch.float32, device=device)


def device_normalize(data: torch.Tensor, im_info: torch.Tensor,
                     pixel_means) -> torch.Tensor:
    """uint8 RGB canvases [B,H,W,3] -> mean-subtracted fp32, on the
    tensors' device.

    pixel_means are in BGR order (the config convention) and reversed here;
    they are subtracted over each sample's content extent (im_info h, w) and
    the padding is set to exact zeros, as the fp32 host path produces.
    Non-uint8 input passes through untouched."""
    if data.dtype != torch.uint8:
        return data
    means = _rgb_means(tuple(float(v) for v in pixel_means), data.device)
    x = data.float() - means
    B, H, W = x.shape[:3]
    hh = torch.arange(H, device=data.device, dtype=torch.float32)
    ww = torch.arange(W, device=data.device, dtype=torch.float32)
    mask = ((hh[None, :, None] < im_info[:, None, None, 0])
            & (ww[None, None, :] < im_info[:, None, None, 1]))
    return torch.where(mask[..., None], x, 0.0)


def check_valid(det, chip, im_width, im_height, delta=10.0):
    """Drop detections touching an interior chip border (AutoFocus)."""
    dx1, dy1, dx2, dy2 = det[0], det[1], det[2], det[3]
    cx1, cy1, cx2, cy2 = chip[0], chip[1], chip[2], chip[3]
    if cx1 >= 0.5 and abs(dx1 - cx1) < delta:
        return False
    if cy1 >= 0.5 and abs(dy1 - cy1) < delta:
        return False
    if cx2 < im_width - 0.5 and abs(dx2 - cx2) < delta:
        return False
    if cy2 < im_height - 0.5 and abs(dy2 - cy2) < delta:
        return False
    return True


class Tester:
    """Host-side detection orchestrator around the detector's forward.

    ``forward_fn(data, im_info) -> dict`` must return the detector's
    test-mode outputs (rois [B,N,5], cls_prob [B,N,C], bbox_pred
    [B,N,4] std-denormalized, roi_valid [B,N], mask_prob [B,N,S,S] with
    the mask branch and focus_prob [B,H,W] with the AutoFocus head); for
    ``extract_proposals`` an RPN-only forward's rois, roi_scores and
    roi_valid. ``get_detections(per_chip_nms=True)`` runs each chip's
    per-class detections through the config's NMS before aggregation.
    """

    def __init__(self, forward_fn, cfg, num_classes: int):
        self.forward_fn = forward_fn
        self.cfg = cfg
        self.num_classes = num_classes
        self.nms = NMSWrapper(cfg.TEST.NMS, cfg.TEST.NMS_SIGMA)

    def detect_outputs(self, out, im_info, im_scales):
        """Decode already-enqueued forward outputs into per-image
        (scores [N,C], boxes [N,4]) in original image coordinates, the
        per-image FocusPixel maps cropped to ceil(im_info / 16) and the
        per-image mask probabilities [N,S,S] when the forward has them
        (else empty lists).
        Splitting dispatch from decode lets get_detections run one batch
        ahead — the device computes batch N+1 while the host
        post-processes batch N (the reference gets the same overlap from
        CONCURRENT_JOBS process pools, inference.py:452-491). Under a
        profiler the decode is the span ``decode`` (utils/profiler.span)."""
        with span("decode"):
            rois = _host(out["rois"])
            cls_prob = _host(out["cls_prob"])
            deltas = _host(out["bbox_pred"])
            valid = _host(out["roi_valid"])
            mask_prob = (_host(out["mask_prob"]) if "mask_prob" in out
                         else None)
            maps = _host(out["focus_prob"]) if "focus_prob" in out else None

            scores_list, boxes_list, maps_list, masks_list = [], [], [], []
            for i in range(rois.shape[0]):
                boxes = bbox_pred(rois[i, :, 1:], deltas[i])
                boxes = clip_boxes(boxes, im_info[i][:2])
                boxes = boxes / im_scales[i]
                scores = np.where(valid[i][:, None], cls_prob[i], 0.0)
                scores_list.append(scores)
                boxes_list.append(boxes)
                if mask_prob is not None:
                    masks_list.append(mask_prob[i])
                if maps is not None:
                    # the map over the chip's content extent at stride 16
                    fh = int(np.ceil(im_info[i][0] / 16.0))
                    fw = int(np.ceil(im_info[i][1] / 16.0))
                    maps_list.append(maps[i][:fh, :fw])
            return scores_list, boxes_list, maps_list, masks_list

    def extract_proposals(self, batches, roidb):
        """The proposal-extraction mode (tester.py:429-449): per valid
        image, its kept rois divided by the image's scale [N,4] and their
        scores [N,1], fp32, in the original image's coordinates."""
        n_images = len(roidb)
        boxes_out = [np.zeros((0, 4), np.float32) for _ in range(n_images)]
        scores_out = [np.zeros((0, 1), np.float32) for _ in range(n_images)]
        for batch in batches:
            out = self.forward_fn(batch["data"], batch["im_info"])
            rois = _host(out["rois"])
            scores = _host(out["roi_scores"])
            valid = _host(out["roi_valid"])
            for i in range(rois.shape[0]):
                if not batch["valid"][i]:
                    continue
                im_id = int(batch["im_ids"][i])
                keep = valid[i]
                boxes_out[im_id] = (
                    rois[i, keep, 1:] / batch["im_scales"][i]
                ).astype(np.float32)
                scores_out[im_id] = scores[i, keep, None].astype(np.float32)
        return boxes_out, scores_out

    def get_detections(self, batches, roidb, cls_thresh=1e-3,
                       per_chip_nms=False, do_pruning=False, autofocus=False,
                       with_masks=False):
        """Run detection over an iterable of batches.

        ``batches`` yields dicts with data [B,H,W,3], im_info [B,3],
        im_scales [B], im_ids [B], chip_ids [B], valid [B] (padding
        mask for partial batches). Returns (all_boxes, all_maps,
        all_masks): all_boxes in the reference layout ([cls][img][chip]
        -> [N,5]); with ``autofocus`` all_maps ([img][chip] -> the chip's
        FocusPixel map), else None; with ``with_masks`` all_masks
        ([cls][img][chip] -> [N,S,S] aligned with all_boxes rows), else
        None. ``per_chip_nms`` passes each chip's per-class detections
        through the config's NMS (``self.nms``, TEST.NMS / NMS_SIGMA), the
        masks of the kept rows with them.
        """
        n_images = len(roidb)
        n_chips = [len(r["inference_crops"]) for r in roidb]
        all_boxes = [
            [[np.zeros((0, 5), np.float32) for _ in range(n_chips[i])]
             for i in range(n_images)]
            for _ in range(self.num_classes)
        ]
        all_maps = ([[None] * n_chips[i] for i in range(n_images)]
                    if autofocus else None)
        all_masks = (
            [[[None] * n_chips[i] for i in range(n_images)]
             for _ in range(self.num_classes)]
            if with_masks else None
        )

        import time

        detect_time, post_time, n_done = 0.0, 0.0, 0

        def process(batch, out):
            nonlocal detect_time, post_time, n_done
            t0 = time.time()
            # blocks on the device result (fetch); the launches already
            # happened, so this overlaps with the NEXT batch's compute
            scores, boxes, maps, masks = self.detect_outputs(
                out, batch["im_info"], batch["im_scales"]
            )
            detect_time += time.time() - t0
            t0 = time.time()
            for i in range(len(scores)):
                if not batch["valid"][i]:
                    continue
                im_id = int(batch["im_ids"][i])
                chip_id = int(batch["chip_ids"][i])
                if autofocus and maps:
                    all_maps[im_id][chip_id] = maps[i]
                # one nonzero over the whole [N, C] score matrix instead
                # of a where() per class (C-1 Python iterations saved)
                s_i = scores[i]
                hits_r, hits_c = np.nonzero(s_i[:, 1:] > cls_thresh)
                hits_c += 1
                order = np.argsort(hits_c, kind="stable")  # roi order kept
                hits_r, hits_c = hits_r[order], hits_c[order]
                starts = np.searchsorted(hits_c, np.arange(1, self.num_classes + 1))
                empty = np.zeros((0, 5), np.float32)
                for j in range(1, self.num_classes):
                    inds = hits_r[starts[j - 1] : starts[j]]
                    if inds.size:
                        dets = np.concatenate(
                            [boxes[i][inds, :4], s_i[inds, j, None]], axis=1
                        ).astype(np.float32)
                    else:
                        dets = empty
                    m = masks[i][inds] if all_masks is not None and masks \
                        else None
                    if per_chip_nms and dets.shape[0]:
                        if m is not None:
                            dets, keep = self.nms(dets, return_indices=True)
                            m = m[keep]
                        else:
                            dets = self.nms(dets)
                    all_boxes[j][im_id][chip_id] = dets
                    if all_masks is not None:
                        all_masks[j][im_id][chip_id] = m

                if do_pruning:
                    chip = roidb[im_id]["inference_crops"][chip_id]
                    dx, dy = chip[0], chip[1]
                    for j in range(1, self.num_classes):
                        d = all_boxes[j][im_id][chip_id]
                        if d.shape[0] == 0:
                            continue
                        d = d.copy()
                        d[:, [0, 2]] += dx
                        d[:, [1, 3]] += dy
                        keep = [
                            k for k in range(d.shape[0])
                            if check_valid(
                                d[k], chip, roidb[im_id]["width"],
                                roidb[im_id]["height"],
                            )
                        ]
                        all_boxes[j][im_id][chip_id] = (
                            d[keep] if keep else np.zeros((0, 5), np.float32)
                        )
                        if all_masks is not None and \
                                all_masks[j][im_id][chip_id] is not None:
                            all_masks[j][im_id][chip_id] = \
                                all_masks[j][im_id][chip_id][keep]
            post_time += time.time() - t0
            n_done += int(np.sum(batch["valid"]))
            if n_done:
                # reference Tester progress line (inference.py:362-367)
                print(
                    f"Tester: {n_done}, Detection: "
                    f"{detect_time / n_done:.4f}s/im, Post Processing: "
                    f"{post_time / n_done:.4f}s/im"
                )

        # two overlaps: a background thread pre-assembles host batches
        # (imread/crop/resize into canvases) while the device runs, and
        # a one-deep pipeline enqueues batch N+1's forward (CUDA launches
        # are asynchronous) before decoding/post-processing batch N on
        # the host.
        pending = None
        for batch in Prefetcher(batches, depth=2):
            out = self.forward_fn(batch["data"], batch["im_info"])
            if pending is not None:
                process(*pending)
            pending = (batch, out)
        if pending is not None:
            process(*pending)
        return all_boxes, all_maps, all_masks

    def aggregate(self, scale_cls_dets, num_images: int,
                  scale_cls_masks=None, mask_size: int = 28):
        """Merge per-scale detections with VALID_RANGES + NMS + cap.

        scale_cls_dets: list over scales of all_boxes ([cls][img][chip]).
        Returns all_boxes[cls][img] -> [N,5]; when scale_cls_masks (same
        nesting, [N,S,S] rows aligned with dets) is given, also returns
        all_masks[cls][img] -> (dets, masks) pairs, which
        dataset.evaluate_segmentations takes.
        """
        valid_ranges = self.cfg.TEST.VALID_RANGES
        assert len(scale_cls_dets) == len(valid_ranges), (
            "a valid range per test scale is required"
        )
        with_masks = scale_cls_masks is not None
        all_boxes = [
            [np.zeros((0, 5), np.float32) for _ in range(num_images)]
            for _ in range(self.num_classes)
        ]
        all_masks = (
            [[None for _ in range(num_images)]
             for _ in range(self.num_classes)]
            if with_masks else None
        )
        empty_masks = np.zeros((0, mask_size, mask_size), np.float32)

        def aggregate_image(i):
            # merge scales/chips per class first, then rescore ALL
            # classes in one batched soft-NMS call (one padded greedy
            # loop instead of num_classes sequential ones)
            merged_cls = {}
            merged_cls_m = {}
            for j in range(1, self.num_classes):
                agg, agg_m = [], []
                for s, (dets_s, vr) in enumerate(
                        zip(scale_cls_dets, valid_ranges)):
                    for c, cls_dets in enumerate(dets_s[j][i]):
                        if cls_dets is None or len(cls_dets) == 0:
                            continue
                        d1 = cls_dets[:, 2] - cls_dets[:, 0]
                        d2 = cls_dets[:, 3] - cls_dets[:, 1]
                        areas = d1 * d2
                        ok = np.ones(len(areas), bool)
                        if vr[0] > 0:
                            ok &= areas > vr[0] * vr[0]
                        if vr[1] > 0:
                            ok &= areas <= vr[1] * vr[1]
                        if ok.any():
                            agg.append(cls_dets[ok])
                            if with_masks:
                                m = scale_cls_masks[s][j][i][c]
                                agg_m.append(
                                    np.asarray(m)[ok] if m is not None
                                    else np.zeros((int(ok.sum()), mask_size,
                                                   mask_size), np.float32))
                merged = (
                    np.vstack(agg).astype(np.float32)
                    if agg else np.zeros((0, 5), np.float32)
                )
                all_boxes[j][i] = merged
                if merged.shape[0]:
                    merged_cls[j] = merged
                if with_masks:
                    merged_cls_m[j] = (np.concatenate(agg_m, axis=0)
                                       if agg_m else empty_masks)
            js = list(merged_cls)
            if js and with_masks:
                outs, keeps = self.nms.batched(
                    [merged_cls[j] for j in js], return_indices=True)
                for j, out, keep in zip(js, outs, keeps):
                    all_boxes[j][i] = out
                    merged_cls_m[j] = merged_cls_m[j][keep]
            elif js:
                outs = self.nms.batched([merged_cls[j] for j in js])
                for j, out in zip(js, outs):
                    all_boxes[j][i] = out
            if with_masks:
                for j in range(1, self.num_classes):
                    all_masks[j][i] = (all_boxes[j][i],
                                       merged_cls_m.get(j, empty_masks))

            max_per_image = self.cfg.TEST.MAX_PER_IMAGE
            if max_per_image > 0:
                image_scores = np.hstack(
                    [all_boxes[j][i][:, -1] for j in range(1, self.num_classes)]
                )
                if len(image_scores) > max_per_image:
                    thresh = np.sort(image_scores)[-max_per_image]
                    for j in range(1, self.num_classes):
                        keep = all_boxes[j][i][:, -1] >= thresh
                        all_boxes[j][i] = all_boxes[j][i][keep]
                        if with_masks:
                            all_masks[j][i] = (all_boxes[j][i],
                                               all_masks[j][i][1][keep])

        # images are independent; CONCURRENT_JOBS>1 soft-NMSes them in a
        # thread pool (reference: Pool(32) over images, inference.py:159)
        jobs = int(getattr(self.cfg.TEST, "CONCURRENT_JOBS", 1) or 1)
        if jobs > 1 and num_images > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=jobs) as pool:
                list(pool.map(aggregate_image, range(num_images)))
        else:
            for i in range(num_images):
                aggregate_image(i)
        if with_masks:
            return all_boxes, all_masks
        return all_boxes
