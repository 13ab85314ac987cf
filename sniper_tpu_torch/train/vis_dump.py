"""Periodic training-time prediction dumps (TRAIN.VISUALIZE).

Port of sniper_tpu/train/vis_dump.py, the reference's debug VisMetric
(lib/train_utils/metric.py:347-368). Beside the chip loader's GT-side
renderings, ``PredictionDumper`` runs the detector's test branch (which
std-denormalizes the box deltas, models/detector.py) on the first chip of
a training batch every TRAIN.visualization_freq steps, decodes the boxes
on the host, and writes under ``<TRAIN.visualization_path>/preds/``:

- ``preds_step{N}.pkl``: {step, batch_seq, the per-class [M,5]
  detections, the valid rois, cls_prob and bbox_pred}, the reference's
  payload;
- ``preds_step{N}.jpg``: the chip with those detections drawn.

The JAX dumper's packed device-to-host fetch (``pack_detections``) existed
for its remote runtime and is not ported.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from sniper_tpu_torch.infer.tester import device_normalize
from sniper_tpu_torch.ops.boxes import bbox_pred as decode
from sniper_tpu_torch.ops.boxes import clip_boxes


class PredictionDumper:
    def __init__(self, model, cfg):
        """``model`` is the detector itself, never a DDP wrapper: the dump
        is a forward of one rank's copy, outside the collectives."""
        self.model = model
        self.cfg = cfg
        # the loader's renderings share the base directory, so the GT-side
        # and the prediction-side images of a run land in one tree
        self.dir = os.path.join(str(cfg.TRAIN.visualization_path), "preds")
        self.freq = max(int(cfg.TRAIN.visualization_freq or 100), 1)

    def _predict(self, host_batch):
        """The test branch on the batch's first chip, mean-subtracted over
        its ``data_extent`` (the chip's content, as the train step
        normalizes it). The model runs in eval mode under inference_mode,
        then returns to the mode it was in: its running statistics and the
        sampler's generator do not move, so the training run is the same
        with the dumps as without. Returns the outputs on the host."""
        model = self.model
        device = next(model.parameters()).device
        data = torch.as_tensor(np.asarray(host_batch["data"][:1])).to(device)
        im_info = torch.as_tensor(
            np.asarray(host_batch["im_info"][:1], np.float32)).to(device)
        extent = host_batch.get("data_extent")
        extent = (im_info[:, :2] if extent is None else torch.as_tensor(
            np.asarray(extent[:1], np.float32)).to(device))
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                data = device_normalize(data, extent,
                                        self.cfg.network.PIXEL_MEANS)
                out = model(data, im_info)
                return {k: out[k][0].float().cpu().numpy() for k in
                        ("rois", "cls_prob", "bbox_pred", "roi_valid")}
        finally:
            model.train(was_training)

    def maybe_dump(self, host_batch, step: int, batch_seq: int | None = None):
        """Dump iff ``step`` is on the cadence; returns the pkl path or
        None. ``host_batch`` is the loader's NumPy batch; ``batch_seq`` its
        own sequence number in the loader, which may trail ``step`` by the
        prefetch depth: the pkl records both."""
        if step % self.freq:
            return None
        import cv2

        from sniper_tpu_torch.utils.visualization import draw_detections

        out = self._predict(host_batch)
        # the test branch pads the rois to post_nms_top_n: drop the padded
        # slots, whose scores would draw phantom boxes
        valid = out["roi_valid"].astype(bool)
        rois = out["rois"][valid]
        probs = out["cls_prob"][valid]
        deltas = out["bbox_pred"][valid]
        im_info = np.asarray(host_batch["im_info"][0], np.float32)
        boxes = clip_boxes(decode(rois[:, 1:], deltas), im_info[:2])
        per_class = [np.zeros((0, 5), np.float32)]
        for c in range(1, self.model.num_classes):
            keep = probs[:, c] > 0.05
            per_class.append(np.hstack([boxes[keep], probs[keep, c:c + 1]])
                             .astype(np.float32))

        os.makedirs(self.dir, exist_ok=True)
        pkl = os.path.join(self.dir, f"preds_step{step}.pkl")
        with open(pkl, "wb") as f:
            pickle.dump({"step": step, "batch_seq": batch_seq,
                         "dets": per_class, "rois": rois, "cls_prob": probs,
                         "bbox_pred": deltas}, f)
        im = np.asarray(host_batch["data"][0])
        if im.dtype != np.uint8:  # fp32 chips: add the means back
            im = np.clip(im + np.asarray(self.cfg.network.PIXEL_MEANS,
                                         np.float32)[::-1],
                         0, 255).astype(np.uint8)
        drawn = draw_detections(im, per_class, threshold=0.1)
        cv2.imwrite(os.path.join(self.dir, f"preds_step{step}.jpg"),
                    cv2.cvtColor(drawn, cv2.COLOR_RGB2BGR))
        return pkl
