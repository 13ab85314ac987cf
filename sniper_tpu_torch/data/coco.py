"""COCO dataset: annotation loading, roidb construction, result writing,
evaluation.

Rebuild of the reference's lib/dataset/coco.py (which drives a vendored
pycocotools). Annotation JSONs are parsed directly (no pycocotools
dependency — absent in this image); evaluation uses the native
COCO-protocol evaluator in sniper_tpu_torch.data.coco_eval.

Semantics preserved:
- category ids remapped to contiguous 1..80 class indices (bg = 0),
- crowd annotations get gt_overlaps rows of -1 (coco.py:220-227) so they
  never count as GTs (max_overlaps != 1) but still poison matching,
- boxes clipped to the image and degenerate annotations dropped,
- gt_roidb pickle cache keyed by image set,
- detections written as standard COCO results json per class
  (coco.py:279-321) for cross-checking with official tooling.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np


class COCODataset:
    def __init__(self, image_set: str, root_path: str, data_path: str,
                 load_mask: bool = False):
        """image_set e.g. 'train2017'/'val2017'/'train2014'. data_path is
        the coco root holding annotations/ and the image dirs."""
        self.image_set = image_set
        self.root_path = root_path
        self.data_path = data_path
        self.load_mask = load_mask
        self.name = f"COCO_{image_set}"

        # view mapping: eval splits whose images live in another set's
        # directory (reference lib/dataset/coco.py:93-98)
        view_map = {
            "minival2014": "val2014",
            "valminusminival2014": "val2014",
            "test-dev2015": "test2015",
            "test-dev2017": "test2017",
        }
        self.data_name = view_map.get(image_set, image_set)
        # test splits ship box-less image_info annotation files
        prefix = "image_info" if "test" in image_set else "instances"
        ann_file = os.path.join(
            data_path, "annotations", f"{prefix}_{image_set}.json"
        )
        with open(ann_file) as f:
            ann = json.load(f)

        cats = sorted(ann["categories"], key=lambda c: c["id"])
        self.classes = ["__background__"] + [c["name"] for c in cats]
        self.num_classes = len(self.classes)
        self.cat_id_to_class = {
            c["id"]: i + 1 for i, c in enumerate(cats)
        }
        self.class_to_cat_id = {v: k for k, v in self.cat_id_to_class.items()}

        self.images = {im["id"]: im for im in ann["images"]}
        self.image_ids = sorted(self.images)
        self.anns_by_image: dict[int, list] = {i: [] for i in self.image_ids}
        for a in ann.get("annotations", []):
            if a["image_id"] in self.anns_by_image:
                self.anns_by_image[a["image_id"]].append(a)

        self.result_path = os.path.join(root_path, "results", self.name)

    def image_path(self, im):
        # standard layout: <data_path>/<data_name>/<file_name> (view
        # mapping sends e.g. minival2014 images to val2014/)
        return os.path.join(self.data_path, self.data_name, im["file_name"])

    def _entry(self, im_id):
        im = self.images[im_id]
        w, h = im["width"], im["height"]
        boxes, classes, crowds, masks = [], [], [], []
        for a in self.anns_by_image[im_id]:
            x, y, bw, bh = a["bbox"]
            x1 = max(0.0, x)
            y1 = max(0.0, y)
            x2 = min(w - 1.0, x1 + max(0.0, bw - 1))
            y2 = min(h - 1.0, y1 + max(0.0, bh - 1))
            if a.get("area", bw * bh) > 0 and x2 >= x1 and y2 >= y1:
                boxes.append([x1, y1, x2, y2])
                classes.append(self.cat_id_to_class[a["category_id"]])
                crowds.append(a.get("iscrowd", 0))
                if self.load_mask:
                    seg = a.get("segmentation", [])
                    masks.append([
                        np.asarray(p, np.float32)
                        for p in (seg if isinstance(seg, list) else [])
                    ])
        n = len(boxes)
        boxes = np.asarray(boxes, np.float32).reshape(n, 4)
        classes = np.asarray(classes, np.int32)
        overlaps = np.zeros((n, self.num_classes), np.float32)
        for i in range(n):
            if crowds[i]:
                overlaps[i, :] = -1.0
            else:
                overlaps[i, classes[i]] = 1.0
        entry = {
            "image": self.image_path(im),
            "im_id": im_id,
            "height": h,
            "width": w,
            "boxes": boxes,
            "gt_classes": classes,
            "gt_overlaps": overlaps,
            "max_classes": overlaps.argmax(axis=1),
            "max_overlaps": overlaps.max(axis=1),
            "flipped": False,
        }
        if self.load_mask:
            entry["gt_masks"] = masks
        return entry

    def gt_roidb(self, use_cache: bool = True):
        # the cache key must carry load_mask: a maskless cache written
        # by an earlier bbox-only run (e.g. the RPN phase of the
        # neg-chip chain) would otherwise silently feed a WITH_MASK
        # training run roidb entries without gt_masks (found by the
        # --mask minicoco campaign, whose phase 1 is bbox-only)
        suffix = "_mask" if self.load_mask else ""
        cache = os.path.join(
            self.root_path, "cache", f"{self.name}_gt_roidb{suffix}.pkl"
        )
        if use_cache and os.path.exists(cache):
            with open(cache, "rb") as f:
                return pickle.load(f)
        roidb = [self._entry(i) for i in self.image_ids]
        if use_cache:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            # written whole, then renamed: a data-parallel rank that finds
            # the cache never reads another rank's half-written file
            tmp = f"{cache}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump(roidb, f)
            os.replace(tmp, cache)
        return roidb

    def detections_to_results(self, all_boxes, roidb):
        """all_boxes[cls][img] [N,5] -> COCO results list (xywh)."""
        results = []
        for j in range(1, self.num_classes):
            cat_id = self.class_to_cat_id[j]
            for i, r in enumerate(roidb):
                dets = all_boxes[j][i]
                for d in dets:
                    x1, y1, x2, y2, s = (float(v) for v in d[:5])
                    results.append({
                        "image_id": int(r["im_id"]),
                        "category_id": int(cat_id),
                        "bbox": [x1, y1, x2 - x1 + 1, y2 - y1 + 1],
                        "score": s,
                    })
        return results

    def evaluate_detections(self, all_boxes, roidb, save_json=True):
        """Write results json + run the native COCO evaluator. Returns the
        stats dict (AP, AP50, AP75, APs, APm, APl, ARs)."""
        from sniper_tpu_torch.data.coco_eval import COCOEvaluator

        results = self.detections_to_results(all_boxes, roidb)
        if save_json:
            os.makedirs(self.result_path, exist_ok=True)
            out = os.path.join(
                self.result_path, f"detections_{self.image_set}_results.json"
            )
            with open(out, "w") as f:
                json.dump(results, f)
        ev = COCOEvaluator(self, roidb)
        return ev.evaluate(results, per_category=True)

    def evaluate_segmentations(self, all_boxes_masks, roidb, save_json=True):
        """Score instance masks (iouType='segm'; reference
        lib/dataset/coco.py:264-336). all_boxes_masks[cls][img] =
        (dets [N,5], mask_probs [N,S,S])."""
        from sniper_tpu_torch.data.coco_eval import COCOEvaluator
        from sniper_tpu_torch.infer.masks import masks_to_results

        results = masks_to_results(
            all_boxes_masks, roidb, self.class_to_cat_id, self.num_classes
        )
        if save_json:
            os.makedirs(self.result_path, exist_ok=True)
            out = os.path.join(
                self.result_path,
                f"segmentations_{self.image_set}_results.json",
            )
            with open(out, "w") as f:
                json.dump(results, f)
        ev = COCOEvaluator(self, roidb, iou_type="segm")
        return ev.evaluate(results, per_category=True)
