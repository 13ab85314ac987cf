"""Pascal VOC dataset: XML annotations, roidb, devkit-format results,
VOC AP evaluation (07 and 12 metrics).

Rebuild of the reference's lib/dataset/pascal_voc.py:26-440 and
pascal_voc_eval.py:39-73. Boxes are stored 0-based internally (the
devkit XMLs are 1-based); results are written back 1-based like the
reference (:395-416). The AP metric switches on the year: VOC2007 uses
the 11-point metric, later years the continuous envelope metric.
"""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET

import numpy as np

CLASSES = [
    "__background__",
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


def _write_cache(cache, roidb):
    """Pickle roidb to cache whole, then rename it into place: a
    data-parallel rank that finds the cache never reads another rank's
    half-written file (coco.py's gt_roidb does the same)."""
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    tmp = f"{cache}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(roidb, f)
    os.replace(tmp, cache)


def parse_voc_xml(path):
    tree = ET.parse(path)
    size = tree.find("size")
    objs = []
    for obj in tree.findall("object"):
        bb = obj.find("bndbox")
        objs.append({
            "name": obj.find("name").text.lower().strip(),
            "difficult": int((obj.find("difficult").text
                              if obj.find("difficult") is not None else 0)),
            "bbox": [
                float(bb.find("xmin").text) - 1,
                float(bb.find("ymin").text) - 1,
                float(bb.find("xmax").text) - 1,
                float(bb.find("ymax").text) - 1,
            ],
        })
    return {
        "width": int(size.find("width").text),
        "height": int(size.find("height").text),
        "objects": objs,
    }


class PascalVOC:
    def __init__(self, image_set: str, root_path: str, devkit_path: str):
        """image_set like '2007_trainval' or '2012_test'."""
        year, split = image_set.split("_")
        self.year = year
        self.split = split
        self.image_set = image_set
        self.root_path = root_path
        self.devkit_path = devkit_path
        self.data_path = os.path.join(devkit_path, f"VOC{year}")
        self.name = f"voc_{year}_{split}"
        self.classes = CLASSES
        self.num_classes = len(CLASSES)
        self._class_to_ind = {c: i for i, c in enumerate(CLASSES)}

        index_file = os.path.join(
            self.data_path, "ImageSets", "Main", f"{split}.txt"
        )
        with open(index_file) as f:
            self.image_index = [line.strip() for line in f if line.strip()]
        self.result_path = os.path.join(root_path, "results", self.name)

    def image_path(self, index):
        return os.path.join(self.data_path, "JPEGImages", f"{index}.jpg")

    def annotation_path(self, index):
        return os.path.join(self.data_path, "Annotations", f"{index}.xml")

    def _entry(self, index, keep_difficult=False):
        ann = parse_voc_xml(self.annotation_path(index))
        objs = [
            o for o in ann["objects"]
            if keep_difficult or not o["difficult"]
        ]
        n = len(objs)
        boxes = np.array([o["bbox"] for o in objs], np.float32).reshape(n, 4)
        classes = np.array(
            [self._class_to_ind[o["name"]] for o in objs], np.int32
        )
        overlaps = np.zeros((n, self.num_classes), np.float32)
        overlaps[np.arange(n), classes] = 1.0
        return {
            "image": self.image_path(index),
            "index": index,
            "height": ann["height"],
            "width": ann["width"],
            "boxes": boxes,
            "gt_classes": classes,
            "gt_overlaps": overlaps,
            "max_classes": overlaps.argmax(axis=1),
            "max_overlaps": overlaps.max(axis=1),
            "flipped": False,
        }

    def gt_roidb(self, use_cache: bool = True):
        cache = os.path.join(
            self.root_path, "cache", f"{self.name}_gt_roidb.pkl"
        )
        if use_cache and os.path.exists(cache):
            with open(cache, "rb") as f:
                return pickle.load(f)
        roidb = [self._entry(i) for i in self.image_index]
        if use_cache:
            _write_cache(cache, roidb)
        return roidb

    def load_selective_search_roidb(self, gt_roidb):
        """Selective-search proposal roidb from the devkit-format .mat
        (reference pascal_voc.py:180-201): boxes arrive [y1 x1 y2 x2]
        1-based; dedupe, drop boxes under config min_size (16), label
        them against the GTs."""
        import scipy.io

        from sniper_tpu_torch.data.ds_utils import filter_small_boxes, unique_boxes
        from sniper_tpu_torch.data.roidb import compute_overlap_fields

        matfile = os.path.join(
            self.root_path, "selective_search_data", f"{self.name}.mat"
        )
        raw = scipy.io.loadmat(matfile)["boxes"].ravel()
        roidb = []
        for r, entry_boxes in zip(gt_roidb, raw):
            boxes = entry_boxes[:, (1, 0, 3, 2)].astype(np.float32) - 1
            boxes = boxes[unique_boxes(boxes)]
            boxes = boxes[filter_small_boxes(boxes, 16)]
            fields = compute_overlap_fields(
                boxes, r["boxes"], r["gt_classes"], self.num_classes
            )
            roidb.append({
                "image": r["image"], "index": r["index"],
                "height": r["height"], "width": r["width"],
                "boxes": boxes,
                "gt_classes": np.zeros(len(boxes), np.int32),
                "flipped": False, **fields,
            })
        return roidb

    def selective_search_roidb(self, gt_roidb, append_gt=False,
                               use_cache=True):
        """SS roidb with pkl cache; optionally merged with GT rows
        (reference pascal_voc.py:203-227)."""
        cache = os.path.join(
            self.root_path, "cache", f"{self.name}_ss_roidb.pkl"
        )
        if use_cache and os.path.exists(cache):
            with open(cache, "rb") as f:
                return pickle.load(f)
        ss_roidb = self.load_selective_search_roidb(gt_roidb)
        if append_gt:
            from sniper_tpu_torch.data.roidb import merge_gt_and_proposals

            ss_roidb = [
                merge_gt_and_proposals(g, s["boxes"],
                                       num_classes=self.num_classes)
                for g, s in zip(gt_roidb, ss_roidb)
            ]
        if use_cache:
            _write_cache(cache, ss_roidb)
        return ss_roidb

    def segmentation_class_path(self, index):
        return os.path.join(
            self.data_path, "SegmentationClass", f"{index}.png"
        )

    def write_segmentation_results(self, pred_segmentations):
        """Per-image predicted class-label maps -> paletted PNGs under
        results/VOC{year}/Segmentation (reference :341-358)."""
        from PIL import Image

        out_dir = os.path.join(
            self.result_path, "results", f"VOC{self.year}", "Segmentation"
        )
        os.makedirs(out_dir, exist_ok=True)
        palette = voc_palette(256)
        for index, pred in zip(self.image_index, pred_segmentations):
            img = Image.fromarray(np.uint8(np.squeeze(pred)))
            img.putpalette(palette)
            img.save(os.path.join(out_dir, f"{index}.png"))
        return out_dir

    def evaluate_segmentations(self, pred_segmentations):
        """Semantic-segmentation meanIU over SegmentationClass GT PNGs
        (reference _py_evaluate_segmentation, pascal_voc.py:352-381):
        GT resized (nearest) to the prediction's shape, 255 = ignore,
        per-class IU from the accumulated confusion matrix."""
        import cv2
        from PIL import Image

        n = self.num_classes
        confusion = np.zeros((n, n), np.float64)
        for index, pred in zip(self.image_index, pred_segmentations):
            pred = np.squeeze(np.asarray(pred)).astype(np.int64)
            gt = np.array(
                Image.open(self.segmentation_class_path(index))
            ).astype(np.float32)
            gt = cv2.resize(gt, (pred.shape[1], pred.shape[0]),
                            interpolation=cv2.INTER_NEAREST)
            keep = gt != 255
            g = gt[keep].astype(np.int64)
            p = pred[keep]
            # vectorized confusion-matrix accumulation
            confusion += np.bincount(
                g * n + p, minlength=n * n
            ).reshape(n, n)
        pos = confusion.sum(1)
        res = confusion.sum(0)
        tp = np.diag(confusion)
        iu = tp / np.maximum(1.0, pos + res - tp)
        return {"meanIU": float(iu.mean()), "IU_array": iu}

    def write_results(self, all_boxes, roidb):
        """Devkit-format per-class result files (1-based boxes)."""
        os.makedirs(self.result_path, exist_ok=True)
        paths = {}
        for j in range(1, self.num_classes):
            path = os.path.join(
                self.result_path,
                f"comp4_det_{self.split}_{self.classes[j]}.txt",
            )
            paths[self.classes[j]] = path
            with open(path, "w") as f:
                for r, dets in zip(roidb, all_boxes[j]):
                    for d in dets:
                        f.write(
                            f"{r['index']} {d[4]:.6f} "
                            f"{d[0] + 1:.1f} {d[1] + 1:.1f} "
                            f"{d[2] + 1:.1f} {d[3] + 1:.1f}\n"
                        )
        return paths

    def evaluate_detections(self, all_boxes, roidb, iou_thresh=0.5):
        """VOC AP per class + mAP. Uses the 07 metric for year 2007."""
        use_07 = self.year == "2007"
        aps = {}
        for j in range(1, self.num_classes):
            dets = []
            for i, d in enumerate(all_boxes[j]):
                for row in d:
                    dets.append((i, row[4], row[:4]))
            gt = {}
            npos = 0
            for i, r in enumerate(roidb):
                idx = np.where(r["gt_classes"] == j)[0]
                gt[i] = {
                    "boxes": r["boxes"][idx],
                    "matched": np.zeros(len(idx), bool),
                    "difficult": np.zeros(len(idx), bool),
                }
                npos += len(idx)
            aps[self.classes[j]] = voc_ap_from_dets(
                dets, gt, npos, iou_thresh, use_07
            )
        mean_ap = float(np.mean([v for v in aps.values() if v >= 0]))
        print(f"VOC mAP ({'07' if use_07 else '12'} metric): {mean_ap:.4f}")
        return {"mAP": mean_ap, "per_class": aps}


def voc_palette(num_cls):
    """Bit-interleaved VOC segmentation color palette (reference
    get_pallete, pascal_voc.py:310-329)."""
    palette = [0] * (num_cls * 3)
    for j in range(num_cls):
        lab, i = j, 0
        while lab > 0:
            palette[j * 3 + 0] |= ((lab >> 0) & 1) << (7 - i)
            palette[j * 3 + 1] |= ((lab >> 1) & 1) << (7 - i)
            palette[j * 3 + 2] |= ((lab >> 2) & 1) << (7 - i)
            i += 1
            lab >>= 3
    return palette


def voc_ap_from_dets(dets, gt, npos, iou_thresh=0.5, use_07_metric=False):
    """dets: list of (image_idx, score, box xyxy 0-based); gt: per-image
    dict with boxes/matched/difficult. Mirrors pascal_voc_eval.py."""
    if npos == 0 or not dets:
        return -1.0 if npos == 0 else 0.0
    dets = sorted(dets, key=lambda d: -d[1])
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for k, (i, _, box) in enumerate(dets):
        g = gt[i]
        if len(g["boxes"]) == 0:
            fp[k] = 1
            continue
        gb = g["boxes"].astype(np.float64)
        ixmin = np.maximum(gb[:, 0], box[0])
        iymin = np.maximum(gb[:, 1], box[1])
        ixmax = np.minimum(gb[:, 2], box[2])
        iymax = np.minimum(gb[:, 3], box[3])
        iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
        ih = np.maximum(iymax - iymin + 1.0, 0.0)
        inter = iw * ih
        uni = (
            (box[2] - box[0] + 1.0) * (box[3] - box[1] + 1.0)
            + (gb[:, 2] - gb[:, 0] + 1.0) * (gb[:, 3] - gb[:, 1] + 1.0)
            - inter
        )
        ious = inter / uni
        jmax = int(np.argmax(ious))
        if ious[jmax] > iou_thresh and not g["matched"][jmax]:
            tp[k] = 1
            g["matched"][jmax] = True
        else:
            fp[k] = 1
    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(npos)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return voc_ap(rec, prec, use_07_metric)


def voc_ap(rec, prec, use_07_metric=False):
    """AP from recall/precision curves (pascal_voc_eval.py:39-73)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
