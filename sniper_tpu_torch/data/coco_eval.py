"""Native COCO-protocol detection evaluator (bbox).

Drop-in replacement for the reference's vendored pycocotools COCOeval
(the reference's lib/dataset/pycocotools/cocoeval.py) — pycocotools is
not available in this environment, and mAP parity is the project's north
star, so the official protocol is reimplemented faithfully:

- IoU thresholds 0.50:0.05:0.95, 101 recall points, area ranges
  all/small/medium/large, maxDets 100 (plus 1/10 for AR),
- bbox IoU WITHOUT the legacy +1 (pycocotools maskApi convention),
- crowd GTs: IoU = intersection / det area, matchable many times,
- GT ignore = iscrowd or annotation area outside the range; detections
  matched to ignored GTs are ignored; unmatched detections outside the
  area range are ignored,
- greedy matching in score order, preferring non-ignored GTs (ignored
  GTs sorted last and only matched if nothing real fits),
- precision envelope interpolation; categories with no GTs excluded.

``iou_type='segm'`` scores instance masks with the same protocol
(reference lib/dataset/coco.py:264-336 with iouType='segm'): IoU over
decoded RLE masks, crowd IoU = intersection / det area, GT ignore by
annotation area. GT polygons are rasterized with cv2.fillPoly (boundary
pixels may differ from pycocotools' polygon scan by <=1px; RLE GTs are
exact). Verified against the real pycocotools protocol on the canned
fixture in tests/fixtures/cocoeval_golden.json.
"""

from __future__ import annotations

import numpy as np

from sniper_tpu_torch.infer.masks import rle_to_binary_mask

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def iou_xywh(dts, gts, iscrowd):
    """pycocotools bbox IoU: dts [D,4] xywh, gts [G,4] xywh -> [D,G]."""
    d = np.asarray(dts, np.float64)
    g = np.asarray(gts, np.float64)
    out = np.zeros((len(d), len(g)))
    if len(d) == 0 or len(g) == 0:
        return out
    dx2 = d[:, 0] + d[:, 2]
    dy2 = d[:, 1] + d[:, 3]
    gx2 = g[:, 0] + g[:, 2]
    gy2 = g[:, 1] + g[:, 3]
    iw = np.minimum(dx2[:, None], gx2[None, :]) - np.maximum(
        d[:, 0, None], g[None, :, 0]
    )
    ih = np.minimum(dy2[:, None], gy2[None, :]) - np.maximum(
        d[:, 1, None], g[None, :, 1]
    )
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    da = (d[:, 2] * d[:, 3])[:, None]
    ga = (g[:, 2] * g[:, 3])[None, :]
    union = np.where(np.asarray(iscrowd)[None, :], da, da + ga - inter)
    return np.where(inter > 0, inter / union, 0.0)


def segmentation_to_mask(segm, h: int, w: int) -> np.ndarray:
    """COCO segmentation (polygon list | uncompressed RLE dict) -> binary
    mask [h, w]."""
    if isinstance(segm, dict):
        return rle_to_binary_mask(segm)
    import cv2

    m = np.zeros((h, w), np.uint8)
    polys = [
        np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
        for p in segm
        if len(p) >= 6
    ]
    if polys:
        cv2.fillPoly(m, polys, 1)
    return m


def iou_masks(dts, gts, iscrowd):
    """pycocotools mask IoU: dts/gts lists of binary masks -> [D,G];
    crowd GT -> intersection / det area."""
    out = np.zeros((len(dts), len(gts)))
    if not len(dts) or not len(gts):
        return out
    d = np.stack([m.reshape(-1).astype(bool) for m in dts])
    g = np.stack([m.reshape(-1).astype(bool) for m in gts])
    inter = (d.astype(np.float64) @ g.T.astype(np.float64))
    da = d.sum(axis=1, dtype=np.float64)[:, None]
    ga = g.sum(axis=1, dtype=np.float64)[None, :]
    union = np.where(np.asarray(iscrowd)[None, :], da, da + ga - inter)
    return np.where(
        (inter > 0) & (union > 0), inter / np.maximum(union, 1e-12), 0.0
    )


class COCOEvaluator:
    def __init__(self, dataset, roidb, max_dets=(1, 10, 100),
                 iou_type: str = "bbox"):
        self.ds = dataset
        self.image_ids = [r["im_id"] for r in roidb]
        self.max_dets = max_dets
        if iou_type not in ("bbox", "segm"):
            raise ValueError(f"iou_type {iou_type!r}")
        self.iou_type = iou_type
        self.im_size = {
            r["im_id"]: (int(r["height"]), int(r["width"])) for r in roidb
        }

    def _gts(self, im_id, cls):
        cat_id = self.ds.class_to_cat_id[cls]
        out = []
        for a in self.ds.anns_by_image.get(im_id, []):
            if a["category_id"] == cat_id:
                out.append(a)
        return out

    def evaluate(self, results, per_category: bool = False):
        """results: COCO results list. Returns the standard stats dict and
        prints the 12-number summary; ``per_category`` adds a per-class
        AP table (reference lib/dataset/coco.py:357-375)."""
        # index detections by (image, class)
        dets: dict[tuple[int, int], list] = {}
        for r in results:
            cls = self.ds.cat_id_to_class.get(r["category_id"])
            if cls is None:
                continue
            dets.setdefault((r["image_id"], cls), []).append(r)

        T, R = len(IOU_THRS), len(REC_THRS)
        A, M = len(AREA_RNGS), len(self.max_dets)
        K = self.ds.num_classes - 1
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        area_items = list(AREA_RNGS.items())
        for k in range(K):
            cls = k + 1
            # per-image eval results for every area range / maxdet
            per_img = [
                self._eval_img(im_id, cls, dets.get((im_id, cls), []),
                               area_items)
                for im_id in self.image_ids
            ]
            for a in range(A):
                for m, maxdet in enumerate(self.max_dets):
                    scores, matched, ignored, npig = [], [], [], 0
                    for e in per_img:
                        if e is None:
                            continue
                        s, mt, ig, n = e[a]
                        scores.append(s[:maxdet])
                        matched.append(mt[:, :maxdet])
                        ignored.append(ig[:, :maxdet])
                        npig += n
                    if npig == 0:
                        continue
                    scores = np.concatenate(scores)
                    matched = np.concatenate(matched, axis=1)
                    ignored = np.concatenate(ignored, axis=1)
                    order = np.argsort(-scores, kind="mergesort")
                    matched = matched[:, order]
                    ignored = ignored[:, order]
                    tps = matched & ~ignored
                    fps = ~matched & ~ignored
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t in range(T):
                        tp, fp = tp_sum[t], fp_sum[t]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.finfo(float).eps)
                        recall[t, k, a, m] = rc[-1] if nd else 0.0
                        # precision envelope
                        q = np.zeros(R)
                        if nd:
                            for i in range(nd - 1, 0, -1):
                                if pr[i] > pr[i - 1]:
                                    pr[i - 1] = pr[i]
                            inds = np.searchsorted(rc, REC_THRS, side="left")
                            ok = inds < nd
                            q[ok] = pr[inds[ok]]
                        precision[t, :, k, a, m] = q

        def ap(t=None, area="all", maxdet=100):
            a = list(AREA_RNGS).index(area)
            m = self.max_dets.index(maxdet)
            p = precision[:, :, :, a, m] if t is None else \
                precision[IOU_THRS.tolist().index(t), :, :, a, m][None]
            p = p[p > -1]
            return float(np.mean(p)) if p.size else -1.0

        def ar(area="all", maxdet=100):
            a = list(AREA_RNGS).index(area)
            m = self.max_dets.index(maxdet)
            r = recall[:, :, a, m]
            r = r[r > -1]
            return float(np.mean(r)) if r.size else -1.0

        stats = {
            "AP": ap(),
            "AP50": ap(t=0.5),
            "AP75": ap(t=0.75),
            "APs": ap(area="small"),
            "APm": ap(area="medium"),
            "APl": ap(area="large"),
            "AR1": ar(maxdet=1),
            "AR10": ar(maxdet=10),
            "AR100": ar(),
            "ARs": ar(area="small"),
            "ARm": ar(area="medium"),
            "ARl": ar(area="large"),
        }
        for name, v in stats.items():
            print(f"  {name}: {v:.3f}")
        if per_category:
            a0 = list(AREA_RNGS).index("all")
            m_last = len(self.max_dets) - 1
            names = getattr(self.ds, "classes", None)
            table = {}
            for k in range(K):
                p = precision[:, :, k, a0, m_last]
                p = p[p > -1]
                cat = names[k + 1] if names else str(k + 1)
                table[cat] = float(np.mean(p)) if p.size else float("nan")
            width = max(len(c) for c in table) if table else 1
            for cat, v in table.items():
                print(f"  {cat:<{width}} : {v:.3f}")
            stats["per_category"] = table
        return stats

    def _eval_img(self, im_id, cls, dts, area_items):
        """Per-image per-class matching for every area range.

        Returns list over area ranges of (scores, matched[T,D],
        ignored[T,D], n_non_ignored_gts), or None if nothing to do.
        """
        gts = self._gts(im_id, cls)
        if len(gts) == 0 and len(dts) == 0:
            return None
        dts = sorted(dts, key=lambda d: -d["score"])[: max(self.max_dets)]
        dt_scores = np.array([d["score"] for d in dts])
        crowd = np.array([bool(g.get("iscrowd", 0)) for g in gts], dtype=bool)
        gt_area = np.array(
            [g.get("area", g["bbox"][2] * g["bbox"][3]) for g in gts],
            dtype=np.float64,
        )
        if self.iou_type == "segm":
            h, w = self.im_size[im_id]
            dt_masks = [
                segmentation_to_mask(d["segmentation"], h, w) for d in dts
            ]
            gt_masks = [
                segmentation_to_mask(g["segmentation"], h, w) for g in gts
            ]
            ious_all = iou_masks(dt_masks, gt_masks, crowd)
            # det area = mask pixel count (pycocotools loadRes for segm)
            dt_area = np.array([m.sum() for m in dt_masks], np.float64)
        else:
            dt_boxes = np.array(
                [d["bbox"] for d in dts], np.float64
            ).reshape(-1, 4)
            gt_boxes = np.array(
                [g["bbox"] for g in gts], np.float64
            ).reshape(-1, 4)
            ious_all = iou_xywh(dt_boxes, gt_boxes, crowd)
            dt_area = (
                dt_boxes[:, 2] * dt_boxes[:, 3] if len(dts) else np.zeros(0)
            )

        T = len(IOU_THRS)
        out = []
        for _, (lo, hi) in area_items:
            gt_ig0 = crowd | (gt_area < lo) | (gt_area > hi)
            # sort gts: non-ignored first (stable), pycocotools order
            gorder = np.argsort(gt_ig0, kind="mergesort")
            g_ig = gt_ig0[gorder]
            ious = ious_all[:, gorder]

            D, G = len(dts), len(gts)
            matched, ignored = _match_greedy(
                ious, g_ig, crowd[gorder], IOU_THRS
            )
            # unmatched dets outside the area range are ignored
            out_rng = (dt_area < lo) | (dt_area > hi)
            ignored |= ~matched & out_rng[None, :]
            n_gt = int((~gt_ig0).sum())
            out.append((dt_scores, matched, ignored, n_gt))
        return out


def _match_greedy(ious, g_ig, crowd, iou_thrs):
    """Greedy pycocotools det<->gt matching, all IoU thresholds at once.

    Vectorized form of the protocol's per-(threshold, det) scan over
    gts (the reference's triple loop, vendored cocoeval.py evaluateImg;
    previously a pure-Python triple loop here — the last scalar hot
    spot of the eval path, minutes at 5k-image scale). Exact semantics
    preserved:

    - dets match in score order (rows of ``ious`` are pre-sorted),
    - a det takes the LAST gt achieving the running max IoU (the scan
      updates on ``iou >= best``, so ties go to the later gt),
    - only gts still unmatched at this threshold are available, except
      crowd gts which re-match freely,
    - non-ignored gts are preferred: ignored gts (sorted last in
      ``ious``' columns) are considered only when no real gt reaches
      the threshold,
    - the match threshold is min(thr, 1-1e-10).

    ious [D, G] (gt columns sorted non-ignored first), g_ig [G] gt
    ignore flags in that order, crowd [G] same order. Returns
    (matched [T, D] bool, ignored [T, D] bool).
    """
    T = len(iou_thrs)
    D, G = ious.shape
    matched = np.zeros((T, D), bool)
    ignored = np.zeros((T, D), bool)
    if D == 0 or G == 0:
        return matched, ignored
    thr_eff = np.minimum(np.asarray(iou_thrs, np.float64), 1 - 1e-10)
    gtm_open = np.ones((T, G), bool)  # gt still available per threshold
    real = ~g_ig[None, :]
    t_idx = np.arange(T)
    for d in range(D):
        iou_d = ious[d][None, :]                     # [1, G]
        avail = gtm_open | crowd[None, :]
        # stage 1: last-argmax over available non-ignored gts
        v1 = np.where(avail & real, iou_d, -1.0)     # [T, G]
        b1 = G - 1 - np.argmax(v1[:, ::-1], axis=1)
        ok1 = v1[t_idx, b1] >= thr_eff
        # stage 2: ignored gts, only where no real gt reached the bar
        v2 = np.where(avail & ~real, iou_d, -1.0)
        b2 = G - 1 - np.argmax(v2[:, ::-1], axis=1)
        ok2 = ~ok1 & (v2[t_idx, b2] >= thr_eff)
        best = np.where(ok1, b1, np.where(ok2, b2, 0))
        hit = ok1 | ok2
        gtm_open[t_idx[hit], best[hit]] = False
        matched[hit, d] = True
        ignored[hit, d] = g_ig[best[hit]]
    return matched, ignored
