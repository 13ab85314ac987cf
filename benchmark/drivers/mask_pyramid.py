"""Multi-scale instance segmentation: the pyramid of test scales of
drivers/pyramid.py under the mask configuration.

The loop, the rounds, the warm-up, the window and the record's keys are
pyramid.py's (imported): the registry's mask detector (``get_model`` with
TRAIN.WITH_MASK) through ``main_test.make_forward`` per scale and batch,
then the Tester's decode (``Tester.detect_outputs``), which brings every
kept roi's 28x28 mask probabilities to the host with its boxes and scores.
Pasting the masks into the image and their RLE encoding (infer/masks.py)
stay outside the window: they are cv2 work per detection on the host.

What this driver replaces:

- the weights: the reference mask detector's (benchmark/core/masks.py);
- the FLOPs: a round's box detector (yardstick/flops.py) and mask branch
  (yardstick/mask_flops.py);
- the bounds: the fused pool's least time adds the 14x14 mask pool's
  passes at each batch of the traced slice;
- the traced slice's program spans (benchmark/core/spans.table): the
  record's ``span_table``, which ``mask_device_ms.infer`` and
  ``mask_host_ms.infer`` read;
- the checks: pyramid.py's four on each sampled batch, and

  - ``mask_gap``: the widest gap of a kept roi's mask probability from the
    reference's mask branch (reference/mask.py) run on the program's rois
    and the program's argmax foreground classes, on its own roi map;
  - ``class_flip`` (computed, no limit: it separates too little): the
    share of kept rois whose argmax foreground class differs from the
    reference head's on the same rois;
  - ``mask_head_gap``: the widest gap of a kept roi's mask probability
    from the reference's mask head, plane pick and softmax on the
    program's own 14x14 pooled features (the input of its MaskHead, kept
    by a forward pre-hook as each sampled batch runs once more through
    its forward after the window) and argmax classes: the mask head's
    precision alone, which the trunk's bf16 hides in ``mask_gap``;
  - ``mask_short``: kept rois without a mask: over every batch of the
    window, the rois of the batch (B x post-NMS) less those that the
    program's mask branch ran on (sniper_tpu_torch.models.detector.
    MASK_ROIS, read after each forward's dispatch by a wrapper around
    each scale's forward), where short; and in
    each sampled batch the kept rois whose decoded mask is missing or not
    finite.

A program without the roi counter cannot be checked, and the run stops at
its start with an error.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from benchmark.core import harness
from benchmark.core import spans as pspans
from benchmark.core.masks import mask_program_model, mask_reference_model, \
    mask_seeded_weights
from benchmark.drivers import pyramid
from benchmark.reference import compare
from benchmark.yardstick import kernels as yk
from benchmark.yardstick.mask_flops import mask_flops

MASK_POOLED = 14


def _counter():
    """The port's mask roi counter module, or an error without one."""
    from sniper_tpu_torch.models import detector

    if not hasattr(detector, "MASK_ROIS"):
        raise RuntimeError(
            "the program has no mask roi counter (sniper_tpu_torch.models."
            "detector.MASK_ROIS): mask_short cannot be read; no result")
    return detector


class Profiled(harness.Profiled):
    """harness.Profiled that also reads the slice's program spans into
    ``table`` (empty without a slice)."""

    def summary(self, group_of):
        self.table = {}
        if self.path is not None:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
            span = next((e for e in events if e.get("name") == self.NAME
                         and e.get("cat") == "user_annotation"), None)
            if span is not None:
                t0 = float(span["ts"])
                self.table = pspans.table(events, t0, t0 + float(span["dur"]),
                                          group_of)
            del events
        return super().summary(group_of)


class MaskPyramid(pyramid.Pyramid):
    def __init__(self, ctx):
        self.detector = _counter()
        # pyramid.Pyramid builds its program with the module's
        # program_model (the box detector's weights); the mask detector's
        # stand in for it while the base class builds
        box_model = pyramid.program_model
        pyramid.program_model = mask_program_model
        try:
            super().__init__(ctx)
        finally:
            pyramid.program_model = box_model
        self.short = 0  # rois of the window's batches the branch skipped
        self.counted = 0
        self.forwards = [self._counted(f, sp["batch"] * sp["post_nms"])
                         for f, sp in zip(self.forwards, self.specs)]
        self.tester.detect_outputs = self._keeping(self.tester.detect_outputs)

    def _counted(self, fwd, rois):
        """``fwd``, reading the mask roi counter after each forward's
        dispatch: ``rois`` less those the branch ran on is short."""
        def counted(*args):
            out = fwd(*args)
            ran = self.detector.MASK_ROIS
            self.counted += ran
            self.short += max(0, rois - ran)
            return out
        return counted

    def _keeping(self, detect):
        """The Tester's ``detect_outputs``, keeping the last batch's decoded
        masks for ``_offer``."""
        def keeping(*args):
            res = detect(*args)
            self.last_masks = res[3]
            return res
        return keeping

    def _offer(self, s, r, j, out, scores, boxes):
        """pyramid.Pyramid._offer, the batch's decoded masks with it."""
        super()._offer(s, r, j, out, scores, boxes)
        for it in self.reservoir[s]:
            if it["out"] is out:
                it["masks"] = self.last_masks

    def round_flops(self):
        k = self.traffic["round_images"]
        ref = mask_reference_model(self.config)
        masks = sum(mask_flops(ref, sp["batch"] * sp["post_nms"])
                    * (k // sp["batch"]) for sp in self.specs)
        return super().round_flops() + masks

    def kernel_bounds(self, seen):
        """pyramid.Pyramid's, the fused pool's with the mask pool's passes
        at 14x14."""
        b = super().kernel_bounds(seen)
        for s, _ in seen:
            sp = self.specs[s]
            B, (ch, cw) = sp["batch"], sp["canvas"]
            b["fused_pool"] += yk.pool(B, ch // 16, cw // 16, 256,
                                       B * sp["post_nms"], P=MASK_POOLED)
        return b

    def samples(self):
        """pyramid.Pyramid's samples with their decoded masks, and the
        mask head's own inputs and outputs: each sampled batch once more
        through its scale's forward, outside the window, the input of the
        program's MaskHead (its 14x14 pooled features) kept by a forward
        pre-hook, with that forward's mask probabilities, argmax classes
        and kept rois."""
        out = super().samples()
        items = [it for res in self.reservoir for it in res]
        pooled = []
        hook = self.model.mask.register_forward_pre_hook(
            lambda _m, args: pooled.append(args[0]))
        try:
            for sample, it in zip(out, items):
                sample["masks"] = it.get("masks")
                s = it["scale"]
                again = self.forwards[s](sample["data"], self.infos[s][0])
                sample.update(head_pooled=pooled.pop(),
                              head_masks=again["mask_prob"],
                              head_cls=again["cls_prob"][..., 1:].argmax(-1),
                              head_valid=again["roi_valid"])
        finally:
            hook.remove()
        return out


def run(ctx):
    py = MaskPyramid(ctx)
    tr = py.traffic
    py.loop(rounds=int(tr["warmup_rounds"]))
    pyramid._sync(py.device)
    setup_s = ctx.clock() - ctx.t_start
    ctx.window_starts()
    py.short = py.counted = 0
    rounds, window_s = py.loop(seconds=ctx.seconds, keep=True, spans=True)
    pyramid._sync(py.device)
    images = rounds * tr["round_images"]
    rec = dict(window_s=window_s, rounds=rounds, units=rounds, images=images,
               spans=py.spans, round_flops=py.round_flops(),
               masked_rois=py.counted)
    ctx.window_ends(rec)
    if ctx.trace:
        seen = []
        with Profiled() as prof:
            with prof.slice():
                py.loop(rounds=int(tr["traced_rounds"]), seen=seen)
                pyramid._sync(py.device)
        rec["trace"] = prof.summary(yk.group_of)
        rec["span_table"] = prof.table
        rec["slice_units"] = int(tr["traced_rounds"])
        rec["bounds"] = py.kernel_bounds(seen)
        del seen
    e2e = {"infer_img_per_s": images / window_s,
           "setup_s": setup_s}
    q = np.percentile(py.spans["round"], [50, 90, 95, 99, 100]) * 1e3
    ctx.note(f"{rounds} rounds, {py.counted} rois masked; round ms "
             "p50/p90/p95/p99/max " + "/".join(f"{v:.2f}" for v in q))
    short = py.short
    samples = py.samples()
    del py
    ctx.free()
    return dict(e2e=e2e, record=rec, checks=judge(ctx, samples, short),
                attempted=images, failed=0)


class _Kept:
    """The reference seen by compare.compare_detections, keeping what it
    computed: its own inference (the roi map) and its head's class
    probabilities on the program's rois."""

    def __init__(self, ref):
        self.ref = ref
        self.out = self.cls_prob = None

    def infer(self, *args):
        self.out = self.ref.infer(*args)
        return self.out

    def head(self, *args):
        self.cls_prob, bbox = self.ref.head(*args)
        return self.cls_prob, bbox


def compare_masks(ref, sample, nms_thresh):
    """compare_detections' numbers of one sampled batch, and its
    mask_gap, class_flip and short masks."""
    kept = _Kept(ref)
    row = compare.compare_detections(kept, sample, nms_thresh)
    valid = sample["roi_valid"]
    prog_cls = np.stack([s[:, 1:].argmax(1) for s in sample["scores"]])
    ref_cls = kept.cls_prob[..., 1:].argmax(-1).cpu().numpy()
    dev = sample["data"].device
    with torch.no_grad():
        want = ref.mask_prob(kept.out["roi_map"],
                             torch.as_tensor(sample["rois"], device=dev),
                             torch.as_tensor(prog_cls, device=dev))
    want = want.cpu().numpy()
    gap, short = 0.0, 0
    masks = sample.get("masks") or []
    for i in range(valid.shape[0]):
        n_kept = int(valid[i].sum())
        got = masks[i] if i < len(masks) else np.zeros((0,) + want.shape[2:])
        have = min(len(got), valid.shape[1])
        rows = np.nonzero(valid[i][:have])[0]
        good = np.isfinite(got[rows]).all(axis=(1, 2))
        short += n_kept - int(good.sum())
        if good.any():
            r = rows[good]
            gap = max(gap, float(np.abs(got[r] - want[i, r]).max()))
    flips = (prog_cls != ref_cls)[valid]
    row.update(mask_gap=gap, class_flip=float(flips.mean()) if flips.size
               else 0.0, mask_short=float(short))
    pooled, cls, hv = (sample[k] for k in ("head_pooled", "head_cls",
                                           "head_valid"))
    if pooled.shape[0] != cls.numel():
        # the head ran on other rois than the batch's: no gap to read, and
        # a probability's gap is at most 1
        row["mask_head_gap"] = 1.0
        return row
    with torch.no_grad():
        head = ref.mask_from_pooled(pooled, cls)
    row["mask_head_gap"] = float((sample["head_masks"].float() - head)
                                 .abs()[hv].max()) if hv.any() else 0.0
    return row


def judge(ctx, samples, short):
    """The compared numbers of the sampled batches, the worst over them,
    and the window's skipped rois added to mask_short."""
    config = ctx.cell["config"]
    ref = mask_reference_model(config, ctx.device)
    ref.load_state_dict(mask_seeded_weights(config, ctx.seed, ctx.device))
    ref.eval()
    thresh = float(config["yml"]["TEST"]["RPN_NMS_THRESH"])
    with ctx.fp32():
        rows = [compare_masks(ref, s, thresh) for s in samples]
    worst = compare.worst(rows)
    worst["mask_short"] = worst.get("mask_short", 0.0) + float(short)
    return [(k, worst[k], lim) for k, lim in ctx.cell["limits"].items()]
