"""What decides ``correct``: the program's outputs held against the
reference's, each number beside its limit.

Pyramid cells (``compare_detections``), per sampled batch: the reference
runs its fp32 trunk, RPN and proposals on the same canvases, and its head
on the program's own rois, then decodes as the Tester does.

- ``score_gap``: the widest gap between a detection score of the program
  (the Tester's per-roi class probabilities) and the reference's;
- ``box_gap``: the widest gap between a decoded box corner of the program
  and the reference's, in units of its roi's size;
- ``roi_miss``: the share of the reference's proposals that no proposal of
  the program overlaps at IoU >= the NMS threshold;
- ``nms_iou``: the largest IoU between two proposals the program kept in
  one image; the yml's RPN_NMS_THRESH is its limit.

Training cells (``compare_training``), over the first three steps. The
reference follows the program's own sample of rois at each step (the
sampler's choice among near-tied proposals would otherwise move whole
rois between the two sides on rounding alone), and the sample is checked
by itself at step 1 against the reference's own:

- ``roi_miss``: the share of the reference's sampled rois that no sampled
  roi of the program overlaps at IoU >= the NMS threshold;
- ``label_gap``: the share of the program's sampled rois whose label
  (class or background) is not the one their overlap with the GT boxes
  gives;
- ``loss_gap``: the widest relative gap of a step's loss;
- ``delta_gap``: the worst leaf's gap between the norms of each
  parameter's change over the three steps, over the larger of the
  reference leaf's norm and the median leaf's, among the leaves whose
  reference gradient is at least a thousandth of the median leaf's;
- ``replay_roi_miss``, ``replay_loss_gap``, ``replay_delta_gap``: the
  same three of the steps that the window's path takes, replayed from a
  CUDA graph (drivers/train_step.py), against a second reference run that
  follows their own sample (two runs of the program part on near-tied
  rois by rounding); for a side with no replayed steps, the control, its
  own three again;
- ``replay_label_gap``: ``label_gap`` of the replayed steps' samples, each
  step's against that step's own GT boxes, over all three steps (for the
  control, over its own three samples);
- ``eager_in_replay`` (counted in drivers/train_step.py): the compared
  replayed steps that ran eagerly on a CUDA card.

The same gap of the first gradient as the optimizer got it
(``worst_leaves``) is read and printed but not compared: neither the
control nor a fault of the program reads it far enough above sound runs
(PERF.md).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import ops
from benchmark.reference.model import is_fixed, lr_at

TRAIN_STEPS = 3


def _decode(rois, cls_prob, bbox, valid, im_info, im_scale):
    """The Tester's host decode of one image: scores [N,C] (zero where the
    roi is not valid), boxes [N,4] in the original image."""
    boxes = ops.bbox_pred(rois[:, 1:], bbox)
    boxes = ops.clip_boxes(boxes, im_info[:2]) / im_scale
    return np.where(valid[:, None], cls_prob, 0.0), boxes


@torch.no_grad()
def compare_detections(ref, sample, nms_thresh):
    """One sampled batch: ``sample`` has data (uint8 canvases on the
    device), im_info [B,3] (NumPy), post_nms, and the program's rois
    [B,N,5], roi_valid [B,N] (NumPy) and the Tester's per-image scores and
    boxes. Returns {number: value}."""
    data = sample["data"]
    info = torch.as_tensor(sample["im_info"], device=data.device)
    out = ref.infer(data, info, sample["post_nms"])
    rois = torch.as_tensor(sample["rois"], device=data.device)
    cls_prob, bbox = ref.head(out["roi_map"], rois)
    cls_prob, bbox = cls_prob.cpu().numpy(), bbox.cpu().numpy()
    p_rois, p_valid = sample["rois"], sample["roi_valid"]
    score_gap = box_gap = 0.0
    for i in range(p_rois.shape[0]):
        info_i = sample["im_info"][i]
        scores, boxes = _decode(p_rois[i], cls_prob[i], bbox[i], p_valid[i],
                                info_i, info_i[2])
        score_gap = max(score_gap, float(np.abs(
            sample["scores"][i] - scores).max()))
        size = np.maximum(
            np.stack([p_rois[i, :, 3] - p_rois[i, :, 1] + 1,
                      p_rois[i, :, 4] - p_rois[i, :, 2] + 1], 1) / info_i[2],
            1.0)
        err = np.abs(sample["boxes"][i] - boxes) / np.tile(size, 2)
        box_gap = max(box_gap, float(err[p_valid[i]].max(initial=0.0)))
    r_rois, r_valid = out["rois"], out["roi_valid"]
    prog = torch.as_tensor(p_rois, device=data.device)
    prog_valid = torch.as_tensor(p_valid, device=data.device)
    missed = total = 0
    for i in range(prog.shape[0]):
        rb = r_rois[i, r_valid[i], 1:]
        pb = prog[i, prog_valid[i], 1:]
        total += rb.shape[0]
        if pb.shape[0] == 0:
            missed += rb.shape[0]
            continue
        iou = torch.as_tensor(ops.bbox_overlaps(rb.double().cpu().numpy(),
                                                pb.double().cpu().numpy()))
        missed += int((iou.max(1).values < nms_thresh).sum())
    nms_iou = float(ops.pair_iou_max(prog[..., 1:], prog_valid).max())
    return dict(score_gap=score_gap, box_gap=box_gap,
                roi_miss=missed / max(total, 1), nms_iou=nms_iou)


def worst(rows):
    """The worst of several samples' readings, number by number."""
    out = {}
    for r in rows:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def reference_steps(ref, cfg, batches, priorities, weights, fixed,
                    given=None):
    """The reference's first TRAIN_STEPS steps from ``weights``: (losses,
    the first gradient {leaf: tensor}, the change after the steps {leaf:
    tensor}, its own sample at step 1). ``given`` is a sample per step
    that the losses follow (the program's)."""
    ref.load_state_dict(weights)
    ref.train()
    params = []
    for name, p in ref.named_parameters():
        p.requires_grad_(not is_fixed(name, fixed))
        if p.requires_grad:
            params.append((name, p))
    tr = cfg["TRAIN"]
    opt = torch.optim.SGD([p for _, p in params], lr=1.0,
                          momentum=tr["momentum"], weight_decay=tr["wd"])
    losses, grad1, own1 = [], {}, None
    for k in range(TRAIN_STEPS):
        for g in opt.param_groups:
            g["lr"] = lr_at(cfg, k)
        opt.zero_grad(set_to_none=True)
        loss, _, own = ref.loss(batches[k], priorities[k],
                                None if given is None else given[k])
        loss.backward()
        losses.append(float(loss.detach()))
        if k == 0:
            grad1 = {n: p.grad.detach().clone() for n, p in params}
            own1 = tuple(t.detach() for t in own[:2])
        opt.step()
    delta = {n: (p.detach() - weights[n]) for n, p in params}
    return losses, grad1, delta, own1


def _mislabelled(sample, gt_boxes, fg_thresh):
    """(wrong, taken): of the program's sampled (rois, labels) of one step,
    the rois whose label is not the one their overlap with the batch's GT
    boxes [B,G,5] gives, and all of them."""
    rois, labels = (t.cpu().numpy() for t in sample[:2])
    gts = gt_boxes.cpu().numpy()
    wrong = taken = 0
    for i in range(rois.shape[0]):
        mine = rois[i, labels[i] >= 0, 1:].astype(np.float64)
        if len(mine) == 0:
            continue
        gt = gts[i, gts[i, :, 4] >= 0]
        iou = ops.bbox_overlaps(mine, gt[:, :4].astype(np.float64))
        best = iou.argmax(1)
        want = np.where(iou.max(1) >= fg_thresh, gt[best, 4], 0)
        wrong += int((want != labels[i, labels[i] >= 0]).sum())
        taken += len(mine)
    return wrong, taken


def sample_check(sample, own, gt_boxes, fg_thresh, iou_thresh):
    """(roi_miss, label_gap) of the program's sampled (rois, labels) at
    step 1 against the reference's own sample ``own`` and the batch's GT
    boxes [B,G,5]."""
    rois, labels = (t.cpu().numpy() for t in sample[:2])
    r_rois, r_labels = (t.cpu().numpy() for t in own)
    missed = total = 0
    for i in range(rois.shape[0]):
        mine = rois[i, labels[i] >= 0, 1:].astype(np.float64)
        ref_r = r_rois[i, r_labels[i] >= 0, 1:].astype(np.float64)
        total += len(ref_r)
        if len(mine) == 0:
            missed += len(ref_r)
        elif len(ref_r):
            missed += int((ops.bbox_overlaps(ref_r, mine).max(1)
                           < iou_thresh).sum())
    wrong, taken = _mislabelled(sample, gt_boxes, fg_thresh)
    return missed / max(total, 1), wrong / max(taken, 1)


def steps_label_gap(samples, gt_boxes, fg_thresh):
    """``label_gap`` over every step's sample, each against its own
    batch's GT boxes (``gt_boxes``, one per step)."""
    counts = [_mislabelled(s, g, fg_thresh)
              for s, g in zip(samples, gt_boxes)]
    return sum(w for w, _ in counts) / max(sum(t for _, t in counts), 1)


def _norms(d):
    return {k: float(v.double().norm()) for k, v in d.items()}


def compare_training(side, ref_run, gt_boxes, fg_thresh, iou_thresh):
    """``side`` is (losses, grad1, delta, the sample of each step) of the
    program (or the control), ``ref_run`` the reference's
    ``reference_steps`` following that sample, ``gt_boxes`` each step's.
    Returns {number: value}; ``steps_label_gap`` is over all the steps."""
    losses, grad1, delta, samples = side
    r_losses, r_grad1, r_delta, own1 = ref_run
    roi_miss, label_gap = sample_check(samples[0], own1, gt_boxes[0],
                                       fg_thresh, iou_thresh)
    loss_gap = max(abs(a - b) / max(abs(b), 1e-12)
                   for a, b in zip(losses, r_losses))
    rg = _norms(r_grad1)
    med = float(np.median(list(rg.values())))
    rd, pd = _norms(r_delta), _norms(delta)
    keep = [k for k in rd if rg[k] >= 1e-3 * med]
    med_d = float(np.median([rd[k] for k in keep]))
    delta_gap = max(abs(pd[k] - rd[k]) / max(rd[k], med_d) for k in keep)
    return dict(roi_miss=roi_miss, label_gap=label_gap, loss_gap=loss_gap,
                delta_gap=delta_gap,
                steps_label_gap=steps_label_gap(samples, gt_boxes,
                                                fg_thresh))


def with_replay(nums, replayed=None):
    """``nums`` of the eager steps with the ``replay_*`` numbers of
    ``replayed`` (the replayed steps' ``compare_training``), or of ``nums``
    itself where there are none."""
    r = nums if replayed is None else replayed
    return dict(nums, replay_roi_miss=r["roi_miss"],
                replay_label_gap=r["steps_label_gap"],
                replay_loss_gap=r["loss_gap"],
                replay_delta_gap=r["delta_gap"])


def worst_leaves(side, ref_run, n=4):
    """The leaves with the widest gaps of the first gradient's norm (each
    over the larger of the reference leaf's norm and the median leaf's),
    with each leaf's norm over the median's: [[leaf, gap, ratio]]."""
    rg, pg = _norms(ref_run[1]), _norms(side[1])
    med = float(np.median(list(rg.values())))
    gaps = sorted(((abs(pg[k] - rg[k]) / max(rg[k], med), k) for k in rg),
                  reverse=True)
    return [[k, g, rg[k] / med] for g, k in gaps[:n]]
