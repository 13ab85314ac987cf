"""Loss functions with the reference's normalizations.

Port of sniper_tpu/models/losses.py:20-184:

- softmax CE with ignore label -1 and 'valid' normalization (the sum over
  non-ignored entries / max(count, 1)), logits cast to fp32 first;
- smooth-L1 (sigma 1) box losses with the reference's scales: RPN
  3 / (B * RPN_BATCH_SIZE), R-CNN 1 / (188 * B), 188 = 4 coordinates x ~47
  expected fg rois;
- the RPN terms from dense target grids or from the chip loader's sparse
  (pid, value) pairs, which give the same values;
- the mask term: the valid-normalized CE over every target cell of the
  mask rois, -1 ignored;
- the AutoFocus term: the valid-normalized CE of the FocusPixel logits
  against the chip loader's ``scale_label``, -1 (don't care) ignored;
- OHEM (TRAIN.ENABLE_OHEM, ops/ohem.py): before the R-CNN terms, only the
  hardest sampled rois of each image keep their labels and box weights.

Under data parallelism each rank computes its share of the one global loss
of the JAX package's step (sniper_tpu/train/trainer.py:82-160): the CE
terms divide the rank's sum by the global valid count (an all-reduce of
the count, without gradient; under OHEM the count of the kept rois), and
the box terms by the global ``batch_images`` their caller passes. The
shares add up over the ranks to the loss of the joined batch.
"""

from __future__ import annotations

import torch

from sniper_tpu_torch.ops.ohem import ohem_select
from sniper_tpu_torch.parallel.distributed import global_count


def smooth_l1(x):
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def _nll(logits, labels):
    """Each entry's CE, fp32: logits [..., C], labels [...] int, 0 where
    the label is -1 (ignored)."""
    labels = labels.long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
    return torch.where(labels >= 0, nll, 0.0)


def softmax_ce_ignore(logits, labels):
    """Valid-normalized CE. logits [..., C], labels [...] int with -1
    ignore; the valid count is the global one across the ranks of a
    process group. Returns a 0-d fp32 tensor."""
    valid = labels >= 0
    return (_nll(logits, labels).sum()
            / global_count(valid.sum()).clamp_min(1))


def _rpn_logits(rpn_cls_logits):
    """[B,H,W,2,A] -> [B, A*H*W, 2] in the loader's (A,H,W) order."""
    b, h, w, _, a = rpn_cls_logits.shape
    return rpn_cls_logits.permute(0, 4, 1, 2, 3).reshape(b, a * h * w, 2)


def rpn_cls_loss(rpn_cls_logits, rpn_labels):
    """rpn_labels [B, A*H*W] in {-1, 0, 1}."""
    return softmax_ce_ignore(_rpn_logits(rpn_cls_logits), rpn_labels)


def rpn_bbox_loss(rpn_bbox_pred, bbox_targets, bbox_weights, batch_images,
                  rpn_batch_size=256):
    """All [B,4A,H,W]. Scale 3/(B*RPN_BATCH_SIZE)."""
    diff = (rpn_bbox_pred - bbox_targets).float()
    loss = (bbox_weights * smooth_l1(diff)).sum()
    return loss * 3.0 / float(batch_images * rpn_batch_size)


def rpn_cls_loss_sparse(rpn_cls_logits, rpn_pids, rpn_label_vals):
    """Gather the sampled anchors' logits: rpn_pids [B,S] (A,H,W)-flat
    indices padded -1; rpn_label_vals [B,S] in {-1, 0, 1}."""
    logits = _rpn_logits(rpn_cls_logits)
    idx = rpn_pids.long().clamp_min(0)
    picked = torch.gather(logits, 1, idx[..., None].expand(-1, -1, 2))
    labels = torch.where(rpn_pids >= 0, rpn_label_vals.float(), -1.0)
    return softmax_ce_ignore(picked, labels)


def rpn_bbox_loss_sparse(rpn_bbox_pred, fg_pids, fg_targets, batch_images,
                         rpn_batch_size=256):
    """Gather predictions at the fg anchors: rpn_bbox_pred [B,4A,H,W]
    (channel a*4 + coordinate), fg_pids [B,F] padded -1, fg_targets
    [B,F,4]."""
    b, c4, h, w = rpn_bbox_pred.shape
    a = c4 // 4
    pred = rpn_bbox_pred.reshape(b, a, 4, h, w).permute(0, 1, 3, 4, 2)
    pred = pred.reshape(b, a * h * w, 4)
    idx = fg_pids.long().clamp_min(0)
    picked = torch.gather(pred, 1, idx[..., None].expand(-1, -1, 4))
    per = smooth_l1((picked - fg_targets).float()).sum(-1)
    loss = torch.where(fg_pids >= 0, per, 0.0).sum()
    return loss * 3.0 / float(batch_images * rpn_batch_size)


def rcnn_cls_loss(cls_score, labels):
    """cls_score [B,R,C], labels [B,R] with -1 ignore."""
    return softmax_ce_ignore(cls_score, labels)


def rcnn_bbox_loss(bbox_pred, bbox_targets, bbox_weights, batch_images):
    """All [B,R,4]. Scale 1/(188*B)."""
    diff = (bbox_pred - bbox_targets).float()
    loss = (bbox_weights * smooth_l1(diff)).sum()
    return loss / (188.0 * float(batch_images))


def focus_loss(focus_logits, focus_labels):
    """focus_logits [B,H,W,2], focus_labels [B,H*W] in {-1, 0, 1}."""
    b, h, w, _ = focus_logits.shape
    return softmax_ce_ignore(focus_logits.reshape(b, h * w, 2), focus_labels)


def mask_loss(mask_logits, mask_targets):
    """mask_logits [M,S,S,2], mask_targets [M,S,S] in {-1, 0, 1}."""
    return softmax_ce_ignore(mask_logits, mask_targets)


def _ohem(outputs, labels, weights, ohem_rois):
    """ohem_select on each roi's cls loss (``_nll``) and box loss (the
    weighted smooth-L1 summed over the 4 coordinates), both fp32 [B,R].
    The selection carries no gradient: the R-CNN terms take theirs through
    the kept rois."""
    with torch.no_grad():
        diff = (outputs["bbox_pred"] - outputs["rcnn_bbox_targets"]).float()
        return ohem_select(_nll(outputs["cls_score"], labels),
                           (weights * smooth_l1(diff)).sum(-1), labels,
                           weights, ohem_rois)


def total_loss(outputs, batch, batch_images, rpn_batch_size=256,
               rpn_only=False, ohem_rois=0):
    """The training loss from the detector's outputs and a loader batch,
    which carries either the sparse RPN targets ('rpn_pids',
    'rpn_label_vals' [B,S], 'fg_pids' [B,F], 'fg_targets' [B,F,4]) or dense
    ones ('label' [B,A*H*W], 'bbox_target' / 'bbox_weight' [B,4A,H,W]).
    ``rpn_only`` (TRAIN.ONLY_PROPOSAL) sums the two RPN terms only;
    outputs with 'focus_logits' (the AutoFocus head's) add the FocusPixel
    term against the batch's 'scale_label' [B,H*W] when the batch has one
    (the loader ships it under TRAIN.AUTO_FOCUS; metric ``focus_loss``);
    outputs with ``mask_logits`` (the mask branch's) add the mask term.
    ``ohem_rois`` > 0 (TRAIN.BATCH_ROIS_OHEM under TRAIN.ENABLE_OHEM) keeps
    only the hardest ``ohem_rois`` rois of each image in the R-CNN terms
    (``_ohem``). Returns (loss, metrics dict of 0-d tensors)."""
    if "rpn_pids" in batch:
        l_rpn_cls = rpn_cls_loss_sparse(
            outputs["rpn_cls_logits"], batch["rpn_pids"],
            batch["rpn_label_vals"])
        l_rpn_bbox = rpn_bbox_loss_sparse(
            outputs["rpn_bbox_pred"], batch["fg_pids"], batch["fg_targets"],
            batch_images, rpn_batch_size)
    else:
        l_rpn_cls = rpn_cls_loss(outputs["rpn_cls_logits"], batch["label"])
        l_rpn_bbox = rpn_bbox_loss(
            outputs["rpn_bbox_pred"], batch["bbox_target"],
            batch["bbox_weight"], batch_images, rpn_batch_size)
    if rpn_only:
        loss = l_rpn_cls + l_rpn_bbox
        return loss, {"rpn_cls_loss": l_rpn_cls, "rpn_bbox_loss": l_rpn_bbox,
                      "loss": loss}
    labels = outputs["rcnn_labels"]
    weights = outputs["rcnn_bbox_weights"]
    if ohem_rois:
        labels, weights = _ohem(outputs, labels, weights, ohem_rois)
    l_rcnn_cls = rcnn_cls_loss(outputs["cls_score"], labels)
    l_rcnn_bbox = rcnn_bbox_loss(
        outputs["bbox_pred"], outputs["rcnn_bbox_targets"], weights,
        batch_images)
    loss = l_rpn_cls + l_rpn_bbox + l_rcnn_cls + l_rcnn_bbox
    metrics = {
        "rpn_cls_loss": l_rpn_cls,
        "rpn_bbox_loss": l_rpn_bbox,
        "rcnn_cls_loss": l_rcnn_cls,
        "rcnn_bbox_loss": l_rcnn_bbox,
    }
    if "focus_logits" in outputs and "scale_label" in batch:
        l_focus = focus_loss(outputs["focus_logits"], batch["scale_label"])
        loss = loss + l_focus
        metrics["focus_loss"] = l_focus
    if "mask_logits" in outputs:
        l_mask = mask_loss(outputs["mask_logits"], outputs["mask_targets"])
        loss = loss + l_mask
        metrics["mask_loss"] = l_mask
    metrics["loss"] = loss
    return loss, metrics
