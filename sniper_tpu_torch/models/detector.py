"""The SNIPER detector: training and inference branches.

Port of sniper_tpu/models/detector.py:114-223,294-354: trunk -> its
detection map -> RPN -> softmax over the {bg, fg} axis -> ``conv_new_1`` +
ReLU cast to fp32, then

- inference: ``multi_proposal`` -> the deformable R-CNN head, its pool
  on the route of ``pool_kernel`` (network.POOL_KERNEL: "fused", or
  "pallas", the patch route of the JAX detector's ``pallas`` backend) ->
  class softmax and ``bbox_pred * stds + means``; with ``with_mask``, the
  mask branch on every kept roi: the 14x14 two-pass pool
  (``fused_offset_pool`` with the ``mask_offset`` FC, the kernels of the
  box head's 7x7 pool) -> ``MaskHead`` -> the neg and pos planes of each
  roi's argmax foreground class -> softmax over the pair -> ``mask_prob``.
  The JAX package pools its mask branch through the einsum route only
  because the 14x14 pool overflows a TPU core's VMEM;
- training: ``multi_proposal_target`` (proposals, GT candidates, valid
  ranges, the fg/bg sample) -> the head on the sampled rois, returning what
  the losses need and the offset telemetry; with ``with_mask``
  (detector.py:224-291) also the mask branch on the first
  ``num_mask_rois`` sampled rois of each image (fg first), trained through
  the 14x14 pool's backward, with each roi's targets crop-resized from the
  batch's dense GT masks (ops/mask_target.py);
- ``autofocus`` (detector.py:171-174,222,316-317): the FocusPixel head
  (``AutoFocusHead``, the child ``autofocus``) on the same C4||C5 map;
  inference adds ``focus_prob`` [B,H,W] (the softmax's focus channel) at
  every scale, training ``focus_logits`` [B,H,W,2] for ``focus_loss``;
- ``rpn_only`` (TRAIN.ONLY_PROPOSAL, detector.py:153-165): no
  ``conv_new_1``, R-CNN, mask or FocusPixel modules; training returns the
  RPN outputs and the trunk's telemetry, inference the proposals of
  ``multi_proposal``.

The trunk (``trunk_type``, detector.py:114-145): ``"resnet"`` (R101/R50,
models/resnet.py) or ``"resnext"`` (X101, models/resnext.py), C4||C5 at
stride 16, or ``"mobilenetv2"`` (models/mobilenetv2.py), one map at stride
32 with ``head_fc_dim`` 512 in the registry. Each trunk's ``feature`` is its
detection map in the compute dtype, ``out_channels`` wide, which the RPN,
``conv_new_1`` and the FocusPixel head read. The JAX detector casts
MobileNetV2's map to fp32, and those convs cast it back to the compute
dtype.

``bn_mode`` (network.BN_MODE through the registry) is whose statistics the
trunk's training-mode BatchNorms use across the ranks of a process group:
the global batch's ("sync") or each rank's own ("local"); see
models/norm.py.

Under a profiler, the forward's layers are the flat spans (utils/profiler.
span) ``trunk``; ``rpn``: the RPN convs and softmax, then the proposals
(and the training sample); ``head``: ``conv_new_1``, the R-CNN head, its
softmax and denormalisation, the FocusPixel branch and the training mask
branch; ``mask``: the inference mask branch (the 14x14 pool, ``MaskHead``,
the plane pick and the softmax), after ``head`` closes. ``MASK_ROIS``
counts the rois the inference mask branch ran on in the last forward.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from sniper_tpu_torch.models.heads import (
    AutoFocusHead,
    MaskHead,
    RCNNHead,
    RPNHead,
)
from sniper_tpu_torch.models.mobilenetv2 import MobileNetV2Trunk
from sniper_tpu_torch.models.norm import BN_MODES, TrainBatchNorm
from sniper_tpu_torch.models.resnet import ResNetTrunk, conv
from sniper_tpu_torch.models.resnext import ResNeXtTrunk
from sniper_tpu_torch.ops.anchors import make_anchors_ahw
from sniper_tpu_torch.ops.deform import POOL_ROUTES, fused_offset_pool
from sniper_tpu_torch.ops.mask_target import mask_targets_from_dense
from sniper_tpu_torch.ops.proposals import (
    multi_proposal,
    multi_proposal_target,
)
from sniper_tpu_torch.utils.profiler import span

NUM_MASK_ROIS = 50  # sampled rois per image that train the mask branch
# the rois the mask branch ran on in the last inference forward: reset at
# its start, bumped by _mask_prob on the host as it enqueues the branch
MASK_ROIS = 0


class SNIPERDetector(nn.Module):
    def __init__(
        self,
        num_classes: int = 81,
        num_anchors: int = 21,
        anchor_ratios: Sequence[float] = (0.5, 1, 2),
        anchor_scales: Sequence[float] = (2, 4, 7, 10, 13, 16, 24),
        feat_stride: int = 16,
        trunk_type: str = "resnet",
        units: Sequence[int] = (3, 4, 23, 3),
        head_fc_dim: int = 1024,
        head_margin_bins: int = 1,
        dtype: torch.dtype = torch.bfloat16,
        pre_nms_top_n: int = 6000,
        post_nms_top_n: int = 300,
        nms_thresh: float = 0.7,
        rpn_min_size: float = 0.0,
        train_pre_nms: int = 6000,
        train_post_nms: int = 300,
        train_nms_thresh: float = 0.7,
        train_min_size: float = 0.0,
        num_rois: int = 300,
        fg_fraction: float = 0.25,
        fg_thresh: float = 0.5,
        bg_thresh_hi: float = 0.5,
        bg_thresh_lo: float = 0.0,
        bbox_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
        bbox_means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
        autofocus: bool = False,
        with_mask: bool = False,
        rpn_only: bool = False,
        bn_mode: str = "sync",
        pool_kernel: str = "fused",
    ):
        super().__init__()
        self.num_classes = num_classes
        self.num_anchors = num_anchors
        self.anchor_ratios = tuple(anchor_ratios)
        self.anchor_scales = tuple(anchor_scales)
        self.feat_stride = feat_stride
        self.dtype = dtype
        self.pre_nms_top_n = pre_nms_top_n
        self.post_nms_top_n = post_nms_top_n
        self.nms_thresh = nms_thresh
        self.rpn_min_size = rpn_min_size
        # the TRAIN.* proposal and sampler knobs (the reference's
        # MultiProposalTarget attributes); num_rois is the sampled roi
        # count per image
        self.train_kw = dict(
            pre_nms=train_pre_nms, post_nms=train_post_nms,
            thresh=train_nms_thresh, min_size=train_min_size,
            num_rois=num_rois, fg_fraction=fg_fraction, fg_thresh=fg_thresh,
            bg_thresh_hi=bg_thresh_hi, bg_thresh_lo=bg_thresh_lo)
        self.num_rois = num_rois
        self.register_buffer("bbox_stds", torch.tensor(bbox_stds),
                             persistent=False)
        self.register_buffer("bbox_means", torch.tensor(bbox_means),
                             persistent=False)
        self.trunk_type = trunk_type
        if trunk_type == "resnet":
            self.trunk = ResNetTrunk(units=units, dtype=dtype)
        elif trunk_type == "resnext":
            self.trunk = ResNeXtTrunk(units=units, dtype=dtype)
        elif trunk_type == "mobilenetv2":
            self.trunk = MobileNetV2Trunk(dtype=dtype)
        else:
            raise ValueError(f"unknown trunk_type {trunk_type!r}")
        feat_ch = self.trunk.out_channels
        self.rpn = RPNHead(feat_ch, num_anchors)
        self.rpn_only = rpn_only
        self.with_mask = with_mask and not rpn_only
        self.mask_size = 28  # the mask head's deconv doubles the 14x14 pool
        self.num_mask_rois = NUM_MASK_ROIS
        self.head_margin_bins = head_margin_bins
        # the R-CNN head's inference pool route (network.POOL_KERNEL,
        # resolved by the registry): "fused" (the fused pool kernels) or
        # "pallas" (the patch route: the ROI patch kernel, then torch ops;
        # forward only). Training pools through "fused" whatever it says,
        # as the JAX detector trains "pallas" on its differentiable route,
        # and the mask pool always does, as the JAX mask pool ignores the key
        if pool_kernel not in POOL_ROUTES:
            raise ValueError(f"pool_kernel must be {'|'.join(POOL_ROUTES)}, "
                             f"got {pool_kernel!r}")
        self.pool_kernel = pool_kernel
        if not rpn_only:
            self.conv_new_1 = nn.Conv2d(feat_ch, 256, 1)
            self.rcnn = RCNNHead(num_classes, spatial_scale=1.0 / feat_stride,
                                 fc_dim=head_fc_dim,
                                 margin_bins=head_margin_bins)
        # the FocusPixel head: JAX's RPN-only branch returns before it
        self.with_autofocus = autofocus and not rpn_only
        if self.with_autofocus:
            self.autofocus = AutoFocusHead(feat_ch)
        if self.with_mask:
            # the 14x14 pool's offset FC: the first 196 outputs are dy
            self.mask_offset = nn.Linear(14 * 14 * 256, 2 * 14 * 14)
            self.mask = MaskHead(num_classes - 1)
        # whose statistics the training-mode BatchNorms use across the
        # ranks of a process group (models/norm.py)
        if bn_mode not in BN_MODES:
            raise ValueError(f"bn_mode must be sync|local, got {bn_mode!r}")
        for m in self.modules():
            if isinstance(m, TrainBatchNorm):
                m.mode = bn_mode
        self._anchors: dict = {}

    def anchors(self, fh: int, fw: int, device) -> torch.Tensor:
        key = (fh, fw, str(device))
        if key not in self._anchors:
            self._anchors[key] = torch.as_tensor(make_anchors_ahw(
                fh, fw, self.feat_stride, self.anchor_ratios,
                self.anchor_scales), device=device)
        return self._anchors[key]

    def _shared(self, data, stats=None):
        """Trunk and RPN: (feat, rpn cls logits [B,H,W,2,A], rpn bbox
        [B,4A,H,W], fg probs [B,A,H,W])."""
        x = data.permute(0, 3, 1, 2)  # channels_last NCHW view of NHWC data
        with span("trunk"):
            feat = self.trunk.feature(x, stats)
        with span("rpn"):
            rpn_cls_logits, rpn_bbox = self.rpn(feat)
            rpn_fg = torch.softmax(rpn_cls_logits, dim=3)[..., 1, :]
            rpn_fg = rpn_fg.permute(0, 3, 1, 2).contiguous()  # [B,A,H,W]
        return feat, rpn_cls_logits, rpn_bbox, rpn_fg

    def _roi_feat_map(self, feat):
        """conv_new_1 + ReLU: the roi map [B,H,W,256] fp32."""
        roi_feat_map = torch.relu(conv(self.conv_new_1, feat)).float()
        return roi_feat_map.permute(0, 2, 3, 1).contiguous()

    def forward(self, data: torch.Tensor, im_info: torch.Tensor,
                gt_boxes: torch.Tensor | None = None,
                valid_ranges: torch.Tensor | None = None, *,
                gt_masks: torch.Tensor | None = None,
                train: bool = False, post_nms_top_n: int | None = None,
                generator: torch.Generator | None = None,
                priorities=None):
        """data [B,H,W,3] fp32 (mean-subtracted), im_info [B,3] (h, w,
        scale).

        Inference returns rois [B,N,5], roi_scores [B,N], roi_valid [B,N],
        cls_prob [B,N,C] and bbox_pred [B,N,4] (std-denormalized), with N =
        ``post_nms_top_n`` (default: the model's), and with ``with_mask``
        mask_prob [B,N,S,S] (S = mask_size): each roi's foreground
        probability for its argmax foreground class, and with the AutoFocus
        head focus_prob [B,H,W] fp32 (H, W the stride-16 map). ``rpn_only``
        returns rois, roi_scores and roi_valid only.

        ``train=True`` also takes gt_boxes [B,G,5] and valid_ranges [B,2];
        the sampler draws from ``generator`` (or takes ``priorities``, see
        multi_proposal_target). It returns the RPN outputs, the sampled
        rois with their labels and targets, cls_score [B,R,C], bbox_pred
        [B,R,4] and ``stats``: the head's offset telemetry and the trunk's
        dcn_offset_max, as 0-d tensors; ``rpn_only`` the RPN outputs and
        ``stats`` with dcn_offset_max only. ``with_mask`` training also
        takes gt_masks [B,G,D,D] (the chip loader's box-normalized GT
        masks, uint8 or float in {0, 1}) and returns mask_logits
        [B*m,S,S,2] (each mask roi's neg and pos planes of its GT class)
        and mask_targets [B*m,S,S] in {-1, 0, 1}, m = min(num_mask_rois,
        num_rois); the AutoFocus head adds focus_logits [B,H,W,2] fp32."""
        if train:
            return self._train_forward(data, im_info, gt_boxes, valid_ranges,
                                       gt_masks, generator, priorities)
        global MASK_ROIS
        MASK_ROIS = 0
        n = post_nms_top_n or self.post_nms_top_n
        feat, _, rpn_bbox, rpn_fg = self._shared(data)
        b, fh, fw = feat.shape[0], feat.shape[2], feat.shape[3]
        with span("rpn"):
            rois, scores, valid = multi_proposal(
                rpn_fg, rpn_bbox, im_info, self.anchors(fh, fw, feat.device),
                pre_nms=self.pre_nms_top_n, post_nms=n,
                thresh=self.nms_thresh, min_size=self.rpn_min_size,
            )
        if self.rpn_only:
            return {"rois": rois, "roi_scores": scores, "roi_valid": valid}
        with span("head"):
            roi_feat_map = self._roi_feat_map(feat)
            cls_score, bbox_pred = self.rcnn(
                roi_feat_map, rois.reshape(-1, 5), extract=self.pool_kernel)
            cls_prob = torch.softmax(cls_score, dim=-1).reshape(b, n, -1)
            out = {
                "rois": rois,
                "roi_scores": scores,
                "roi_valid": valid,
                "cls_prob": cls_prob,
                "bbox_pred": (bbox_pred * self.bbox_stds
                              + self.bbox_means).reshape(b, n, 4),
            }
            if self.with_autofocus:
                out["focus_prob"] = torch.softmax(self.autofocus(feat),
                                                  dim=-1)[..., 1]
        if self.with_mask:
            out["mask_prob"] = self._mask_prob(roi_feat_map, rois, cls_prob)
        return out

    def _mask_prob(self, roi_feat_map, rois, cls_prob):
        """Pool every kept roi at 14x14, predict its argmax foreground
        class's neg/pos planes only, softmax over the pair (detector.py:
        318-353), in the span ``mask``; adds the B*N rois to MASK_ROIS.
        Returns [B,N,S,S]."""
        global MASK_ROIS
        b, n = rois.shape[:2]
        with span("mask"):
            logits = self.mask(self._mask_pool(roi_feat_map, rois, n))
            pair = self._class_planes(logits,
                                      cls_prob[..., 1:].argmax(dim=-1))
            S = self.mask_size
            prob = torch.softmax(pair, dim=-1)[..., 1].reshape(b, n, S, S)
        MASK_ROIS += b * n
        return prob

    def _mask_pool(self, roi_feat_map, rois, rois_per_image):
        """The 14x14 two-pass pool of rois [B, rpi, 5] with the
        ``mask_offset`` FC: [B*rpi, 14, 14, C] fp32."""
        C = roi_feat_map.shape[-1]
        return fused_offset_pool(
            roi_feat_map, rois.reshape(-1, 5), self.mask_offset.weight,
            self.mask_offset.bias, rois_per_image=rois_per_image,
            pooled_size=14, spatial_scale=1.0 / self.feat_stride,
            margin_bins=self.head_margin_bins).reshape(-1, 14, 14, C)

    def _class_planes(self, logits, cid):
        """Each roi's neg plane cid and pos plane cid + nfg of logits
        [R, S, S, 2*nfg], cid a foreground class index from 0: [R, S, S, 2]
        (the reference's pick and concat, mask symbol :396-401)."""
        S = self.mask_size
        idx = cid.reshape(-1, 1, 1, 1).expand(-1, S, S, 1)
        return torch.cat([logits.gather(-1, idx),
                          logits.gather(-1, idx + self.num_classes - 1)],
                         dim=-1)

    def _train_forward(self, data, im_info, gt_boxes, valid_ranges,
                       gt_masks, generator, priorities):
        if self.with_mask and gt_masks is None:
            # the usual cause: roidb entries without gt_masks (a dataset
            # built without load_mask, or a stale maskless roidb cache)
            raise ValueError(
                "with_mask=True but the batch has no gt_masks "
                "— build the dataset with load_mask=True "
                "(TRAIN.WITH_MASK) and check the roidb cache")
        dcn = []
        feat, rpn_cls_logits, rpn_bbox, rpn_fg = self._shared(data, dcn)
        if self.rpn_only:
            stats = ({"dcn_offset_max": torch.stack(dcn).amax()} if dcn
                     else {})
            return {"rpn_cls_logits": rpn_cls_logits,
                    "rpn_bbox_pred": rpn_bbox, "stats": stats}
        with span("head"):
            roi_feat_map = self._roi_feat_map(feat)
        b, fh, fw = feat.shape[0], feat.shape[2], feat.shape[3]
        with span("rpn"):
            tgt = multi_proposal_target(
                rpn_fg, rpn_bbox, im_info, gt_boxes, valid_ranges,
                self.anchors(fh, fw, feat.device), generator=generator,
                priorities=priorities, bbox_stds=self.bbox_stds,
                bbox_means=self.bbox_means, **self.train_kw)
        with span("head"):
            # the fused route whatever pool_kernel says: it has the backward
            cls_score, bbox_pred, off = self.rcnn(
                roi_feat_map, tgt.rois.reshape(-1, 5), extract="fused",
                return_offset=True)
            stats = self.rcnn.offset_stats(off)
            if dcn:
                stats["dcn_offset_max"] = torch.stack(dcn).amax()
            out = {
                "rpn_cls_logits": rpn_cls_logits,  # [B,H,W,2,A]
                "rpn_bbox_pred": rpn_bbox,         # [B,4A,H,W]
                "rois": tgt.rois,
                "rcnn_labels": tgt.labels,         # [B,R]
                "rcnn_bbox_targets": tgt.bbox_targets,
                "rcnn_bbox_weights": tgt.bbox_weights,
                "cls_score": cls_score.reshape(b, self.num_rois, -1),
                "bbox_pred": bbox_pred.reshape(b, self.num_rois, 4),
                "stats": stats,
            }
            if self.with_autofocus:
                out["focus_logits"] = self.autofocus(feat)
            if self.with_mask:
                # the first m sampled rois of each image: the sampler puts
                # its fg rois first
                m = min(self.num_mask_rois, self.num_rois)
                mask_rois = tgt.rois[:, :m].detach()
                logits = self.mask(self._mask_pool(roi_feat_map, mask_rois,
                                                   m))
                if not gt_masks.is_floating_point():
                    gt_masks = gt_masks.float()  # the loader ships uint8
                targets, cls_ids = mask_targets_from_dense(
                    mask_rois, tgt.matched_gt[:, :m], gt_boxes, gt_masks,
                    mask_size=self.mask_size)
                cid = (cls_ids.reshape(-1).long() - 1).clamp_min(0)
                S = self.mask_size
                out["mask_logits"] = self._class_planes(logits, cid)
                out["mask_targets"] = targets.reshape(b * m, S, S)
        return out
