"""The SNIPER detector's inference branch.

Port of sniper_tpu/models/detector.py:139-152,167-170,176-183,294-315:
trunk -> C4||C5 concat -> RPN -> softmax over the {bg, fg} axis ->
``conv_new_1`` + ReLU cast to fp32 -> ``multi_proposal`` -> the fused
deformable R-CNN head -> class softmax and ``bbox_pred * stds + means``.

Training, the mask branch, AutoFocus and the RPN-only mode are later
slices of the port (ROADMAP.md, Queue 1 items 6 and 8); asking for them
raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from sniper_tpu_torch.models.heads import RCNNHead, RPNHead
from sniper_tpu_torch.models.resnet import ResNetTrunk, conv
from sniper_tpu_torch.ops.anchors import make_anchors_ahw
from sniper_tpu_torch.ops.proposals import multi_proposal


class SNIPERDetector(nn.Module):
    def __init__(
        self,
        num_classes: int = 81,
        num_anchors: int = 21,
        anchor_ratios: Sequence[float] = (0.5, 1, 2),
        anchor_scales: Sequence[float] = (2, 4, 7, 10, 13, 16, 24),
        feat_stride: int = 16,
        units: Sequence[int] = (3, 4, 23, 3),
        head_fc_dim: int = 1024,
        head_margin_bins: int = 1,
        dtype: torch.dtype = torch.bfloat16,
        pre_nms_top_n: int = 6000,
        post_nms_top_n: int = 300,
        nms_thresh: float = 0.7,
        rpn_min_size: float = 0.0,
        bbox_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
        bbox_means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
        autofocus: bool = False,
        with_mask: bool = False,
        rpn_only: bool = False,
    ):
        super().__init__()
        if with_mask:
            raise NotImplementedError(
                "the mask branch is not ported yet (ROADMAP.md Queue 1 "
                "item 8)")
        if autofocus:
            raise NotImplementedError(
                "the AutoFocus branch is not ported yet (ROADMAP.md Queue 1 "
                "item 8)")
        if rpn_only:
            raise NotImplementedError(
                "the RPN-only mode (TRAIN.ONLY_PROPOSAL) is not ported yet "
                "(ROADMAP.md Queue 1 item 6)")
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
        self.register_buffer("bbox_stds", torch.tensor(bbox_stds),
                             persistent=False)
        self.register_buffer("bbox_means", torch.tensor(bbox_means),
                             persistent=False)
        self.trunk = ResNetTrunk(units=units, dtype=dtype)
        self.rpn = RPNHead(1024 + 2048, num_anchors)
        self.conv_new_1 = nn.Conv2d(1024 + 2048, 256, 1)
        self.rcnn = RCNNHead(num_classes, spatial_scale=1.0 / feat_stride,
                             fc_dim=head_fc_dim, margin_bins=head_margin_bins)
        self._anchors: dict = {}

    def anchors(self, fh: int, fw: int, device) -> torch.Tensor:
        key = (fh, fw, str(device))
        if key not in self._anchors:
            self._anchors[key] = torch.as_tensor(make_anchors_ahw(
                fh, fw, self.feat_stride, self.anchor_ratios,
                self.anchor_scales), device=device)
        return self._anchors[key]

    def forward(self, data: torch.Tensor, im_info: torch.Tensor, *,
                train: bool = False, post_nms_top_n: int | None = None):
        """data [B,H,W,3] fp32 (mean-subtracted), im_info [B,3] (h, w,
        scale). Returns rois [B,N,5], roi_scores [B,N], roi_valid [B,N],
        cls_prob [B,N,C] and bbox_pred [B,N,4] (std-denormalized), with N =
        ``post_nms_top_n`` (default: the model's)."""
        if train:
            raise NotImplementedError(
                "training is not ported yet (ROADMAP.md Queue 1 item 6)")
        n = post_nms_top_n or self.post_nms_top_n
        x = data.permute(0, 3, 1, 2)  # channels_last NCHW view of NHWC data
        c4, c5 = self.trunk(x)
        feat = torch.cat([c4.to(self.dtype), c5.to(self.dtype)], dim=1)

        rpn_cls_logits, rpn_bbox = self.rpn(feat)
        rpn_fg = torch.softmax(rpn_cls_logits, dim=3)[..., 1, :]
        rpn_fg = rpn_fg.permute(0, 3, 1, 2).contiguous()  # [B,A,H,W]

        roi_feat_map = torch.relu(conv(self.conv_new_1, feat)).float()
        roi_feat_map = roi_feat_map.permute(0, 2, 3, 1).contiguous()

        b, fh, fw = feat.shape[0], feat.shape[2], feat.shape[3]
        rois, scores, valid = multi_proposal(
            rpn_fg, rpn_bbox, im_info, self.anchors(fh, fw, feat.device),
            pre_nms=self.pre_nms_top_n, post_nms=n,
            thresh=self.nms_thresh, min_size=self.rpn_min_size,
        )
        cls_score, bbox_pred = self.rcnn(roi_feat_map, rois.reshape(-1, 5))
        cls_prob = torch.softmax(cls_score, dim=-1).reshape(b, n, -1)
        return {
            "rois": rois,
            "roi_scores": scores,
            "roi_valid": valid,
            "cls_prob": cls_prob,
            "bbox_pred": (bbox_pred * self.bbox_stds
                          + self.bbox_means).reshape(b, n, 4),
        }
