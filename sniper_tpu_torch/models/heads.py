"""Detection heads: RPN, the fused deformable R-CNN head, the mask head and
the AutoFocus FocusPixel head.

Port of sniper_tpu/models/heads.py:52-250. Parameter names follow the flax
tree; the ``_Lin`` param holders become ``nn.Linear`` ([out, in] weights).
The offset FC's gradient is scaled by 0.01 inside the pool's backward
(ops/deform.py:OFFSET_GRAD_MULT, the reference's lr_mult).
"""

from __future__ import annotations

import torch
from torch import nn

from sniper_tpu_torch.models.resnet import conv
from sniper_tpu_torch.ops.deform import rcnn_head_fused


class RPNHead(nn.Module):
    """3x3 conv 512 -> ReLU -> 1x1 cls (2A) and 1x1 bbox (4A), in the
    compute dtype; outputs cast to fp32."""

    def __init__(self, in_channels: int, num_anchors: int):
        super().__init__()
        self.num_anchors = num_anchors
        self.rpn_conv_3x3 = nn.Conv2d(in_channels, 512, 3, padding=1)
        self.rpn_cls_score = nn.Conv2d(512, 2 * num_anchors, 1)
        self.rpn_bbox_pred = nn.Conv2d(512, 4 * num_anchors, 1)

    def forward(self, feat: torch.Tensor):
        """feat [B,C,H,W]. Returns cls logits [B,H,W,2,A] fp32 (bg block,
        then fg block) and bbox deltas [B,4A,H,W] fp32 (channel a*4+k)."""
        h = torch.relu(conv(self.rpn_conv_3x3, feat))
        cls = conv(self.rpn_cls_score, h).float()
        bbox = conv(self.rpn_bbox_pred, h).float()
        b, _, fh, fw = cls.shape
        cls = cls.permute(0, 2, 3, 1).reshape(b, fh, fw, 2, self.num_anchors)
        return cls, bbox.contiguous()


class RCNNHead(nn.Module):
    """Two-pass deformable PSROI pool (offset FC between the passes) ->
    2x FC -> class scores and class-agnostic box deltas."""

    def __init__(self, num_classes: int, *, in_channels: int = 256,
                 pooled_size: int = 7, spatial_scale: float = 0.0625,
                 fc_dim: int = 1024, margin_bins: int = 1,
                 trans_std: float = 0.1):
        super().__init__()
        P = pooled_size
        self.pooled_size = P
        self.spatial_scale = spatial_scale
        self.margin_bins = margin_bins
        self.trans_std = trans_std
        # offset FC output: the first P*P are dy, the next P*P dx
        self.offset = nn.Linear(P * P * in_channels, 2 * P * P)
        self.fc_new_1 = nn.Linear(P * P * in_channels, fc_dim)
        self.fc_new_2 = nn.Linear(fc_dim, fc_dim)
        self.cls_score = nn.Linear(fc_dim, num_classes)
        self.bbox_pred = nn.Linear(fc_dim, 4)

    def forward(self, roi_feat_map: torch.Tensor, rois: torch.Tensor, *,
                extract: str = "fused", return_offset: bool = False):
        """roi_feat_map [B,H,W,C] fp32, image-contiguous rois [R,5] (roi i
        belongs to image i // (R/B), as multi_proposal emits them).
        ``extract`` is the pool's route (rcnn_head_fused): "fused" (the
        fused pool kernels, with the backward) or "pallas" (the patch
        route, forward only: the detector's inference under
        network.POOL_KERNEL pallas). Returns (cls_score [R, num_classes],
        bbox_pred [R, 4]) fp32, and with ``return_offset`` the raw
        offset-FC output [R, 2*P*P] (detached), which offset_stats
        reads."""
        B = roi_feat_map.shape[0]
        if rois.shape[0] % B:
            raise NotImplementedError(
                "RCNNHead takes image-contiguous rois only (R a multiple of "
                "B); the general batch-index path is the JAX package's test "
                "oracle and is not ported")
        params = tuple((m.weight, m.bias) for m in (
            self.offset, self.fc_new_1, self.fc_new_2, self.cls_score,
            self.bbox_pred))
        return rcnn_head_fused(
            roi_feat_map, rois, params, rois_per_image=rois.shape[0] // B,
            pooled_size=self.pooled_size, spatial_scale=self.spatial_scale,
            trans_std=self.trans_std, margin_bins=self.margin_bins,
            extract=extract, return_offset=return_offset)

    def offset_stats(self, off: torch.Tensor) -> dict:
        """Margin-clamp telemetry of the raw offset-FC output (heads.py:
        186-199): the stencil clips window shifts at margin_bins /
        (trans_std * P) in offset units whatever the roi's size. Returns
        offset_max, offset_clamp_frac (the share at or over the threshold)
        and offset_clamp_thr, as 0-d tensors."""
        thr = self.margin_bins / (self.trans_std * self.pooled_size)
        ab = off.float().abs()
        return {"offset_max": ab.amax(),
                "offset_clamp_frac": (ab >= thr).float().mean(),
                "offset_clamp_thr": torch.full((), thr, device=off.device)}


class MaskHead(nn.Module):
    """Mask branch (heads.py:202-235): four 3x3 convs to 256 with ReLU ->
    2x2 stride-2 transposed conv (14 -> 28) with ReLU -> 1x1 conv to
    2 * num_fg_classes channels (per-class neg and pos logit planes). fp32,
    like the flax module. flax's ConvTranspose (padding "SAME", kernel not
    transposed) gives output row 2i + a the kernel tap 1 - a, where torch's
    gives it tap a: convert.py flips the kernel spatially."""

    def __init__(self, num_fg_classes: int = 80, in_channels: int = 256):
        super().__init__()
        for i in range(4):
            setattr(self, f"mask_conv_3x3_{i + 1}",
                    nn.Conv2d(in_channels if i == 0 else 256, 256, 3,
                              padding=1))
        self.mask_deconv = nn.ConvTranspose2d(256, 256, 2, stride=2)
        self.mask_out = nn.Conv2d(256, 2 * num_fg_classes, 1)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        """pooled [R, 14, 14, C] -> logits [R, 28, 28, 2*num_fg_classes]."""
        h = pooled.permute(0, 3, 1, 2)
        for i in range(4):
            h = torch.relu(getattr(self, f"mask_conv_3x3_{i + 1}")(h))
        h = torch.relu(self.mask_deconv(h))
        return self.mask_out(h).permute(0, 2, 3, 1)


class AutoFocusHead(nn.Module):
    """FocusPixel head (heads.py:238-250): 3x3 conv to 256 + ReLU, 1x1 conv
    to 256 + ReLU, 1x1 conv to 2 (background, focus), in the compute dtype
    of its input; the logits cast to fp32."""

    def __init__(self, in_channels: int = 1024 + 2048):
        super().__init__()
        self.conv_new_2 = nn.Conv2d(in_channels, 256, 3, padding=1)
        self.conv_new_3 = nn.Conv2d(256, 256, 1)
        self.conv_new_out = nn.Conv2d(256, 2, 1)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        """feat [B,C,H,W] (C4 || C5) -> FocusPixel logits [B,H,W,2] fp32."""
        h = torch.relu(conv(self.conv_new_2, feat))
        h = torch.relu(conv(self.conv_new_3, h))
        return conv(self.conv_new_out, h).float().permute(0, 2, 3, 1)
