"""The reference mask detector: SNIPER's Mask R-CNN configuration in plain
fp32 PyTorch.

The frozen box detector of reference/model.py with the mask branch of
SNIPER's ``resnet_mx_101_e2e_mask`` symbol (Mask R-CNN's head, He et al.,
arXiv:1703.06870) on every kept roi at inference:

- the 14x14 two-pass deformable PSROI pool of the roi map, with its own
  offset FC ``mask_offset`` (14*14*256 -> 2*14*14, the first 196 outputs
  the row shifts): the forward of reference/ops.offset_pool at
  ``pooled_size`` 14, the plain-op passes that the box head runs at 7;
- ``mask``: four 3x3 convs to 256 with ReLU, a 2x2 stride-2 transposed
  conv to 28x28 with ReLU, a 1x1 conv to 2 * 80 planes (each foreground
  class's neg plane, then all the pos planes);
- each roi's neg and pos planes of a given foreground class, and the
  softmax over that pair: the mask probability [B,N,28,28].

Module and parameter names are the port's, so that one state dict loads
into both. It imports nothing of the port.

Departures from the published symbol, each the port's (and the JAX
package's) own behaviour, which this copy follows:

- the RPN and ``conv_new_1`` read C4||C5, as the flagship's symbol does;
  the published mask symbol feeds its RPN from C4 alone;
- the pools are the two-pass sub-cell approximation of deformable PSROI
  pooling (margin bins, the clamp rule of reference/ops.py);
- the mask branch takes the class of each roi's largest foreground score
  (the program's, when checked), not a per-class loop over detections.

``mask_precision`` "bf16" is the control of the mask head's precision (the
configuration states fp32): the offset FC, the convs, the deconvolution
and the output conv take inputs and weights rounded to bfloat16, and
compute in fp32, as a bf16 product that accumulates in fp32 does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import ops
from benchmark.reference.model import Detector

POOLED = 14
MASK_SIZE = 28
CHANNELS = 256


def _bf16(t):
    return t.to(torch.bfloat16).float()


class MaskHead(nn.Module):
    def __init__(self, num_fg_classes, cin=CHANNELS):
        super().__init__()
        for i in range(4):
            setattr(self, f"mask_conv_3x3_{i + 1}",
                    nn.Conv2d(cin if i == 0 else CHANNELS, CHANNELS, 3,
                              padding=1))
        self.mask_deconv = nn.ConvTranspose2d(CHANNELS, CHANNELS, 2,
                                              stride=2)
        self.mask_out = nn.Conv2d(CHANNELS, 2 * num_fg_classes, 1)

    def forward(self, pooled, low=False):
        """pooled [R,C,14,14] -> logits [R, 2*nfg, 28, 28]."""
        r = _bf16 if low else (lambda t: t)
        h = pooled
        for i in range(4):
            m = getattr(self, f"mask_conv_3x3_{i + 1}")
            h = torch.relu(F.conv2d(r(h), r(m.weight), r(m.bias), padding=1))
        d = self.mask_deconv
        h = torch.relu(F.conv_transpose2d(r(h), r(d.weight), r(d.bias),
                                          stride=2))
        return F.conv2d(r(h), r(self.mask_out.weight), r(self.mask_out.bias))


class MaskDetector(Detector):
    """The box detector and its mask branch (module doc)."""

    def __init__(self, cfg, trunk="resnet", units=(3, 4, 23, 3)):
        super().__init__(cfg, trunk=trunk, units=units)
        self.mask_precision = "fp32"
        pp = POOLED * POOLED
        self.mask_offset = nn.Linear(pp * CHANNELS, 2 * pp)
        self.mask = MaskHead(self.num_classes - 1)

    def mask_prob(self, roi_map, rois, cls_id):
        """Mask probabilities [B,N,28,28] of rois [B,N,5] on the roi map
        [B,H,W,256], each roi's foreground class ``cls_id`` [B,N] (0 is
        the first foreground class)."""
        return self.mask_from_pooled(self.mask_pool(roi_map, rois), cls_id)

    def mask_pool(self, roi_map, rois):
        """The 14x14 pool of rois [B,N,5]: [B*N, 14, 14, 256], NHWC as
        the port's MaskHead takes it."""
        n = rois.shape[1]
        pooled = offset_pool(roi_map.float().contiguous(), rois.reshape(-1, 5),
                             self.mask_offset, n, 1.0 / self.stride,
                             self.mask_precision == "bf16")
        return pooled.reshape(-1, POOLED, POOLED, CHANNELS)

    def mask_from_pooled(self, pooled, cls_id):
        """The mask head, the plane pick and the softmax of pooled
        [B*N,14,14,C] for the classes ``cls_id`` [B,N]: [B,N,28,28]."""
        b, n = cls_id.shape
        logits = self.mask(pooled.float().permute(0, 3, 1, 2),
                           low=self.mask_precision == "bf16")
        nfg = self.num_classes - 1
        cid = cls_id.reshape(-1).long()
        rows = torch.arange(b * n, device=logits.device)
        pair = torch.stack([logits[rows, cid], logits[rows, cid + nfg]], -1)
        return torch.softmax(pair, dim=-1)[..., 1].reshape(
            b, n, MASK_SIZE, MASK_SIZE)


def offset_pool(feat, rois, fc, rpi, spatial_scale, low=False):
    """The 14x14 two-pass pool with the offset FC ``fc`` between the
    passes (reference/ops.offset_pool's forward, S = 4, one margin bin);
    ``low`` rounds the FC's input and weight to bf16 (fp32 sums). The
    passes are fp32 either way, as the port's pool kernels are."""
    P, S = POOLED, 4
    M = S
    geom, roi_h, roi_w, sub_h, sub_w = ops.pool_geometry(
        rois, P=P, S=S, M=M, spatial_scale=spatial_scale)
    kw = dict(rois_per_image=rpi, P=P, S=S, M=M)
    R = rois.shape[0]
    pass1 = ops.pool_pass(feat, geom, None, **kw).reshape(R, -1)
    r = _bf16 if low else (lambda t: t)
    off = r(pass1) @ r(fc.weight).t() + r(fc.bias)
    raw_y, raw_x = ops._window_raw(off, roi_h, roi_w, sub_h, sub_w, P=P,
                                   S=S, M=M, trans_std=0.1)
    hi = float(P * S + 2 * M - S)
    pypx = torch.stack([raw_y.clamp(0.0, hi), raw_x.clamp(0.0, hi)], 1)
    return ops.pool_pass(feat, geom, pypx, **kw).reshape(R, -1)
