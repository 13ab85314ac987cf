"""Seeded random weights with the JAX package's init distributions.

For runs without a checkpoint (the chip smoke test, benchmarks): the same
distributions as the flax initializers, drawn from an explicit
``torch.Generator`` (the numbers differ from ``jax.random``'s):

- convs: lecun_normal (truncated normal, variance 1/fan_in, fan_in =
  in/groups * kh * kw: 9 for MobileNetV2's depthwise 3x3), zero bias;
- ``conv2_weight`` (the deformable 3x3 of ResNet's C5, and the grouped 3x3
  of every ResNeXt unit, deformable or not): variance_scaling(2.0,
  "fan_out", truncated normal), fan_out = 9 * out;
- RPN, ``conv_new_1``, the R-CNN FCs, every mask-head layer and the
  FocusPixel head's three convs: normal(0.01), zero bias;
- offset convs and the R-CNN and mask offset FCs: zeros, or
  normal(``offset_std``) when it is given, so that the deformable sampling
  really moves;
- BatchNorm: scale 1, bias 0, mean 0, var 1.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from sniper_tpu_torch.models.detector import SNIPERDetector
from sniper_tpu_torch.models.norm import FrozenBatchNorm

# flax's truncated_normal(stddev) draws N(0, 1) cut at +-2 and scales by
# stddev / 0.8796 so the truncated variance is stddev^2
_TRUNC_STD = 0.87962566103423978


def _trunc_normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    w = torch.empty(t.shape).normal_(generator=gen)
    bad = w.abs() >= 2.0  # resample the tails
    while bad.any():
        w[bad] = torch.empty(int(bad.sum())).normal_(generator=gen)
        bad = w.abs() >= 2.0
    with torch.no_grad():
        t.copy_(w * (std / _TRUNC_STD))


def _normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    with torch.no_grad():
        t.copy_(torch.empty(t.shape).normal_(generator=gen) * std)


def init_detector(model: SNIPERDetector, seed: int = 0,
                  offset_std: float | None = None) -> SNIPERDetector:
    """Fill ``model`` in place with seeded random weights (module doc)."""
    gen = torch.Generator().manual_seed(seed)
    head_layers = {model.rpn.rpn_conv_3x3, model.rpn.rpn_cls_score,
                   model.rpn.rpn_bbox_pred}
    offsets = set()
    if not model.rpn_only:
        head_layers |= {model.conv_new_1, model.rcnn.fc_new_1,
                        model.rcnn.fc_new_2, model.rcnn.cls_score,
                        model.rcnn.bbox_pred}
        offsets.add(model.rcnn.offset)
    if model.with_autofocus:
        head_layers |= set(model.autofocus.children())
    if model.with_mask:
        head_layers |= set(model.mask.children())
        offsets.add(model.mask_offset)
    for name, m in model.named_modules():
        if name.endswith(".offset"):
            offsets.add(m)
    for name, m in model.named_modules():
        if isinstance(m, FrozenBatchNorm):
            with torch.no_grad():
                if m.weight is not None:
                    m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            if m in offsets:
                if offset_std is None:
                    nn.init.zeros_(m.weight)
                else:
                    _normal_(m.weight, offset_std, gen)
            elif m in head_layers:
                _normal_(m.weight, 0.01, gen)
            else:
                fan_in = m.weight[0].numel()
                _trunc_normal_(m.weight, math.sqrt(1.0 / fan_in), gen)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        if hasattr(m, "conv2_weight"):
            w = m.conv2_weight  # [out, in, 3, 3]; fan_out = 9 * out
            _trunc_normal_(w, math.sqrt(2.0 / (9 * w.shape[0])), gen)
    return model
