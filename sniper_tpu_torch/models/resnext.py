"""ResNeXt-101 trunk (64 groups) with a deformable, dilated C5.

Port of sniper_tpu/models/resnext.py:25-215. Modules and parameter names
follow the flax tree (``stage1_unit1.conv1``, ``stage1_unit1.sc_bn``,
``stage4_unit1.offset``, ``stage4_unit1.conv2_weight``, ...) so that
convert.py maps one to one.

- Units are post-activation: conv -> BN -> ReLU twice, then conv -> BN,
  the shortcut added, ReLU. All three convs run at the unit's output
  width; the 3x3 is grouped (64 groups) and carries the unit's stride.
- The shortcut is a 1x1 conv ``sc`` with ``sc_bn`` when ``dim_match`` is
  false, else the identity in fp32 (the sum then runs in fp32).
- The grouped 3x3 of every unit is the bare parameter ``conv2_weight``
  [f, f/64, 3, 3], as the JAX unit's ``conv2_kernel`` is in both branches:
  one ``F.conv2d(groups=64)`` in stages 1-3, and in stage 4 (C5)
  ``deformable_conv(conv_groups=64)`` at dilation 2 with 4 deformable
  groups, its offsets from the fp32 ``offset`` conv. The JAX package's
  block-diagonal expansion and RESNEXT_SUPERGROUPS exist only for the TPU's
  lane layout and are not ported: the math is the same grouped conv.
- The stem runs ``conv0`` in fp32 -> cast to the compute dtype -> frozen
  ``bn0`` -> ReLU -> max-pool 3x3/2, padding 1.
- BatchNorm: eps 2e-5, momentum 0.95; the units of stage 1 are frozen
  (``fix_bn``), the others train (``TrainBatchNorm``). A ``stats`` list,
  when given, collects each deformable unit's max |offset| (the
  ``dcn_offset_max`` telemetry).
- bn1 and bn2 each run with their ReLU as one unit epilogue
  (ops/epilogue.py: one kernel at inference on the card, the modules
  elsewhere), and bn3, the shortcut (with ``sc_bn``), the sum and the last
  ReLU as another, rounded where the module chain rounds.

Tensors are NCHW; the detector feeds them in ``channels_last`` memory
format.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sniper_tpu_torch.models.norm import FrozenBatchNorm, TrainBatchNorm
from sniper_tpu_torch.models.resnet import conv
from sniper_tpu_torch.ops import epilogue
from sniper_tpu_torch.ops.deform import deformable_conv


class ResNeXtUnit(nn.Module):
    def __init__(self, in_channels: int, filters: int, *, stride: int = 1,
                 dim_match: bool = True, fix_bn: bool = False,
                 num_groups: int = 64, deform: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        f = filters
        self.stride = stride
        self.num_groups = num_groups
        self.deform = deform
        self.dtype = dtype
        bn = FrozenBatchNorm if fix_bn else TrainBatchNorm
        self.conv1 = nn.Conv2d(in_channels, f, 1, bias=False)
        self.bn1 = bn(f, dtype=dtype)
        if deform:
            self.offset = nn.Conv2d(f, 4 * 2 * 9, 3, padding=2, dilation=2)
        self.conv2_weight = nn.Parameter(torch.empty(f, f // num_groups, 3, 3))
        # nn.Conv2d's default init: never uninitialized memory
        nn.init.kaiming_uniform_(self.conv2_weight, a=math.sqrt(5))
        self.bn2 = bn(f, dtype=dtype)
        self.conv3 = nn.Conv2d(f, f, 1, bias=False)
        self.bn3 = bn(f, dtype=dtype)
        if not dim_match:
            self.sc = nn.Conv2d(in_channels, f, 1, stride=stride, bias=False)
            self.sc_bn = bn(f, dtype=dtype)
        else:
            self.sc = None

    def forward(self, x: torch.Tensor, stats: list | None = None):
        h = epilogue.bn_relu(conv(self.conv1, x.to(self.dtype)), self.bn1)
        w2 = self.conv2_weight.to(self.dtype)
        if self.deform:
            offsets = conv(self.offset, h.float())
            if stats is not None:
                stats.append(offsets.detach().abs().amax())
            h = deformable_conv(
                h.permute(0, 2, 3, 1).contiguous(),
                offsets.permute(0, 2, 3, 1).contiguous(), w2, num_groups=4,
                dilation=2, conv_groups=self.num_groups,
            ).permute(0, 3, 1, 2).to(self.dtype)
        else:
            h = F.conv2d(h, w2, None, self.stride, 1, 1, self.num_groups)
        h = conv(self.conv3, epilogue.bn_relu(h, self.bn2))
        # bn3, the shortcut's BatchNorm, the sum and the ReLU
        if self.sc is None:
            return epilogue.bn_add_relu(h, self.bn3, x)
        return epilogue.bn_add_relu(h, self.bn3, conv(self.sc, x), self.sc_bn)


class ResNeXtTrunk(nn.Module):
    """C4/C5 feature extractor: units (3,4,23,3), 64 groups for X101."""

    def __init__(self, units: Sequence[int] = (3, 4, 23, 3),
                 filters: Sequence[int] = (64, 256, 512, 1024, 2048),
                 num_groups: int = 64, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.units = tuple(units)
        self.out_channels = filters[3] + filters[4]
        self.conv0 = nn.Conv2d(3, filters[0], 7, stride=2, padding=3,
                               bias=False)
        self.bn0 = FrozenBatchNorm(filters[0], dtype=dtype)
        cin = filters[0]
        for i in range(4):
            for j in range(self.units[i]):
                block = ResNeXtUnit(
                    cin, filters[i + 1],
                    stride=2 if j == 0 and i in (1, 2) else 1,
                    dim_match=j > 0, fix_bn=i == 0, num_groups=num_groups,
                    deform=i == 3, dtype=dtype)
                self.add_module(f"stage{i + 1}_unit{j + 1}", block)
                cin = filters[i + 1]

    def forward(self, x: torch.Tensor, stats: list | None = None):
        """x [B,3,H,W] fp32, pixel-mean-subtracted. Returns (c4, c5) in the
        compute dtype; ``stats`` collects the deformable units' max
        |offset|."""
        h = epilogue.bn_relu(conv(self.conv0, x.float()), self.bn0)
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        c4 = None
        for i in range(4):
            if i == 3:
                c4 = h
            for j in range(self.units[i]):
                h = getattr(self, f"stage{i + 1}_unit{j + 1}")(h, stats)
        return c4, h

    def feature(self, x: torch.Tensor, stats: list | None = None):
        """The detection map C4||C5 in the compute dtype."""
        return torch.cat([c.to(self.dtype) for c in self(x, stats)], dim=1)
