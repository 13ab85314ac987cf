"""Pre-activation ResNet trunk with a deformable, dilated C5.

Port of sniper_tpu/models/resnet.py:32-178. Modules and parameter names
follow the flax tree (``stage1_unit1.conv1``, ``stage4_unit1.offset``,
``stage4_unit1.conv2_weight``, ...) so that convert.py maps one to one.

- Blocks are pre-activation: BN -> ReLU -> conv three times; the shortcut
  conv comes off ``act1`` when ``dim_match`` is false.
- The stride sits on the 3x3 conv, with padding ``d*(k-1)//2``.
- Stage 4 (C5) has stride 1, dilation 2 and a deformable 3x3 whose offset
  conv runs in fp32 with dilation 2 and padding 2.
- The stem runs fp32 ``bn_data`` -> ``conv0`` -> cast to the compute dtype
  -> ``bn0`` -> ReLU -> max-pool 3x3/2, padding 1.
- Training: the BatchNorms of stages 2-4 train (``TrainBatchNorm``, flax's
  batch statistics and momentum 0.95); ``bn_data``, ``bn0`` and stage 1
  stay frozen, as in the JAX trunk (``fix_bn``). A ``stats`` list, when
  given, collects each deformable unit's max |offset| (the
  ``dcn_offset_max`` telemetry, resnet.py:32-47).
- Each BatchNorm runs with its ReLU as one unit epilogue (ops/epilogue.py:
  one kernel at inference on the card, the modules elsewhere), and a unit
  hands its ``[h, sc]`` to the next, whose first epilogue forms the
  residual sum with its bn1; the sum is rounded once, as the module chain
  rounds it, and C4 and C5 are still whole tensors.

Tensors are NCHW; the detector feeds them in ``channels_last`` memory
format, so the NHWC view the deformable conv needs is free.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sniper_tpu_torch.models.norm import FrozenBatchNorm, TrainBatchNorm
from sniper_tpu_torch.ops import epilogue
from sniper_tpu_torch.ops.deform import deformable_conv


def conv(mod: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply ``mod`` in x's dtype (flax casts the fp32 params to the
    module's compute dtype the same way)."""
    bias = None if mod.bias is None else mod.bias.to(x.dtype)
    return F.conv2d(x, mod.weight.to(x.dtype), bias, mod.stride, mod.padding,
                    mod.dilation, mod.groups)


def _conv(cin, cout, k, stride=1, dilation=1, bias=False):
    return nn.Conv2d(cin, cout, k, stride=stride,
                     padding=dilation * (k - 1) // 2, dilation=dilation,
                     bias=bias)


class PreActBottleneck(nn.Module):
    def __init__(self, in_channels: int, filters: int, *, stride: int = 1,
                 dim_match: bool = True, dilation: int = 1,
                 deform: bool = False, deform_groups: int = 4,
                 fix_bn: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        mid = filters // 4
        self.dtype = dtype
        self.dilation = dilation
        self.deform = deform
        self.deform_groups = deform_groups
        bn = FrozenBatchNorm if fix_bn else TrainBatchNorm
        self.bn1 = bn(in_channels, dtype=dtype)
        self.conv1 = _conv(in_channels, mid, 1)
        self.bn2 = bn(mid, dtype=dtype)
        if deform:
            self.offset = nn.Conv2d(mid, deform_groups * 2 * 9, 3, padding=2,
                                    dilation=2)
            self.conv2_weight = nn.Parameter(torch.empty(mid, mid, 3, 3))
            # nn.Conv2d's default init: never uninitialized memory
            nn.init.kaiming_uniform_(self.conv2_weight, a=math.sqrt(5))
        else:
            self.conv2 = _conv(mid, mid, 3, stride, dilation)
        self.bn3 = bn(mid, dtype=dtype)
        self.conv3 = _conv(mid, filters, 1)
        self.sc = None if dim_match else _conv(in_channels, filters, 1, stride)

    def forward(self, x: torch.Tensor, stats: list | None = None):
        h, sc = self.pair(x, stats)
        return h + sc

    def pair(self, x, stats: list | None = None) -> list:
        """[h, sc], whose sum is the unit's output. ``x`` is the unit's
        input or the previous unit's [h, sc], which this unit empties once
        it holds their sum, so that the two are freed then; that sum is
        formed in one unit epilogue (ops/epilogue.py) with this unit's bn1
        and ReLU, and bn2 and bn3 each run with their ReLU in another."""
        if isinstance(x, list):
            parts = x
            x, act1 = epilogue.sum_bn_relu(*parts, self.bn1,
                                           keep_sum=self.sc is None)
            parts.clear()
        else:
            act1 = epilogue.bn_relu(x, self.bn1)
        act2 = epilogue.bn_relu(conv(self.conv1, act1), self.bn2)
        if self.deform:
            offsets = conv(self.offset, act2.float())
            if stats is not None:
                stats.append(offsets.detach().abs().amax())
            h = deformable_conv(
                act2.permute(0, 2, 3, 1).contiguous(),
                offsets.permute(0, 2, 3, 1).contiguous(), self.conv2_weight,
                num_groups=self.deform_groups, dilation=self.dilation,
            ).permute(0, 3, 1, 2).to(self.dtype)
        else:
            h = conv(self.conv2, act2)
        h = conv(self.conv3, epilogue.bn_relu(h, self.bn3))
        sc = x.to(self.dtype) if self.sc is None else conv(self.sc, act1)
        return [h, sc]


class ResNetTrunk(nn.Module):
    """C4/C5 feature extractor. units=(3,4,23,3) for R101, (3,4,6,3) R50."""

    def __init__(self, units: Sequence[int] = (3, 4, 23, 3),
                 filters: Sequence[int] = (64, 256, 512, 1024, 2048),
                 deform_c5: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.units = tuple(units)
        self.out_channels = filters[3] + filters[4]
        self.bn_data = FrozenBatchNorm(3, use_scale=False,
                                       dtype=torch.float32)
        self.conv0 = nn.Conv2d(3, filters[0], 7, stride=2, padding=3,
                               bias=False)
        self.bn0 = FrozenBatchNorm(filters[0], dtype=dtype)
        cin = filters[0]
        for i in range(4):
            c5 = i == 3
            for j in range(self.units[i]):
                first = j == 0
                block = PreActBottleneck(
                    cin, filters[i + 1],
                    stride=2 if first and i in (1, 2) else 1,
                    dim_match=not first, dilation=2 if c5 else 1,
                    deform=c5 and deform_c5, fix_bn=i == 0, dtype=dtype,
                )
                self.add_module(f"stage{i + 1}_unit{j + 1}", block)
                cin = filters[i + 1]

    def _early(self):
        """The stem and stage 1: frozen BatchNorms, and in every shipped
        config also FIXED_PARAMS (conv0, bn0, stage1, bn_data)."""
        yield self.bn_data
        yield self.conv0
        yield self.bn0
        for j in range(self.units[0]):
            yield getattr(self, f"stage1_unit{j + 1}")

    def forward(self, x: torch.Tensor, stats: list | None = None):
        """x [B,3,H,W] fp32, pixel-mean-subtracted. Returns (c4, c5);
        ``stats`` collects the deformable units' max |offset|."""
        # when no parameter of the stem and stage 1 trains (FIXED_PARAMS),
        # nothing upstream of stage 2 needs a gradient: run it without
        # autograd, which keeps none of its activations
        frozen = not any(p.requires_grad for m in self._early()
                         for p in m.parameters())
        with torch.no_grad() if frozen else contextlib.nullcontext():
            h = conv(self.conv0, self.bn_data(x.float()))
            h = epilogue.bn_relu(h, self.bn0)
            h = F.max_pool2d(h, 3, stride=2, padding=1)
            # each unit hands its [h, sc] to the next, which sums them
            for j in range(self.units[0]):
                h = getattr(self, f"stage1_unit{j + 1}").pair(h)
        c4 = None
        for i in range(1, 4):
            if i == 3:
                c4 = h = h[0] + h[1]
            for j in range(self.units[i]):
                h = getattr(self, f"stage{i + 1}_unit{j + 1}").pair(h, stats)
        return c4, h[0] + h[1]

    def feature(self, x: torch.Tensor, stats: list | None = None):
        """The detection map C4||C5 in the compute dtype."""
        return torch.cat([c.to(self.dtype) for c in self(x, stats)], dim=1)
