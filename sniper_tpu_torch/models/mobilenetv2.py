"""MobileNetV2 trunk (the SNIPER variant), stride 32.

Port of sniper_tpu/models/mobilenetv2.py. Modules follow the flax tree
(``first_conv``, ``seq{i}_block{j}.{exp,depthwise,linear}``, ``last_conv``,
each with ``conv2d`` and ``batchnorm``) so that convert.py maps one to one.

- ``MobileUnit``: conv (no bias) -> BatchNorm -> relu6 (``linear`` has no
  activation). Its BatchNorm has eps 1e-5 and momentum 0.995 and trains
  whenever the model trains: no unit is frozen.
- ``InvertedResidual``: expand 1x1 -> depthwise 3x3 (``groups`` = the
  expanded width, the block's stride) -> linear 1x1, plus the input on the
  repeated blocks of a sequence. The expand conv is kept at t=1 too
  (``seq0_block0.exp``), as in the JAX trunk.
- ``first_conv`` (3x3/2, 32 channels) runs in fp32, then the compute dtype;
  ``last_conv`` has 1280 channels and the output is cast to fp32.

The trunk returns (feat, feat), as the flax trunk does: MobileNetV2 has a
single map. ``feature`` hands the detector that map in the compute dtype,
``out_channels`` (1280) wide.
"""

from __future__ import annotations

import torch
from torch import nn

from sniper_tpu_torch.models.norm import TrainBatchNorm
from sniper_tpu_torch.models.resnet import conv

# (expansion t, channels c, repeats n, stride s): the standard table
BOTTLENECK_PARAMS = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)
BN_EPS = 1e-5
BN_MOMENTUM = 0.995


class MobileUnit(nn.Module):
    def __init__(self, in_channels: int, filters: int, kernel: int = 1,
                 stride: int = 1, groups: int = 1, act: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.act = act
        self.dtype = dtype
        self.conv2d = nn.Conv2d(in_channels, filters, kernel, stride=stride,
                                padding=(kernel - 1) // 2, groups=groups,
                                bias=False)
        self.batchnorm = TrainBatchNorm(filters, eps=BN_EPS,
                                        momentum=BN_MOMENTUM, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.batchnorm(conv(self.conv2d, x.to(self.dtype)))
        return h.clamp(0.0, 6.0) if self.act else h


class InvertedResidual(nn.Module):
    def __init__(self, in_filters: int, filters: int, stride: int = 1,
                 expansion: int = 6, shortcut: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        exp = int(round(in_filters * expansion))
        self.shortcut = shortcut
        self.exp = MobileUnit(in_filters, exp, 1, dtype=dtype)
        self.depthwise = MobileUnit(exp, exp, 3, stride, groups=exp,
                                    dtype=dtype)
        self.linear = MobileUnit(exp, filters, 1, act=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.linear(self.depthwise(self.exp(x)))
        return x + h if self.shortcut else h


class MobileNetV2Trunk(nn.Module):
    out_channels = 1280

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        in_c = 32
        self.first_conv = MobileUnit(3, in_c, 3, 2, dtype=torch.float32)
        for i, (t, c, n, s) in enumerate(BOTTLENECK_PARAMS):
            self.add_module(f"seq{i}_block0", InvertedResidual(
                in_c, c, stride=s, expansion=t, dtype=dtype))
            for j in range(1, n):
                self.add_module(f"seq{i}_block{j}", InvertedResidual(
                    c, c, expansion=t, shortcut=True, dtype=dtype))
            in_c = c
        self.last_conv = MobileUnit(in_c, self.out_channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, stats: list | None = None):
        """x [B,3,H,W] fp32, pixel-mean-subtracted. Returns (feat, feat),
        feat [B,1280,H/32,W/32] fp32; ``stats`` is unused (no deformable
        unit)."""
        h = self.first_conv(x.float()).to(self.dtype)
        for name, m in self.named_children():
            if name.startswith("seq"):
                h = m(h)
        h = self.last_conv(h).float()
        return h, h

    def feature(self, x: torch.Tensor, stats: list | None = None):
        """The detection map [B,1280,H/32,W/32] in the compute dtype."""
        return self(x, stats)[1].to(self.dtype)
