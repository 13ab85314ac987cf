"""BatchNorm: frozen (running statistics) and trainable (batch statistics).

``FrozenBatchNorm`` is flax ``nn.BatchNorm(use_running_average=True)`` as
the JAX trunk uses it (sniper_tpu/models/resnet.py, sniper_tpu/models/
norm.py): ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` computed in
fp32 and rounded once to the output dtype, eps 2e-5. It runs as one stock
``F.batch_norm`` in inference mode, which takes a bf16 input with the fp32
statistics and computes in fp32: one pass over the tensor, where the flax
expression written out as eager ops takes five.

``TrainBatchNorm`` is ``nn.BatchNorm(use_running_average=False,
momentum=0.95)`` in training mode, with flax's semantics where torch's
``BatchNorm2d`` differs:

- the batch statistics are the fp32 mean and the *biased* variance over
  (N, H, W) (flax computes ``max(E[x^2] - E[x]^2, 0)``; Welford's running
  sums give the same value to fp32 rounding);
- the running update is ``ra = 0.95 * ra + 0.05 * batch``, with that
  biased variance (torch's momentum is one minus flax's, and torch updates
  with the unbiased variance).

One ``torch.native_batch_norm`` in training mode, with no running buffers,
normalizes with the biased batch statistics, returns the mean and
``invstd = rsqrt(var + eps)`` it used, and has the native backward. The
running update is then done explicitly from those, with
``var = invstd^-2 - eps``. Outside training mode it is a FrozenBatchNorm.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 2e-5
BN_MOMENTUM = 0.95  # flax's convention: the weight of the old statistics


class FrozenBatchNorm(nn.Module):
    """BatchNorm over dim 1 of an NCHW tensor, from running statistics.

    ``use_scale=False`` has no ``weight`` (the stem's data-normalizing
    ``bn_data``). ``dtype`` is the output dtype (None keeps the input's)."""

    def __init__(self, num_features: int, *, use_scale: bool = True,
                 eps: float = BN_EPS, dtype: torch.dtype | None = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        if use_scale:
            self.weight = nn.Parameter(torch.ones(num_features))
        else:
            self.register_parameter("weight", None)
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                         self.bias, training=False, eps=self.eps)
        return y.to(self.dtype or x.dtype)


class TrainBatchNorm(FrozenBatchNorm):
    """flax's training-mode BatchNorm (module doc); a FrozenBatchNorm when
    the module is not in training mode."""

    def __init__(self, num_features: int, *, momentum: float = BN_MOMENTUM,
                 **kw):
        super().__init__(num_features, **kw)
        self.momentum = momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            var = torch.clamp_min(invstd.float().pow(-2) - self.eps, 0.0)
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean
                                    + (1 - m) * mean.float())
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return y.to(self.dtype or x.dtype)
