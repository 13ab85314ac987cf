"""Inference BatchNorm from running statistics.

The port of flax ``nn.BatchNorm(use_running_average=True)`` as the JAX
trunk uses it (sniper_tpu/models/resnet.py, sniper_tpu/models/norm.py):
``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` computed in fp32 and
rounded once to the output dtype, eps 2e-5. It runs as one stock
``F.batch_norm`` in inference mode, which takes a bf16 input with the fp32
statistics and computes in fp32: one pass over the tensor, where the flax
expression written out as eager ops takes five. Only inference is ported
here: the training-time statistics (biased variance, flax momentum
convention) are a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 2e-5


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
