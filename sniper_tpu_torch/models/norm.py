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

Across the ranks of a process group (parallel/distributed.py), ``mode``
(network.BN_MODE, checked by models/registry.py) sets whose statistics a
training-mode TrainBatchNorm uses:

- ``"sync"`` (the default): the global batch's, as the JAX package's
  data-parallel step computes them (sniper_tpu/train/trainer.py:82-160).
  One all-reduce of the per-channel ``[sum, sum of squares, count]``,
  reduced in fp32 from the input as it is, gives flax's biased variance
  ``max(E[x^2] - E[x]^2, 0)`` directly; the output is one fused
  ``native_batch_norm`` with those statistics as constants. The backward
  (``_SyncBatchNorm``) all-reduces the per-channel ``[sum of dy, sum of
  dy * xhat]``, which ``native_batch_norm_backward`` gives with the
  parameter gradients, so that every rank's input gradient carries the
  other ranks' loss terms; it keeps only the input for the backward, as
  the single-process module does. ``nn.SyncBatchNorm`` would update with
  the unbiased variance and torch's momentum.
- ``"local"``: each rank normalizes with its own batch's statistics, and
  the running statistics take the ranks' mean of the per-rank mean and
  biased variance (an all-reduce without gradient), as
  sniper_tpu/models/norm.py:LocalBatchNorm does with one group per device.

Without a group, or in one of size 1, both modes are the single-process
module above, bit for bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from sniper_tpu_torch.parallel.distributed import world_size

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

    @property
    def use_running_average(self) -> bool:
        """Whether the module normalizes with its running statistics (the
        unit epilogue's kernel takes only those: ops/epilogue.py)."""
        return True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                         self.bias, training=False, eps=self.eps)
        return y.to(self.dtype or x.dtype)


BN_MODES = ("sync", "local")


class TrainBatchNorm(FrozenBatchNorm):
    """flax's training-mode BatchNorm (module doc), with the statistics of
    ``mode`` across the ranks of a process group; a FrozenBatchNorm when
    the module is not in training mode."""

    def __init__(self, num_features: int, *, momentum: float = BN_MOMENTUM,
                 **kw):
        super().__init__(num_features, **kw)
        self.momentum = momentum
        self.mode = "sync"  # one of BN_MODES; the detector sets it

    @property
    def use_running_average(self) -> bool:
        return not self.training

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        world = world_size()
        if world > 1 and self.mode == "sync":
            y, mean, var = _SyncBatchNorm.apply(x, self.weight, self.bias,
                                                self.eps)
            with torch.no_grad():
                self._update(mean, var)
            return y.to(self.dtype or x.dtype)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            mean = mean.float()
            var = torch.clamp_min(invstd.float().pow(-2) - self.eps, 0.0)
            if world > 1:  # "local": the ranks' mean of their statistics
                both = torch.cat([mean, var])
                dist.all_reduce(both)
                mean, var = (both / world).chunk(2)
            self._update(mean, var)
        return y.to(self.dtype or x.dtype)

    def _update(self, mean, var):
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


class _SyncBatchNorm(torch.autograd.Function):
    """Training-mode BatchNorm of an NCHW input with the statistics of the
    global batch (module doc). Returns (y, mean, biased var); the two
    statistics are constants."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        c, dims = x.shape[1], (0, 2, 3)
        f32 = torch.float32
        total = torch.cat([
            x.sum(dims, dtype=f32),
            torch.linalg.vector_norm(x, 2, dims, dtype=f32).square(),
            x.new_full((1,), x.numel() // c, dtype=f32)])
        dist.all_reduce(total)
        n = total[2 * c]
        mean = total[:c] / n
        var = torch.clamp_min(total[c:2 * c] / n - mean * mean, 0.0)
        y = torch.native_batch_norm(x, weight, bias, mean, var, False, 0.0,
                                    eps)[0]
        ctx.save_for_backward(x, weight, mean, var)
        ctx.eps, ctx.n = eps, n
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, var = ctx.saved_tensors
        c = x.shape[1]
        w = weight if weight is not None else mean.new_ones(c)
        invstd = torch.rsqrt(var + ctx.eps)
        # with the statistics constant (train=False; the CUDA kernel also
        # wants them as the saved ones): sum(dy * xhat) and sum(dy), fp32
        _, gw, gb = torch.ops.aten.native_batch_norm_backward(
            dy, x, w, mean, var, mean, invstd, False, ctx.eps,
            [False, True, True])
        sums = torch.cat([gb, gw]).float()
        dist.all_reduce(sums)
        # dx = w * invstd * (dy - (sum dy + xhat * sum(dy * xhat)) / n)
        #    = w * invstd * dy - a - b * x, in fp32, rounded once
        wi = w * invstd
        b = wi * invstd * sums[c:] / ctx.n
        a = wi * sums[:c] / ctx.n - b * mean
        dx = torch.addcmul(_channel(-a), x, _channel(-b))
        dx.addcmul_(dy, _channel(wi))
        return (dx.to(x.dtype), gw if weight is not None else None, gb,
                None)
