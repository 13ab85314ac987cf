"""The trunk's unit epilogue: a frozen BatchNorm, the ReLU and the residual
sum between two convs of a unit, in one pass (``csrc/unit_epilogue.cu``).

Three forms, which the trunks call for every BatchNorm (models/resnet.py,
models/resnext.py). Each is the chain of modules it replaces, with the
roundings where that chain rounds (the BatchNorm modules compute in fp32
and round to their dtype):

- ``bn_relu(a, bn)``: ``relu(bn(a))``, ``a`` cast to bn's dtype first: a
  unit's inner BatchNorm and ReLU, or the stem's ``bn0`` on its fp32 conv
  output.
- ``sum_bn_relu(h, sc, bn, keep_sum)``: ``x = h + sc``, rounded once, and
  ``relu(bn(x))``: a pre-activation unit's residual sum with the next
  unit's ``bn1``. ``x`` is returned only with ``keep_sum`` (the next unit's
  identity shortcut reads it).
- ``bn_add_relu(h, bn, s, sc_bn)``: ``relu(bn(h) + s)``, with the sum in
  fp32 rounded once: a ResNeXt unit's tail, ``s`` its input (the identity,
  summed in fp32) or ``sc_bn(s)`` (the projection).

Each form decides for itself: it runs the kernel where ``engages`` holds
for its input and BatchNorms (on the card, with nothing for autograd to
record, BatchNorms on running statistics producing bf16, and a
channels_last input), and its plain version, the module chain, everywhere
else: on the CPU, in training (batch statistics and their collectives),
in fp32. The plain version is also the kernel's reference: the kernel
computes the BatchNorm module's fp32 formula from the running statistics
(``w * (v - mean) * rsqrt(var + eps) + bias``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sniper_tpu_torch.ops import cuda

BF16 = torch.bfloat16
CHANNELS_LAST = torch.channels_last

FORM_BN_RELU, FORM_SUM_BN_RELU, FORM_BN_ADD_RELU = 1, 2, 3


def applies(x: torch.Tensor, *bns) -> bool:
    """Every condition of ``engages`` but the device: autograd records
    nothing, each BatchNorm uses its running statistics
    (``use_running_average``, models/norm.py) and produces bf16, and ``x``
    (bf16, or the stem's fp32) is channels_last."""
    return (not torch.is_grad_enabled()
            and x.dtype in (BF16, torch.float32)
            and x.is_contiguous(memory_format=CHANNELS_LAST)
            and all(bn.dtype == BF16 and bn.use_running_average
                    for bn in bns))


def engages(x: torch.Tensor, *bns) -> bool:
    """Whether a form on ``x`` with ``bns`` runs the kernel."""
    return x.is_cuda and applies(x, *bns)


def bn_relu_plain(a, bn):
    return F.relu(bn(a.to(bn.dtype)), inplace=True)


def sum_bn_relu_plain(h, sc, bn, keep_sum):
    x = h + sc
    return (x if keep_sum else None), F.relu(bn(x), inplace=True)


def bn_add_relu_plain(h, bn, s, sc_bn=None):
    s = s.float() if sc_bn is None else sc_bn(s)
    return F.relu(bn(h) + s).to(bn.dtype)


# The wrapper runs once per epilogue, so on the host it has to cost less
# than the torch ops it replaces: each check takes the fast test first and
# calls cuda.require (which raises with the reason) only when that fails.

def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if not (t.is_cuda and t.dtype == dtype and t.shape == shape
            and t.is_contiguous(memory_format=CHANNELS_LAST)):
        cuda.require(t, name, dtype, shape, memory_format=CHANNELS_LAST)


_BN_TENSORS = ("running_mean", "running_var", "weight", "bias")


def _bn_args(bn, C: int) -> list:
    """The BatchNorm's four fp32 vectors of C as pointers, and its eps."""
    args = []
    for name in _BN_TENSORS:
        t = getattr(bn, name)
        if not (t.is_cuda and t.dtype == torch.float32 and t.shape == (C,)
                and t.is_contiguous()):
            cuda.require(t, name, torch.float32, (C,))
        args.append(t.data_ptr())
    args.append(bn.eps)
    return args


_NO_BN = (None, None, None, None, 0.0)


def _launch(form, a, b, out, out2, bn1, bn2=None) -> None:
    """One kernel launch; ``out`` and ``out2`` come from ``empty_like(a)``,
    so they share a's layout."""
    shape = a.shape
    C = shape[1]
    if C % 8 or a.dtype != BF16 and (form != FORM_BN_RELU
                                     or a.dtype != torch.float32):
        raise ValueError(f"unit_epilogue form {form} needs C % 8 == 0 and "
                         f"bf16 (form 1 also float32), got C={C}, {a.dtype}")
    _check(a, "a", a.dtype, shape)
    if b is not None:
        _check(b, "b", BF16, shape)
    cuda.UNIT_EPILOGUE.launches += 1
    cuda.check(cuda.library().sniper_unit_epilogue(
        form, a.data_ptr(), a.dtype == torch.float32,
        None if b is None else b.data_ptr(),
        None if out is None else out.data_ptr(),
        None if out2 is None else out2.data_ptr(),
        *_bn_args(bn1, C), *(_NO_BN if bn2 is None else _bn_args(bn2, C)),
        a.numel() // 8, C, cuda.stream(a)), "unit_epilogue")


def _empty(like: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(like, dtype=BF16)


def bn_relu(a: torch.Tensor, bn) -> torch.Tensor:
    """``relu(bn(a))`` in bn's dtype; ``a`` [N, C, H, W], bf16 or fp32 for
    the kernel."""
    if not engages(a, bn):
        return bn_relu_plain(a, bn)
    act = _empty(a)
    _launch(FORM_BN_RELU, a, None, act, None, bn)
    return act


def sum_bn_relu(h: torch.Tensor, sc: torch.Tensor, bn, keep_sum: bool):
    """``(x, relu(bn(x)))`` with ``x = h + sc``; x is None unless
    ``keep_sum``."""
    if not engages(h, bn):
        return sum_bn_relu_plain(h, sc, bn, keep_sum)
    x = _empty(h) if keep_sum else None
    act = _empty(h)
    _launch(FORM_SUM_BN_RELU, h, sc, x, act, bn)
    return x, act


def bn_add_relu(h: torch.Tensor, bn, s: torch.Tensor,
                sc_bn=None) -> torch.Tensor:
    """``relu(bn(h) + s)`` in bn's dtype, ``s`` the identity or, with
    ``sc_bn``, ``sc_bn(s)``."""
    bns = (bn,) if sc_bn is None else (bn, sc_bn)
    if not engages(h, *bns):
        return bn_add_relu_plain(h, bn, s, sc_bn)
    out = _empty(h)
    _launch(FORM_BN_ADD_RELU, h, s, out, None, bn, sc_bn)
    return out
