"""Seeded random weights for both sides of a run, made on the device.

The benchmark makes the detector's weights itself, from the run's seed,
and hands the same state dict to the program and to the reference. One
``torch.randn`` over every parameter and buffer at once, on the device,
from a ``torch.Generator`` there; each tensor is then a slice of it,
scaled by its layer's rule. The rules keep a full-depth trunk's
activations of order one with frozen BatchNorm statistics, as a trained
model's are (a fresh init's would grow through the 33 residual units until
the RPN's scores saturate):

- convs and FCs feeding a ReLU: He normal, std sqrt(2 / fan_in);
- the last conv of each residual branch: RESIDUAL_GAIN times that, so the
  residual stream grows by a few percent a unit;
- the stem's first conv on raw pixels (no ``bn_data`` in front, ResNeXt)
  and ``bn_data``'s running variance: the pixels' spread PIXEL_STD taken
  out;
- BatchNorm: scale 1 + 0.1 z, bias 0.1 z, running mean 0.1 z, running
  variance 1 + 0.1 |z|;
- the C5 offset convs: std OFFSET_PX / sqrt(fan_in), offsets of about a
  pixel (a trained DCN's); the R-CNN offset FC: std HEAD_OFFSET /
  sqrt(fan_in), window shifts of about a sample cell;
- the RPN's score conv: std RPN_SCORE / sqrt(fan_in), so that its
  foreground probabilities spread over (0, 1) without saturating (at
  1 / sqrt(fan_in) R101's top percent read above 0.9999 and X101's median
  0.92, and the order of those near-ties, which picks the proposals, was
  rounding's); the R-CNN's
  class FC: std 1 / sqrt(fan_in); the two box layers: 0.1 / sqrt(fan_in),
  box deltas of tenths;
- every bias: zero.

The names and shapes are the reference detector's, which are the
program's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from benchmark.reference import model as ref

RESIDUAL_GAIN = 0.2
PIXEL_STD = 60.0
OFFSET_PX = 1.0
HEAD_OFFSET = 0.1
RPN_SCORE = 0.3


def subseed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of the run (weights, images,
    ...), from the run's seed of any size."""
    words = [int(b) for b in stream.encode()]
    return int(np.random.SeedSequence([int(seed) % 2**64, *words])
               .generate_state(2, np.uint64)[0] >> np.uint64(1))


def _rules(model: nn.Module) -> dict:
    """{state dict name: (kind, std)} for the reference detector."""
    rules = {}
    for mname, m in model.named_modules():
        p = f"{mname}." if mname else ""
        if isinstance(m, ref.FrozenBN):
            if m.weight is not None:
                rules[p + "weight"] = ("one", 0.1)
            rules[p + "bias"] = ("normal", 0.1)
            if mname.endswith("bn_data"):
                rules[p + "running_mean"] = ("normal", 1.0)
                rules[p + "running_var"] = ("var", PIXEL_STD ** 2)
            else:
                rules[p + "running_mean"] = ("normal", 0.1)
                rules[p + "running_var"] = ("var", 1.0)
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            w = m.weight
            fan = w[0].numel()
            he = math.sqrt(2.0 / fan)
            if mname.endswith(".offset") and mname.startswith("trunk"):
                std = OFFSET_PX / math.sqrt(fan)
            elif mname == "rcnn.offset":
                std = HEAD_OFFSET / math.sqrt(fan)
            elif mname == "rpn.rpn_cls_score":
                std = RPN_SCORE / math.sqrt(fan)
            elif mname == "rcnn.cls_score":
                std = 1.0 / math.sqrt(fan)
            elif mname in ("rpn.rpn_bbox_pred", "rcnn.bbox_pred"):
                std = 0.1 / math.sqrt(fan)
            elif mname.endswith(".conv3"):  # the residual branch's last
                std = RESIDUAL_GAIN * he
            elif mname == "trunk.conv0" and not hasattr(model.trunk,
                                                        "bn_data"):
                std = he / PIXEL_STD
            else:
                std = he
            rules[p + "weight"] = ("normal", std)
            if m.bias is not None:
                rules[p + "bias"] = ("zero", 0.0)
        if hasattr(m, "conv2_weight"):
            w = m.conv2_weight
            rules[p + "conv2_weight"] = ("normal",
                                         math.sqrt(2.0 / w[0].numel()))
    return rules


def make_weights(model: nn.Module, seed: int, device) -> dict:
    """The state dict for ``model`` (the reference detector, on any device,
    the meta device included) drawn from ``seed`` on ``device``."""
    rules = _rules(model)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    missing = sorted(set(shapes) - set(rules))
    if missing:
        raise KeyError(f"no weight rule for {missing[:5]}")
    names = sorted(shapes)
    total = sum(math.prod(shapes[k]) for k in names)
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "weights"))
    z = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k in names:
        n = math.prod(shapes[k])
        v = z[at:at + n].reshape(shapes[k])
        at += n
        kind, s = rules[k]
        if kind == "normal":
            v = v * s
        elif kind == "one":
            v = 1.0 + v * s
        elif kind == "var":
            v = s * (1.0 + 0.1 * v.abs())
        else:
            v = torch.zeros_like(v)
        out[k] = v.contiguous()
    return out
