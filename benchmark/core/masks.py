"""The mask configuration's two sides: the reference mask detector
(benchmark/reference/mask.py) and the port's registry detector with the
mask branch, loaded with one seeded state dict.

The weights are benchmark/core/weights.make_weights on the reference mask
detector, with the mask branch's rules (``mask_rules``) added to the box
detector's: the convs feeding a ReLU He normal, the transposed conv's
fan-in its input channels (each output pixel takes one tap of each), the
output conv 1 / sqrt(fan_in) (pair logits of order one, so that the mask
probabilities spread over (0, 1)), ``mask_offset`` the R-CNN offset FC's
rule (window shifts of about a sample cell), every bias zero.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from benchmark.core import weights
from benchmark.core.program import program_cfg
from benchmark.reference.mask import MaskDetector


def mask_reference_model(config: dict, device="meta") -> MaskDetector:
    """The reference mask detector of the configuration (fp32)."""
    with torch.device(device):
        return MaskDetector(config["yml"], trunk=config["trunk"],
                            units=tuple(config.get("units", (3, 4, 23, 3))))


def mask_rules(model: MaskDetector) -> dict:
    """{state dict name: (kind, std)} of the mask branch (module doc)."""
    rules = {}
    for mname, m in model.mask.named_modules():
        if isinstance(m, nn.ConvTranspose2d):
            std = math.sqrt(2.0 / m.in_channels)
        elif isinstance(m, nn.Conv2d):
            fan = m.weight[0].numel()
            std = (1.0 if mname == "mask_out" else math.sqrt(2.0)) \
                / math.sqrt(fan)
        else:
            continue
        rules[f"mask.{mname}.weight"] = ("normal", std)
        rules[f"mask.{mname}.bias"] = ("zero", 0.0)
    fan = model.mask_offset.weight.shape[1]
    rules["mask_offset.weight"] = ("normal",
                                   weights.HEAD_OFFSET / math.sqrt(fan))
    rules["mask_offset.bias"] = ("zero", 0.0)
    return rules


def mask_seeded_weights(config: dict, seed: int, device) -> dict:
    """make_weights on the reference mask detector, the mask branch's rules
    over the box detector's."""
    model = mask_reference_model(config)
    # make_weights draws from weights._rules, the box detector's rules
    box_rules = weights._rules
    weights._rules = lambda m: {**box_rules(m), **mask_rules(m)}
    try:
        return weights.make_weights(model, seed, device)
    finally:
        weights._rules = box_rules


def mask_program_model(config: dict, seed: int, device):
    """(cfg, the port's registry mask detector with the seed's weights),
    built on ``device``; as program.program_model with the mask weights."""
    from sniper_tpu_torch.models.registry import get_model

    cfg = program_cfg(config)
    overrides = {}
    if "units" in config:
        overrides["units"] = tuple(config["units"])
    with torch.device(device):
        model = get_model(cfg, **overrides)
    state = mask_seeded_weights(config, seed, device)
    missing, unexpected = model.load_state_dict(state, strict=False)
    if unexpected or missing:
        raise KeyError(f"weights do not fit the program: missing "
                       f"{missing[:5]}, unexpected {unexpected[:5]}")
    return cfg, model
