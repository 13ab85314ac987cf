"""flax ``variables`` (as NumPy) -> the port's ``state_dict``.

The port's modules carry the flax tree's names, so a leaf's path maps to a
key directly; only the leaf names and layouts change:

- ``kernel`` of a conv, HWIO -> ``weight``, OIHW (a grouped conv's
  [kh,kw,in/groups,out] -> [out,in/groups,kh,kw]: MobileNetV2's depthwise
  [3,3,1,exp] -> [exp,1,3,3]);
- ``kernel`` of a transposed conv (flax ``ConvTranspose``, [kh,kw,in,out])
  -> ``weight`` of ``nn.ConvTranspose2d``, [in,out,kh,kw], flipped in both
  spatial axes: with flax's SAME padding and untransposed kernel, output
  row 2i + a of the stride-2 2x2 deconv takes tap 1 - a, torch's tap a;
- ``conv2_kernel`` (the deformable 3x3 of ResNet's C5, [3,3,mid,mid], and
  ResNeXt's grouped 3x3 of every unit, [3,3,f/64,f]) -> ``conv2_weight``,
  OIHW ([f,f/64,3,3]);
- ``kernel`` of a ``_Lin`` / Dense, [in, out] -> ``weight``, [out, in];
- ``bias`` -> ``bias``; BatchNorm ``scale`` -> ``weight``;
- batch_stats ``mean`` / ``var`` -> ``running_mean`` / ``running_var``.

``convert`` fails loudly on any flax leaf it leaves unmapped and on any
port parameter that nothing fills.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "conv2_kernel"): "conv2_weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _leaves(tree: Mapping, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def flax_to_torch(value: np.ndarray, leaf: str,
                  transposed: bool = False) -> np.ndarray:
    """One leaf's layout change (see the module doc); ``transposed`` for
    the kernel of a transposed conv."""
    if transposed and leaf == "kernel":
        return value[::-1, ::-1].transpose(2, 3, 0, 1)  # -> [in,out,kh,kw]
    if leaf in ("kernel", "conv2_kernel") and value.ndim == 4:
        return value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if leaf == "kernel" and value.ndim == 2:
        return value.T  # [in, out] -> [out, in]
    return value


def convert(variables: Mapping, model: nn.Module) -> dict:
    """Map flax variables onto ``model``'s state_dict keys and shapes.

    Raises ValueError listing every flax leaf with no port counterpart,
    every port parameter or buffer left unfilled, and every shape that
    disagrees."""
    want = model.state_dict()
    deconvs = {name for name, m in model.named_modules()
               if isinstance(m, nn.ConvTranspose2d)}
    out, unmapped, bad_shape = {}, [], []
    for path, value in _leaves(variables):
        name = _LEAF.get((path[0], path[-1]))
        key = ".".join(path[1:-1] + (name,)) if name else None
        if key not in want or key in out:
            unmapped.append("/".join(path))
            continue
        t = torch.tensor(flax_to_torch(
            value, path[-1], ".".join(path[1:-1]) in deconvs).copy(),
            dtype=want[key].dtype)
        if tuple(t.shape) != tuple(want[key].shape):
            bad_shape.append(f"{key}: {tuple(t.shape)} vs "
                             f"{tuple(want[key].shape)}")
        out[key] = t
    missing = sorted(set(want) - set(out))
    if unmapped or missing or bad_shape:
        raise ValueError(
            "flax -> torch conversion incomplete:\n"
            f"  unmapped flax leaves: {unmapped}\n"
            f"  unfilled port keys: {missing}\n"
            f"  shape mismatches: {bad_shape}")
    return out


def load_flax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Convert ``variables`` and load them into ``model`` (strict)."""
    model.load_state_dict(convert(variables, model), strict=True)
    return model
