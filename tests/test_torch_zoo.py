"""The model zoo's trunks in the port against the JAX package, on the CPU
in fp32 (the grouped deformable conv: tests/test_torch_zoo_deform.py; the
detectors: tests/test_torch_zoo_detector.py).

``ResNeXtTrunk`` at narrow filters (16, 32, 64, 128, 256), 8 groups, units
(1, 1, 1, 1), on 96x64 inputs, and ``MobileNetV2Trunk`` at full width on
128x128 inputs (a 4x4 map at stride 32: with fewer samples per channel the
batch variance of the last units is ill-conditioned, and flax's
E[x^2] - E[x]^2 parts from torch's in the fourth digit), against the flax
trunks (jitted) on seeded, perturbed variables converted in: eval mode,
and train mode (outputs close_to_scale, and every running statistic within
rtol 1e-4: the moved ones, and the frozen ones of the stem and ResNeXt's
stage 1 unmoved).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sniper_tpu_torch.convert import _LEAF, load_flax_variables
from test_torch_detector import _perturb
from torch_port import close_to_scale, flax_shapes, torch_default_threads


# ---------------------------------------------------------------------------
# trunks against flax
# ---------------------------------------------------------------------------

NARROW = dict(units=(1, 1, 1, 1), filters=(16, 32, 64, 128, 256),
              num_groups=8)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _random_tree(shapes, rng):
    """Variables of the tree ``shapes``: convs N(0, 1/fan_in), zero biases,
    identity BatchNorms (then _perturb moves the BatchNorms, the offset
    convs and the biases)."""
    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("kernel", "conv2_kernel"):
                out[k] = (rng.randn(*v.shape)
                          / math.sqrt(np.prod(v.shape[:-1]))).astype(
                              np.float32)
            elif k in ("scale", "var"):
                out[k] = np.ones(v.shape, np.float32)
            else:
                out[k] = np.zeros(v.shape, np.float32)
        return out

    return _perturb({c: walk(dict(t)) for c, t in shapes.items()}, rng)


def _trunks(kind, rng):
    """(flax trunk, its variables as NumPy, the port's trunk with them
    converted in, input NHWC)."""
    if kind == "resnext":
        from sniper_tpu.models.resnext import ResNeXtTrunk as J
        from sniper_tpu_torch.models.resnext import ResNeXtTrunk as T

        jm = J(dtype=jnp.float32, **NARROW)
        tm = T(dtype=torch.float32, **NARROW)
        x = rng.randn(2, 96, 64, 3).astype(np.float32)
    else:
        from sniper_tpu.models.mobilenetv2 import MobileNetV2Trunk as J
        from sniper_tpu_torch.models.mobilenetv2 import MobileNetV2Trunk as T

        jm = J(dtype=jnp.float32)
        tm = T(dtype=torch.float32)
        x = rng.randn(2, 128, 128, 3).astype(np.float32)
    variables = _random_tree(flax_shapes(jm, jnp.asarray(x[:1]),
                                         train=False), rng)
    load_flax_variables(tm, variables)
    return jm, variables, tm, x


def _tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", ["resnext", "mobilenetv2"])
def test_trunk_matches_flax(rng, kind, train):
    jm, variables, tm, x = _trunks(kind, rng)

    @jax.jit
    def apply(v, x):
        if train:
            return jm.apply(v, x, train=True,
                            mutable=["batch_stats", "intermediates"])
        return jm.apply(v, x, train=False), {}

    (jc4, jc5), mutated = apply(variables, jnp.asarray(x))
    tm.train(train)
    # at one torch thread, MobileNetV2's training BatchNorms sum their
    # statistics serially in fp32 and the train case drifts 6.9e-4 from
    # flax (atol 4.7e-4); at torch's default count, 3.3e-4
    with torch.no_grad(), torch_default_threads():
        c4, c5 = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    close_to_scale(c4.permute(0, 2, 3, 1), jc4)
    close_to_scale(c5.permute(0, 2, 3, 1), jc5)
    stats = mutated["batch_stats"] if train else variables["batch_stats"]
    state = tm.state_dict()
    n = 0
    for path, want in _leaves(stats):
        key = ".".join(path[:-1] + (_LEAF["batch_stats", path[-1]],))
        np.testing.assert_allclose(state[key].numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
        n += 1
    assert n == 2 * sum(k.endswith("running_var") for k in state)
    if train:  # stages 2-4 / every unit moved; the stem and stage 1 not
        moved = [p for p, v in _leaves(stats) if not np.array_equal(
            np.asarray(v), _tree_get(variables["batch_stats"], p))]
        assert moved
        assert not [p for p in moved if p[0].startswith(("bn0", "stage1"))]
