"""flax variables -> the port's state_dict (sniper_tpu_torch/convert.py)."""

import numpy as np
import pytest
import torch

from sniper_tpu_torch.convert import convert, flax_to_torch
from torch_port import tiny_jax_detector, tiny_torch_detector


@pytest.fixture(scope="module")
def tiny():
    _, variables = tiny_jax_detector(0)
    return variables, tiny_torch_detector()


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_every_leaf_maps_exactly_once(tiny):
    variables, model = tiny
    sd = convert(variables, model)
    leaves = list(_leaves(variables))
    assert len(sd) == len(leaves) == len(model.state_dict())
    # every flax value lands, transposed as documented, under its own key
    for path, value in leaves:
        hits = [k for k, t in sd.items()
                if t.shape == flax_to_torch(value, path[-1]).shape
                and np.array_equal(t.numpy(), flax_to_torch(value, path[-1]))]
        assert hits, "/".join(path)


def test_layouts(tiny):
    variables, model = tiny
    sd = convert(variables, model)
    p = variables["params"]
    conv = p["trunk"]["stage1_unit1"]["conv1"]["kernel"]  # HWIO
    np.testing.assert_array_equal(
        sd["trunk.stage1_unit1.conv1.weight"].numpy(),
        conv.transpose(3, 2, 0, 1))
    dk = p["trunk"]["stage4_unit1"]["conv2_kernel"]
    assert sd["trunk.stage4_unit1.conv2_weight"].shape == (
        dk.shape[3], dk.shape[2], 3, 3)
    fc = p["rcnn"]["fc_new_1"]["kernel"]  # [in, out]
    np.testing.assert_array_equal(sd["rcnn.fc_new_1.weight"].numpy(), fc.T)
    np.testing.assert_array_equal(
        sd["trunk.bn_data.running_var"].numpy(),
        variables["batch_stats"]["trunk"]["bn_data"]["var"])
    assert "trunk.bn_data.weight" not in sd  # bn_data has no scale


def test_unmapped_leaf_fails_loudly(tiny):
    variables, model = tiny
    extra = {"params": dict(variables["params"],
                            autofocus={"conv_new_2": {"kernel": np.zeros(
                                (3, 3, 4, 4), np.float32)}}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="autofocus/conv_new_2/kernel"):
        convert(extra, model)


def test_unfilled_parameter_fails_loudly(tiny):
    variables, model = tiny
    rcnn = dict(variables["params"]["rcnn"])
    del rcnn["offset"]
    partial = {"params": dict(variables["params"], rcnn=rcnn),
               "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="rcnn.offset.weight"):
        convert(partial, model)


def test_shape_mismatch_fails_loudly(tiny):
    variables, _ = tiny
    wider = tiny_torch_detector(num_classes=7)
    with pytest.raises(ValueError, match="rcnn.cls_score"):
        convert(variables, wider)


def test_loaded_model_keeps_dtype(tiny):
    variables, model = tiny
    model.load_state_dict(convert(variables, model))
    assert all(p.dtype == torch.float32 for p in model.parameters())
