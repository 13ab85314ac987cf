"""The model zoo's detectors in the port against the JAX package, on the CPU
in fp32: ResNeXt-101 (``resnext_mx_101``) and MobileNetV2
(``mobilenetv2_e2e``).

- The registry builds ``resnext_mx_101`` on the flagship yml and
  ``mobilenetv2_e2e`` on its own yml, and knows the JAX registry's names.
- ``convert`` maps every leaf of both tiny detectors' flax trees
  (tests/torch_port.py's ZOO) exactly once, with the grouped [3,3,f/64,f]
  and depthwise [3,3,1,exp] layouts.
- ``mapping_rows`` equals the JAX import's ``_mapping_rows`` as (key, MXNet
  name) pairs: no row for ResNeXt's ``sc_bn``, none in MobileNetV2's
  trunk; so a backbone file under each yml's FIXED_PARAMS stops at
  ``verify_fixed_params`` in both packages.
- ``init_detector`` follows the flax initialisers (per-layer std).
- The inference forward and the training steps (three for X101, one for
  MobileNetV2: the generator's docstring says why) against the JAX
  detector's, frozen in tests/fixtures/torch_zoo_golden.json by
  scripts/gen_torch_zoo_golden.py (its train-step compiles take minutes
  here): roi_valid equal, rois within 1e-3 px, roi_scores, cls_prob and
  bbox_pred close_to_scale (rtol 1e-4, atol 1e-4 of max|want|); the steps
  with tests/test_torch_train_step.py's tolerances (losses rtol 1e-3,
  each kept leaf's change within 2e-2 relative L2, running statistics
  rtol 1e-4, frozen leaves unmoved).
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from sniper_tpu_torch.convert import _LEAF, convert, flax_to_torch
from sniper_tpu_torch.train.optimizer import is_fixed, make_optimizer
from sniper_tpu_torch.train.trainer import make_train_step
from torch_port import ZOO, close_to_scale, tiny_torch_detector, \
    zoo_variables

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import gen_torch_zoo_golden as zg  # noqa: E402

KINDS = ("resnext", "mobilenetv2")


@pytest.fixture(scope="module")
def golden():
    with open(zg.FIXTURE) as f:
        return json.load(f)


def test_registry_builds_the_zoo():
    from sniper_tpu.models.registry import list_models as jlist
    from sniper_tpu_torch.config import load_config
    from sniper_tpu_torch.models.registry import get_model, list_models

    assert list_models() == jlist()
    cfg = load_config("configs/sniper_mobilenetv2_e2e.yml")
    with torch.device("meta"):
        m = get_model(cfg)
    assert m.trunk_type == "mobilenetv2" and m.feat_stride == 32
    assert m.rcnn.spatial_scale == 1 / 32
    assert m.rcnn.fc_new_2.weight.shape == (512, 512)
    assert m.rpn.rpn_conv_3x3.weight.shape[1] == 1280
    assert m.conv_new_1.weight.shape[1] == 1280
    cfg = load_config("configs/sniper_res101_e2e.yml")
    cfg.symbol = "resnext_mx_101"
    with torch.device("meta"):
        m = get_model(cfg)
    assert m.trunk_type == "resnext" and m.trunk.units == (3, 4, 23, 3)
    assert m.feat_stride == 16
    assert m.rcnn.fc_new_2.weight.shape == (1024, 1024)
    assert m.rpn.rpn_conv_3x3.weight.shape[1] == 3072
    assert m.trunk.stage4_unit3.conv2_weight.shape == (2048, 32, 3, 3)
    assert m.trunk.stage1_unit1.conv2_weight.shape == (256, 4, 3, 3)


@pytest.fixture(scope="module", params=KINDS)
def zoo(request):
    return request.param, zoo_variables(request.param)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_convert_maps_every_leaf_once(zoo):
    kind, variables = zoo
    model = tiny_torch_detector(**ZOO[kind])
    sd = convert(variables, model)
    leaves = list(_leaves(variables))
    assert len(sd) == len(leaves) == len(model.state_dict())
    for path, value in leaves:
        key = ".".join(path[1:-1] + (_LEAF[path[0], path[-1]],))
        np.testing.assert_array_equal(sd[key].numpy(),
                                      flax_to_torch(value, path[-1]))
    p = variables["params"]["trunk"]
    if kind == "resnext":
        k = p["stage1_unit1"]["conv2_kernel"]  # [3,3,f/64,f]
        assert k.shape == (3, 3, 4, 256)
        np.testing.assert_array_equal(
            sd["trunk.stage1_unit1.conv2_weight"].numpy(),
            k.transpose(3, 2, 0, 1))
        assert p["stage4_unit1"]["conv2_kernel"].shape == (3, 3, 32, 2048)
    else:
        k = p["seq1_block0"]["depthwise"]["conv2d"]["kernel"]  # [3,3,1,exp]
        assert k.shape == (3, 3, 1, 96)
        np.testing.assert_array_equal(
            sd["trunk.seq1_block0.depthwise.conv2d.weight"].numpy(),
            k.transpose(3, 2, 0, 1))


def test_mapping_rows_equal_jax(zoo):
    from sniper_tpu.train.pretrained import _mapping_rows
    from sniper_tpu_torch.train.pretrained import mapping_rows

    kind, variables = zoo
    want = {(".".join(path[:-1] + (_LEAF[coll, path[-1]],)), mx)
            for coll, path, mx, _ in _mapping_rows(variables["params"],
                                                   variables["batch_stats"])}
    got = mapping_rows(tiny_torch_detector(**ZOO[kind]))
    assert len(got) == len(set(got)) == len(want)
    assert set(got) == want
    trunk = {k for k, _ in got if k.startswith("trunk.")}
    if kind == "resnext":
        assert "trunk.stage1_unit1.sc.weight" in trunk
        assert "trunk.stage1_unit1.conv2_weight" in trunk
        assert "trunk.stage4_unit1.offset.bias" in trunk
        assert not any(".sc_bn." in k for k in trunk)
    else:
        assert not trunk


def test_backbone_under_the_yml_fixed_params_stops_in_both(zoo, tmp_path):
    """A backbone file of every trunk row, imported under the yml's
    FIXED_PARAMS, raises in both packages: X101's stage-1 ``sc_bn`` and
    MobileNetV2's ``first_conv`` have no row, so they would stay frozen at
    their init."""
    from sniper_tpu.train import pretrained as jpre
    from sniper_tpu_torch.train import pretrained as tpre

    kind, variables = zoo
    model = tiny_torch_detector(**ZOO[kind])
    state = model.state_dict()
    flat = {mx: state[key].numpy() for key, mx in tpre.mapping_rows(model)
            if key.startswith("trunk.")}
    flat["conv_new_1_bias"] = np.zeros(256, np.float32)
    fixed = zg.FIXED[kind]
    _, jrep = jpre.import_reference_params(flat, variables)
    with pytest.raises(jpre.MXParamsError) as jerr:
        jpre.verify_fixed_params(jrep, variables["params"], fixed)
    _, trep = tpre.import_reference_params(flat, model)
    with pytest.raises(tpre.MXParamsError) as terr:
        tpre.verify_fixed_params(trep, model, fixed)
    culprit = "sc_bn" if kind == "resnext" else "first_conv"
    assert culprit in str(jerr.value) and culprit in str(terr.value)
    unloaded = {n for n, _ in model.named_parameters()
                if is_fixed(n, fixed)} - {k for k, _ in trep.loaded}
    assert unloaded and all(culprit in n for n in unloaded)


def test_init_detector_follows_the_flax_init():
    from sniper_tpu_torch.models.init import init_detector

    def std_ok(w, std):
        assert abs(float(w.std()) / std - 1) < 0.05, (w.shape, std)
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6

    x = init_detector(tiny_torch_detector(**ZOO["resnext"]),
                      seed=1).requires_grad_(False)
    w = x.trunk.stage3_unit1.conv1.weight
    std_ok(w, math.sqrt(1.0 / w[0].numel()))
    for unit in ("stage2_unit1", "stage4_unit1"):  # plain and deformable
        d = getattr(x.trunk, unit).conv2_weight  # fan_out = 9 * out
        std_ok(d, math.sqrt(2.0 / (9 * d.shape[0])))
    assert float(x.trunk.stage4_unit1.offset.weight.abs().max()) == 0.0
    assert float(x.trunk.stage4_unit1.offset.bias.abs().max()) == 0.0
    bn = x.trunk.stage2_unit1.sc_bn
    assert bool((bn.weight == 1).all()) and bool((bn.bias == 0).all())
    assert bool((bn.running_mean == 0).all())
    assert bool((bn.running_var == 1).all())
    assert abs(float(x.rcnn.fc_new_1.weight.std()) / 0.01 - 1) < 0.05

    m = init_detector(tiny_torch_detector(**ZOO["mobilenetv2"]),
                      seed=1).requires_grad_(False)
    dw = m.trunk.seq5_block1.depthwise.conv2d.weight  # fan_in 9
    assert dw.shape == (960, 1, 3, 3)
    std_ok(dw, 1 / 3)
    w = m.trunk.last_conv.conv2d.weight
    std_ok(w, math.sqrt(1.0 / w[0].numel()))
    bn = m.trunk.first_conv.batchnorm
    assert bool((bn.weight == 1).all()) and bool((bn.running_var == 1).all())
    assert abs(float(m.rpn.rpn_conv_3x3.weight.std()) / 0.01 - 1) < 0.05


@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_jax(golden, kind):
    want = golden[kind]["forward"]
    model = tiny_torch_detector(zg.forward_variables(kind), **ZOO[kind])
    data, im_info = zg.forward_inputs(kind)
    with torch.inference_mode():
        got = model(torch.from_numpy(data), torch.from_numpy(im_info))
    np.testing.assert_array_equal(got["roi_valid"].numpy(),
                                  np.asarray(want["roi_valid"]))
    np.testing.assert_allclose(got["rois"].numpy(),
                               np.asarray(want["rois"], np.float32),
                               atol=1e-3, rtol=1e-5)
    for k in ("roi_scores", "cls_prob", "bbox_pred"):
        close_to_scale(got[k], np.asarray(want[k], np.float32))


@pytest.mark.parametrize("kind", KINDS)
def test_train_steps_match_jax(golden, kind):
    want = golden[kind]
    variables = zg.train_variables(kind)
    model = tiny_torch_detector(variables, **zg.model_kwargs(kind))
    opt, sched, _ = make_optimizer(zg.make_cfg(kind), 100, model)
    step = make_train_step(model, opt, sched, zg.gg.B,
                           pixel_means=(0.0, 0.0, 0.0))
    batch = {k: torch.from_numpy(v) for k, v in zg.make_batch(kind).items()}
    for i in range(want["steps"]):
        got = step(batch)
        assert set(got) >= set(zg.metric_names(kind))
        for k in zg.metric_names(kind):
            if k.startswith(("rcnn_acc", "rcnn_fg")):
                tol = dict(rtol=0, atol=0.04)
            elif k.endswith("_max"):
                tol = dict(rtol=2e-2, atol=1e-9)
            else:
                tol = dict(rtol=1e-3, atol=1e-6)
            np.testing.assert_allclose(float(got[k]), want["metrics"][i][k],
                                       err_msg=f"step {i} {k}", **tol)
    state = model.state_dict()
    for key, value in want["leaves"].items():
        coll, *path = key.split("/")
        got = state[".".join(path[:-1] + [_LEAF[coll, path[-1]]])].numpy()
        value = flax_to_torch(np.asarray(value, np.float32), path[-1])
        path = "/".join(path)
        if coll == "batch_stats":
            np.testing.assert_allclose(got, value, rtol=1e-4, atol=1e-6,
                                       err_msg=key)
            continue
        p0 = flax_to_torch(zg.gg.leaf(variables[coll], path),
                           path.split("/")[-1])
        if is_fixed(path.replace("/", "."), zg.FIXED[kind]):
            np.testing.assert_array_equal(got, p0, err_msg=key)
            continue
        move = value - p0
        assert np.abs(move).max() > 0, key
        err = np.linalg.norm((got - p0) - move) / np.linalg.norm(move)
        assert err <= 2e-2, (key, err)
