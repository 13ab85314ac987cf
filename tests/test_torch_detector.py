"""A tiny detector (units=(1,1,1,1)) with converted weights against the JAX
detector, stage by stage, on the CPU in fp32.

The flax init leaves BatchNorm at identity and every deformable offset at
zero, so the variables are perturbed first (BN statistics and affine, the
C5 offset convs, the R-CNN offset FC) to make each of them matter.

Stages: trunk C4/C5, then the RPN. Near-tied RPN scores make the NMS order
framework-dependent (the two frameworks' convolutions differ in the last
bits), so each later stage gets the JAX stage's output as its input:
proposals from the JAX RPN outputs, the R-CNN head from the JAX rois and
roi feature map. Then the whole forward is compared. Inputs are unit-scale
noise, so the random RPN's scores spread over (0.2, 0.9) with no two near
a tie; larger inputs saturate them at exactly 0 and 1.

Tolerances: fp32 convolutions sum in another order (about 1e-6 relative per
layer): rtol 1e-4 with an atol of 1e-4 of the tensor's scale; boxes within
1e-3 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sniper_tpu.models.heads import RCNNHead as JRCNNHead
from sniper_tpu.models.heads import RPNHead as JRPNHead
from sniper_tpu.models.resnet import ResNetTrunk as JTrunk
from sniper_tpu.ops.proposals import make_anchors_ahw
from sniper_tpu.ops.proposals import multi_proposal as jmulti_proposal
from sniper_tpu_torch.ops.proposals import multi_proposal
from torch_port import TINY, close_to_scale, tiny_jax_detector, \
    tiny_torch_detector

B, H, W = 2, 64, 96


def _perturb(variables, rng):
    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            p = path + (k,)
            if isinstance(v, dict):
                out[k] = walk(v, p)
            elif k in ("mean", "bias") and p[0] == "batch_stats":
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            elif k == "var" or k == "scale":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif "offset" in p and k == "kernel":
                out[k] = (rng.randn(*v.shape) * 0.01).astype(np.float32)
            elif k == "bias":
                out[k] = (v + rng.randn(*v.shape) * 0.01).astype(np.float32)
            else:
                out[k] = v
        return out

    return {c: walk(t, (c,)) for c, t in variables.items()}


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.RandomState(7)
    jmodel, variables = tiny_jax_detector(3)
    variables = _perturb(variables, rng)
    data = rng.randn(B, H, W, 3).astype(np.float32)
    im_info = np.array([[H, W, 1.0], [H - 8, W - 20, 1.0]], np.float32)
    return jmodel, variables, tiny_torch_detector(variables), data, im_info


def _sub(variables, name):
    out = {"params": variables["params"][name]}
    if name in variables.get("batch_stats", {}):
        out["batch_stats"] = variables["batch_stats"][name]
    return out


def _jax_stages(variables, data):
    c4, c5 = JTrunk(units=TINY["units"], dtype=jnp.float32).apply(
        _sub(variables, "trunk"), jnp.asarray(data), train=False)
    feat = jnp.concatenate([c4, c5], axis=-1)
    cls, bbox = JRPNHead(TINY["num_anchors"], dtype=jnp.float32).apply(
        _sub(variables, "rpn"), feat)
    k = variables["params"]["conv_new_1"]
    roi_feat = jax.nn.relu(feat @ k["kernel"][0, 0] + k["bias"])
    return c4, c5, feat, cls, bbox, roi_feat


def test_trunk_and_rpn_match_jax(tiny):
    _, variables, model, data, _ = tiny
    c4, c5, feat, cls, bbox, _ = _jax_stages(variables, data)
    with torch.inference_mode():
        t4, t5 = model.trunk(torch.from_numpy(data).permute(0, 3, 1, 2))
        close_to_scale(t4.permute(0, 2, 3, 1), c4)
        close_to_scale(t5.permute(0, 2, 3, 1), c5)
        tcls, tbbox = model.rpn(torch.from_numpy(np.array(feat))
                                .permute(0, 3, 1, 2))
    close_to_scale(tcls, cls)
    close_to_scale(tbbox, bbox)


def test_proposals_from_jax_rpn_outputs(tiny):
    _, variables, _, data, im_info = tiny
    _, _, feat, cls, bbox, _ = _jax_stages(variables, data)
    fg = np.array(jax.nn.softmax(cls, axis=3)[..., 1, :]
                  .transpose(0, 3, 1, 2))
    fh, fw = feat.shape[1:3]
    anchors = make_anchors_ahw(fh, fw, 16, TINY["anchor_ratios"],
                               TINY["anchor_scales"])
    kw = dict(pre_nms=TINY["pre_nms_top_n"], post_nms=TINY["post_nms_top_n"],
              thresh=0.7, min_size=0.0)
    jr, js, jv = jmulti_proposal(jnp.asarray(fg), bbox, jnp.asarray(im_info),
                                 jnp.asarray(anchors), **kw)
    tr, ts, tv = multi_proposal(torch.from_numpy(fg),
                                torch.from_numpy(np.array(bbox)),
                                torch.from_numpy(im_info),
                                torch.from_numpy(anchors), **kw)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-3,
                               rtol=1e-5)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_head_from_jax_rois_and_features(tiny):
    jmodel, variables, model, data, im_info = tiny
    _, _, feat, cls, bbox, roi_feat = _jax_stages(variables, data)
    out = jmodel.apply(variables, jnp.asarray(data), jnp.asarray(im_info),
                       train=False)
    rois = np.array(out["rois"]).reshape(-1, 5)
    jcls, jbox = JRCNNHead(TINY["num_classes"], spatial_scale=1 / 16,
                           margin_bins=1).apply(
        _sub(variables, "rcnn"), roi_feat, jnp.asarray(rois))
    with torch.inference_mode():
        tcls, tbox = model.rcnn(torch.from_numpy(np.array(roi_feat)),
                                torch.from_numpy(rois))
    close_to_scale(tcls, jcls)
    close_to_scale(tbox, jbox)


def test_whole_forward_matches_jax():
    rng = np.random.RandomState(11)
    jmodel, variables = tiny_jax_detector(5)
    variables = _perturb(variables, rng)
    model = tiny_torch_detector(variables)
    data = rng.randn(B, H, W, 3).astype(np.float32)
    im_info = np.array([[H, W, 1.0], [H - 8, W - 20, 1.0]], np.float32)
    want = jmodel.apply(variables, jnp.asarray(data), jnp.asarray(im_info),
                        train=False)
    with torch.inference_mode():
        got = model(torch.from_numpy(data), torch.from_numpy(im_info))
    np.testing.assert_array_equal(got["roi_valid"].numpy(),
                                  np.asarray(want["roi_valid"]))
    np.testing.assert_allclose(got["rois"].numpy(), np.asarray(want["rois"]),
                               atol=1e-3, rtol=1e-5)
    close_to_scale(got["roi_scores"], want["roi_scores"])
    close_to_scale(got["cls_prob"], want["cls_prob"])
    close_to_scale(got["bbox_pred"], want["bbox_pred"])


def test_unported_branches_raise():
    # mask training is ported (test_torch_mask_train); a batch without
    # gt_masks raises the JAX package's ValueError
    model = tiny_torch_detector(with_mask=True)
    with pytest.raises(ValueError, match="no gt_masks"):
        model(torch.zeros(1, 64, 64, 3), torch.tensor([[64.0, 64.0, 1.0]]),
              torch.zeros(1, 1, 5), torch.tensor([[0.0, 1e5]]), train=True)
    # the RPN-only mode is ported (test_torch_rpn_only): no head modules
    rpn = tiny_torch_detector(rpn_only=True, with_mask=True)
    assert not rpn.with_mask
    assert {n for n, _ in rpn.named_children()} == {"trunk", "rpn"}


def test_init_detector_follows_the_flax_init():
    """Seeded random weights (models/init.py) with the flax initializers'
    distributions: lecun truncated normal for convs, variance_scaling(2,
    fan_out) for the deformable 3x3, normal(0.01) for the heads, zeros (or
    normal(offset_std)) for the offsets, identity BatchNorm."""
    import math

    from sniper_tpu_torch.models.init import init_detector

    m = init_detector(tiny_torch_detector(), seed=1).requires_grad_(False)
    w = m.trunk.stage3_unit1.conv1.weight
    std = math.sqrt(1.0 / w[0].numel())
    assert abs(float(w.std()) / std - 1) < 0.05
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    d = m.trunk.stage4_unit1.conv2_weight
    assert abs(float(d.std()) / math.sqrt(2.0 / (9 * d.shape[0])) - 1) < 0.05
    assert abs(float(m.rcnn.fc_new_1.weight.std()) / 0.01 - 1) < 0.05
    assert float(m.trunk.stage4_unit1.offset.weight.abs().max()) == 0.0
    assert float(m.rcnn.offset.weight.abs().max()) == 0.0
    bn = m.trunk.stage2_unit1.bn1
    assert bool((bn.weight == 1).all()) and bool((bn.running_var == 1).all())
    a = init_detector(tiny_torch_detector(), seed=1,
                      offset_std=1e-3).requires_grad_(False)
    assert abs(float(a.rcnn.offset.weight.std()) / 1e-3 - 1) < 0.05
    assert torch.equal(a.trunk.stage3_unit1.conv1.weight, w)


@pytest.mark.parametrize("trunk_type", ["resnet", "resnext"])
def test_a_built_detector_holds_no_uninitialized_weight(trunk_type):
    """Every parameter of a freshly built detector is initialized, as
    nn.Conv2d's are: the deformable 3x3s' conv2_weight too, which once held
    whatever memory torch.empty returned until init_detector or an import
    filled it, so a run that trained without either depended on the
    process's history."""
    weights = []
    for _ in range(2):
        torch.manual_seed(3)
        model = tiny_torch_detector(trunk_type=trunk_type)
        w = model.trunk.stage4_unit1.conv2_weight.detach().clone()
        bound = 1.0 / np.sqrt(w[0].numel())  # kaiming_uniform(a=sqrt(5))
        assert float(w.abs().max()) <= bound
        assert float(w.abs().max()) > 0.5 * bound
        weights.append(w)
    assert torch.equal(*weights)
