"""OHEM (TRAIN.ENABLE_OHEM) in the port against the JAX package, on the CPU.

- ``ohem_select`` against sniper_tpu/ops/ohem.py on the same seeded losses:
  identical labels and weights, for ties at the threshold (every tied roi
  kept, more than k), fewer valid rois than k (all kept), every roi
  invalid, and k above the roi count (both refuse it).
- ``total_loss(ohem_rois=k)`` against the JAX ``total_loss``: the losses
  and their gradients with respect to cls_score and bbox_pred within rtol
  1e-5 (the two frameworks' fp32 log-softmax and sums).
- Three training steps of the tiny detector with OHEM against
  tests/fixtures/torch_train_ohem_golden.json
  (``scripts/gen_torch_train_golden.py --ohem``, 8 of the 20 sampled rois
  per chip), under tests/test_torch_train_step.py's bounds for a whole
  step.
- The 2-rank gloo step with OHEM against the one-process step on the
  joined batch (tests/torch_dp.py): the selection is per image, and the
  valid count is the global count of the kept rois, so the ranks' shares
  add up to the joined batch's loss; test_torch_dp_step.py's bounds.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp
from sniper_tpu.models import losses as jlosses
from sniper_tpu.ops.ohem import ohem_select as johem_select
from sniper_tpu_torch.models import losses as tlosses
from sniper_tpu_torch.ops.ohem import ohem_select
from test_torch_dp_step import _check_leaf, _check_metrics
from test_torch_train_step import _torch_name, check_three_steps


def _losses(rng, case):
    """(cls_loss, bbox_loss, labels, bbox_weights, k) of a case."""
    B, R = 3, 12
    cls = rng.uniform(0, 3, (B, R)).astype(np.float32)
    box = rng.uniform(0, 1, (B, R)).astype(np.float32)
    labels = rng.randint(-1, 4, (B, R)).astype(np.int32)
    weights = (rng.rand(B, R, 4) > 0.3).astype(np.float32)
    k = 4
    if case == "ties":
        # chip 0: five valid rois share the 4th largest total; chip 1: all
        # its valid rois tie
        labels[:2] = np.maximum(labels[:2], 0)
        cls[0], box[0] = np.linspace(4, 1, R), 0.0
        cls[0, 3:8], box[0, 3:8] = 2.0, 0.5
        cls[1], box[1] = 1.25, 0.25
    elif case == "few_valid":
        labels[0] = np.r_[1, 0, [-1] * (R - 2)]  # 2 valid rois < k
        labels[1, :] = np.r_[0, 1, 2, [-1] * (R - 3)]
    elif case == "all_invalid":
        labels[:] = -1
    elif case == "k_above_rois":
        k = R + 1
    return cls, box, labels, weights, k


@pytest.mark.parametrize("case", ["random", "ties", "few_valid",
                                  "all_invalid", "k_above_rois"])
def test_ohem_select_matches_jax(rng, case):
    cls, box, labels, weights, k = _losses(rng, case)
    if case == "k_above_rois":
        with pytest.raises(ValueError, match="BATCH_ROIS_OHEM"):
            ohem_select(*map(torch.from_numpy, (cls, box, labels, weights)),
                        k)
        with pytest.raises(Exception):  # lax.top_k refuses k > R
            johem_select(*map(jnp.asarray, (cls, box, labels, weights)), k)
        return
    want_l, want_w = johem_select(*map(jnp.asarray,
                                       (cls, box, labels, weights)), k)
    got_l, got_w = ohem_select(*map(torch.from_numpy,
                                    (cls, box, labels, weights)), k)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    kept = (got_l.numpy() >= 0).sum(1)
    valid = (labels >= 0).sum(1)
    if case == "ties":
        assert kept[0] == 8 and kept[1] == valid[1] > k  # the ties survive
    if case == "few_valid":
        assert kept[0] == 2 and kept[1] == 3
    if case == "all_invalid":
        assert kept.sum() == 0
        np.testing.assert_array_equal(got_w.numpy(), weights)


@pytest.mark.parametrize("k", [3, 6])
def test_total_loss_with_ohem_matches_jax(rng, k):
    """Losses and the gradients reaching cls_score and bbox_pred."""
    B, R, C, A, H, W = 2, 10, 5, 3, 4, 5
    out = {"rpn_cls_logits": rng.randn(B, H, W, 2, A),
           "rpn_bbox_pred": rng.randn(B, 4 * A, H, W),
           "cls_score": rng.randn(B, R, C) * 2,
           "rcnn_labels": rng.randint(-1, C, (B, R)),
           "bbox_pred": rng.randn(B, R, 4),
           "rcnn_bbox_targets": rng.randn(B, R, 4),
           "rcnn_bbox_weights": (rng.rand(B, R, 4) > 0.3) * 1.0}
    batch = {"rpn_pids": rng.randint(-1, A * H * W, (B, 16)),
             "rpn_label_vals": rng.choice([0.0, 1.0], (B, 16)),
             "fg_pids": rng.randint(-1, A * H * W, (B, 4)),
             "fg_targets": rng.randn(B, 4, 4)}

    def typed(d):
        return {k_: np.asarray(v, np.int32 if k_.endswith(("pids", "labels"))
                               else np.float32) for k_, v in d.items()}

    out, batch = typed(out), typed(batch)
    diff = ("cls_score", "bbox_pred")

    def jloss(cs, bp):
        o = {k_: jnp.asarray(v) for k_, v in out.items()}
        o.update(cls_score=cs, bbox_pred=bp)
        return jlosses.total_loss(o, {k_: jnp.asarray(v)
                                      for k_, v in batch.items()},
                                  B, 16, ohem_rois=k)

    (_, want), want_g = jax.value_and_grad(jloss, argnums=(0, 1),
                                           has_aux=True)(
        *(jnp.asarray(out[n]) for n in diff))
    t_out = {k_: torch.from_numpy(v) for k_, v in out.items()}
    for n in diff:
        t_out[n].requires_grad_(True)
    loss, got = tlosses.total_loss(
        t_out, {k_: torch.from_numpy(v) for k_, v in batch.items()}, B, 16,
        ohem_rois=k)
    loss.backward()
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(float(got[name].detach()),
                                   float(want[name]), rtol=1e-5,
                                   err_msg=name)
    for n, g in zip(diff, want_g):
        np.testing.assert_allclose(t_out[n].grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-7, err_msg=n)
    # the selection changed the R-CNN terms
    _, plain = tlosses.total_loss(
        {k_: torch.from_numpy(v) for k_, v in out.items()},
        {k_: torch.from_numpy(v) for k_, v in batch.items()}, B, 16)
    assert float(plain["rcnn_cls_loss"]) != float(
        got["rcnn_cls_loss"].detach())


def test_three_ohem_train_steps_match_jax():
    check_three_steps(mask=False, ohem=True)


OHEM_DP = 16  # of GRAFT_TINY's 32 sampled rois per chip


def _priorities():
    rng = np.random.RandomState(13)
    shape = (torch_dp.B_GLOBAL, torch_dp.N_CAND)
    return [(rng.uniform(size=shape).astype(np.float32),
             rng.uniform(size=shape).astype(np.float32)) for _ in range(2)]


def test_two_rank_ohem_step_matches_one_process(tmp_path):
    pri = _priorities()
    runs = [("ohem", "sync", pri, OHEM_DP)]
    torch_dp.launch(torch_dp.train_rank, 2, tmp_path, 2, runs,
                    str(tmp_path))
    ranks = [torch.load(os.path.join(tmp_path, f"ohem_rank{r}.pt"))
             for r in range(2)]
    metrics, state = torch_dp.train_steps("sync", pri, ohem_rois=OHEM_DP)
    init = torch_dp.tiny_detector().state_dict()
    for i, (got, want) in enumerate(zip(ranks[0]["metrics"], metrics)):
        _check_metrics(got, want, f"step {i}")
    for key in ("params/rcnn/cls_score/bias", "params/rcnn/bbox_pred/bias",
                "params/conv_new_1/bias", "params/rpn/rpn_cls_score/bias",
                "params/trunk/stage3_unit1/bn3/bias",
                "batch_stats/trunk/stage2_unit1/bn1/var"):
        name = _torch_name(key)
        _check_leaf(key, ranks[0]["state"][name].numpy(),
                    state[name].numpy(), init[name].numpy())
    for k in ranks[0]["state"]:
        assert torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]), k
