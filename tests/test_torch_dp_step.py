"""The data-parallel training step on 2 gloo ranks on the CPU, in fp32.

The detector is __graft_entry__.py:62-73's tiny one (tests/torch_dp.py:
GRAFT_TINY, full width, 81 classes, 21 anchors), from the port's seeded
init with its offsets at normal(1e-3); the batch is torch_dp.make_batch's
4 chips, 2 per rank, whose halves differ in their valid label counts (60
against 16 sampled anchors per chip, 3 + 3 against 2 + 1 GT boxes). Each
rank takes its rows of the sampler's priorities. Two checks:

- (c) one step of each network.BN_MODE against the JAX package's
  make_train_step on a 2-device CPU mesh (tests/fixtures/
  torch_dp_golden.json, scripts/gen_torch_dp_golden.py), the JAX
  sampler's draws injected: the global metrics (reduce_metrics), the
  parameters after the SGD step and the BatchNorm running statistics. The
  bounds are tests/test_torch_train_step.py's for a whole step: losses
  rtol 1e-3, rcnn_acc and rcnn_fg_frac atol 0.04, the telemetry maxima
  rtol 2e-2, each parameter's move within 2e-2 of its norm (relative L2),
  the running statistics rtol 1e-4; frozen leaves unmoved.
- (d) two steps of "sync" against the one-process step on the joined
  batch, same bounds: a rank that normalized its CE terms by its own valid
  count, or by its own batch, would be off by far more. After the steps
  the two ranks' parameters and statistics are identical, bit for bit.

Every trainable parameter gets a gradient at every step of box, RPN-only,
mask and AutoFocus training, which is what lets parallel/mesh.py's DDP
skip its unused-parameter search.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_dp
from test_torch_train_step import _torch_name, gg  # gg: scripts/ on the path

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "torch_dp_golden.json")


def _golden():
    with open(FIXTURE) as f:
        return json.load(f)


def _priorities(golden, mode):
    fg, bg = (np.asarray(p, np.float32) for p in golden[mode]["priorities"])
    return fg, bg


def _second_priorities():
    rng = np.random.RandomState(12)
    shape = (torch_dp.B_GLOBAL, torch_dp.N_CAND)
    return (rng.uniform(size=shape).astype(np.float32),
            rng.uniform(size=shape).astype(np.float32))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_step")
    golden = _golden()
    runs = [("golden_sync", "sync", [_priorities(golden, "sync")]),
            ("golden_local", "local", [_priorities(golden, "local")]),
            ("joined", "sync", [_priorities(golden, "sync"),
                                _second_priorities()])]
    torch_dp.launch(torch_dp.train_rank, 2, tmp, 2, runs, str(tmp))
    return {name: [torch.load(os.path.join(tmp, f"{name}_rank{r}.pt"))
                   for r in range(2)]
            for name, _, _ in runs}


def _check_metrics(got, want, tag):
    for k, v in want.items():
        if k.startswith(("rcnn_acc", "rcnn_fg")):
            tol = dict(rtol=0, atol=0.04)
        elif k.endswith("_max"):
            tol = dict(rtol=2e-2, atol=1e-9)
        else:
            tol = dict(rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(got[k], v, err_msg=f"{tag} {k}", **tol)


def _check_leaf(key, got, want, p0):
    if key.startswith("batch_stats"):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                   err_msg=key)
        return
    if "stage1" in key:  # FIXED_PARAMS
        np.testing.assert_array_equal(got, p0, err_msg=key)
        return
    move = want - p0
    assert np.abs(move).max() > 0, key
    err = np.linalg.norm((got - p0) - move) / np.linalg.norm(move)
    assert err <= 2e-2, (key, err)


@pytest.mark.parametrize("mode", ["sync", "local"])
def test_two_ranks_match_the_jax_two_device_step(ranks, mode):
    want = _golden()[mode]
    init = torch_dp.tiny_detector().state_dict()
    for r in ranks[f"golden_{mode}"]:
        _check_metrics(r["metrics"][0], want["metrics"], f"{mode} rank")
        for key, value in want["leaves"].items():
            name = _torch_name(key)
            _check_leaf(key, r["state"][name].numpy(),
                        np.asarray(value, np.float32), init[name].numpy())


def test_two_ranks_match_one_process_on_the_joined_batch(ranks):
    golden = _golden()
    metrics, state = torch_dp.train_steps(
        "sync", [_priorities(golden, "sync"), _second_priorities()])
    init = torch_dp.tiny_detector().state_dict()
    r0 = ranks["joined"][0]
    for i, (got, want) in enumerate(zip(r0["metrics"], metrics)):
        _check_metrics(got, want, f"step {i}")
    for key in golden["sync"]["leaves"]:
        name = _torch_name(key)
        _check_leaf(key, r0["state"][name].numpy(), state[name].numpy(),
                    init[name].numpy())


def test_ranks_end_identical(ranks):
    r0, r1 = ranks["joined"]
    assert r0["metrics"] == r1["metrics"]
    assert r0["state"].keys() == r1["state"].keys()
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k


def test_the_modes_give_different_steps(ranks):
    """"local" normalizes each rank's chips by their own statistics, so
    its step is not "sync"'s."""
    sync = ranks["golden_sync"][0]["state"]
    local = ranks["golden_local"][0]["state"]
    key = _torch_name("params/trunk/stage2_unit1/bn1/scale")
    assert not torch.allclose(sync[key], local[key], rtol=0, atol=1e-7)


@pytest.mark.parametrize("kind", ["box", "rpn_only", "mask", "autofocus"])
def test_every_trainable_parameter_gets_a_gradient(kind):
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.train.optimizer import make_optimizer
    from sniper_tpu_torch.train.trainer import make_train_step
    from torch_port import tiny_torch_detector

    mask, autofocus = kind == "mask", kind == "autofocus"
    model = init_detector(tiny_torch_detector(
        rpn_only=kind == "rpn_only", **gg.model_kwargs(mask, autofocus)),
        seed=1)
    opt, sched, _ = make_optimizer(gg.make_cfg(), 100, model)
    step = make_train_step(model, opt, sched, gg.B,
                           pixel_means=(0.0, 0.0, 0.0),
                           rpn_only=kind == "rpn_only")
    step({k: torch.from_numpy(v)
          for k, v in gg.make_batch(mask, autofocus).items()})
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    assert len(trainable) > 10
    missing = [n for n, p in model.named_parameters()
               if p.requires_grad and p.grad is None]
    assert not missing, missing
