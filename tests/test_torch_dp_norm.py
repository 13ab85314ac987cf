"""The training-mode BatchNorm across ranks (models/norm.py), on 2 gloo ranks
on the CPU, in fp32.

- "sync": each rank normalizes its rows with the statistics of the joined
  batch, as the one-process TrainBatchNorm does on all of it: the output,
  the input gradient of sum(y * g) (the other rank's terms reach it through
  the all-reduce's backward), the parameter gradients summed over the
  ranks (what DDP's all-reduce gives) and the running statistics, for an
  even split (2 + 2 rows) and an uneven one (3 + 1, the counts in the
  all-reduce). The all-reduced E[x^2] - E[x]^2 and the one-process
  Welford sums round differently: atol 2e-5 on outputs of unit scale,
  rtol 1e-5 on gradients and statistics.
- "local": the flax LocalBatchNorm(groups=2) of the JAX package
  (sniper_tpu/models/norm.py) on the same input, one group per rank:
  output, input and parameter gradients (jax.grad) and the running
  statistics, which take the groups' mean of their moments. Same bounds.
- In a group of one rank both modes are the single-process module bit for
  bit; the detector sets its trainable BatchNorms' mode and refuses a
  bogus one.

The ranks run once for the module (a few seconds of spawning).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dp
from sniper_tpu_torch.models.norm import TrainBatchNorm

C = 6
N = 4


def _input(seed):
    rng = np.random.RandomState(seed)
    # a per-channel offset: E[x^2] - E[x]^2 cancels some digits
    x = (rng.randn(N, C, 5, 7) * 2 + rng.uniform(-3, 3, (1, C, 1, 1)))
    g = rng.randn(N, C, 5, 7)
    return x.astype(np.float32), g.astype(np.float32)


CASES = {
    "sync_even": ("sync", (2, 2)),
    "sync_uneven": ("sync", (3, 1)),
    "local_even": ("local", (2, 2)),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_norm")
    cases = [(name, mode, *_input(i), split)
             for i, (name, (mode, split)) in enumerate(CASES.items())]
    torch_dp.launch(torch_dp.batchnorm_rank, 2, tmp, 2, cases, str(tmp))
    return {name: [torch.load(os.path.join(tmp, f"{name}_rank{r}.pt"))
                   for r in range(2)]
            for name in CASES}


def _one_process(x, g):
    bn = torch_dp.batchnorm(C)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt)
    (y * torch.from_numpy(g)).sum().backward()
    return {"y": y.detach(), "dx": xt.grad,
            "grads": torch.cat([bn.weight.grad, bn.bias.grad]),
            "mean": bn.running_mean, "var": bn.running_var}


def _check(ranks, want):
    got_y = torch.cat([r["y"] for r in ranks]).numpy()
    got_dx = torch.cat([r["dx"] for r in ranks]).numpy()
    np.testing.assert_allclose(got_y, np.asarray(want["y"]), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got_dx, np.asarray(want["dx"]), rtol=1e-5,
                               atol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["grads"].numpy(),
                                   np.asarray(want["grads"]), rtol=1e-5,
                                   atol=1e-5)
        for k in ("mean", "var"):
            np.testing.assert_allclose(r[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["sync_even", "sync_uneven"])
def test_sync_equals_one_process_on_the_joined_batch(ranks, name):
    x, g = _input(list(CASES).index(name))
    _check(ranks[name], _one_process(x, g))


def test_local_equals_jax_local_batchnorm(ranks):
    from sniper_tpu.models.norm import LocalBatchNorm

    x, g = _input(list(CASES).index("local_even"))
    ref = torch_dp.batchnorm(C)
    params = {"scale": ref.weight.detach().numpy(),
              "bias": ref.bias.detach().numpy()}
    stats = {"mean": np.zeros(C, np.float32), "var": np.ones(C, np.float32)}
    mod = LocalBatchNorm(use_running_average=False, momentum=0.95,
                         epsilon=2e-5, groups=2)
    xh, gh = x.transpose(0, 2, 3, 1), g.transpose(0, 2, 3, 1)

    def f(p, xx):
        y, upd = mod.apply({"params": p, "batch_stats": stats}, xx,
                           mutable=["batch_stats"])
        return (y * gh).sum(), (y, upd["batch_stats"])

    (dp, dx), (y, new) = jax.grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(xh))
    nchw = (0, 3, 1, 2)
    _check(ranks["local_even"], {
        "y": np.asarray(y).transpose(nchw),
        "dx": np.asarray(dx).transpose(nchw),
        "grads": np.concatenate([dp["scale"], dp["bias"]]),
        "mean": new["mean"], "var": new["var"]})


def test_local_differs_from_sync(ranks):
    """The two modes are not the same computation: each rank's own
    statistics move its output away from the joined batch's."""
    x, g = _input(list(CASES).index("local_even"))
    sync = _one_process(x, g)
    got = torch.cat([r["y"] for r in ranks["local_even"]])
    assert float((got - sync["y"]).abs().max()) > 1e-2


@pytest.mark.parametrize("mode", ["sync", "local"])
def test_a_group_of_one_is_the_single_process_module(tmp_path, mode):
    x, g = _input(7)
    want = _one_process(x, g)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        bn = torch_dp.batchnorm(C, mode)
        xt = torch.from_numpy(x).requires_grad_(True)
        y = bn(xt)
        (y * torch.from_numpy(g)).sum().backward()
    finally:
        dist.destroy_process_group()
    assert torch.equal(y.detach(), want["y"])
    assert torch.equal(xt.grad, want["dx"])
    assert torch.equal(torch.cat([bn.weight.grad, bn.bias.grad]),
                       want["grads"])
    assert torch.equal(bn.running_mean, want["mean"])
    assert torch.equal(bn.running_var, want["var"])


def test_bogus_mode_is_refused():
    from torch_port import tiny_torch_detector

    with pytest.raises(ValueError, match="sync|local"):
        tiny_torch_detector(bn_mode="global")
    model = tiny_torch_detector(bn_mode="local")
    modes = {m.mode for m in model.modules()
             if isinstance(m, TrainBatchNorm)}
    assert modes == {"local"}
