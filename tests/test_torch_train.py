"""The port's training pieces against the JAX package, on the CPU in fp32.

- TrainBatchNorm against flax nn.BatchNorm(use_running_average=False,
  momentum=0.95, epsilon=2e-5): outputs, input and parameter gradients,
  and the running statistics after two updates. Inputs have a nonzero mean
  so that E[x^2] - E[x]^2 and torch's own variance would differ. The
  statistics are reduced in another order: rtol 1e-5 (outputs and running
  statistics), gradients within 1e-5 * max|ref|.
- The losses, dense and sparse, against sniper_tpu.models.losses: the same
  fp32 expressions, rtol 1e-6.
- warmup_multistep exactly (both in fp32), the fixed-parameter mask by
  name against fixed_param_mask by path, and the SGD update order against
  the optax chain of make_optimizer, within 1e-6 relative.
- Checkpoints: save, resume into fresh objects, and continue identically.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sniper_tpu.config import default_config
from sniper_tpu.models import losses as jlosses
from sniper_tpu.train import optimizer as jopt
from sniper_tpu_torch.models import losses as tlosses
from sniper_tpu_torch.models.norm import TrainBatchNorm
from sniper_tpu_torch.train import optimizer as topt


def _rel(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-6))


def test_train_batch_norm_matches_flax(rng):
    B, H, W, C = 3, 5, 7, 6
    xs = [(rng.randn(B, H, W, C) * 1.5 + 0.7).astype(np.float32)
          for _ in range(2)]
    gy = rng.randn(B, H, W, C).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = (rng.randn(C) * 0.1).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.95,
                       epsilon=2e-5)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": v["batch_stats"]}

    tbn = TrainBatchNorm(C).train()
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(scale))
        tbn.bias.copy_(torch.from_numpy(bias))
    for x in xs:
        def f(params, x):
            y, upd = bn.apply({"params": params,
                               "batch_stats": v["batch_stats"]}, x,
                              mutable=["batch_stats"])
            return jnp.sum(y * gy), (y, upd)

        (_, (want, upd)), (gp, gx) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
        v = {"params": v["params"], "batch_stats": upd["batch_stats"]}

        tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
        tbn.zero_grad()
        y = tbn(tx)
        (y * torch.from_numpy(gy).permute(0, 3, 1, 2)).sum().backward()
        np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)
        _rel(tx.grad.permute(0, 2, 3, 1), gx)
        _rel(tbn.weight.grad, gp["scale"])
        _rel(tbn.bias.grad, gp["bias"])
        np.testing.assert_allclose(tbn.running_mean.numpy(),
                                   v["batch_stats"]["mean"], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(tbn.running_var.numpy(),
                                   v["batch_stats"]["var"], rtol=1e-5)
    # outside training mode it normalizes with the running statistics
    tbn.eval()
    with torch.no_grad():
        y = tbn(torch.from_numpy(xs[0]).permute(0, 3, 1, 2))
    want = fnn.BatchNorm(use_running_average=True, epsilon=2e-5).apply(
        v, jnp.asarray(xs[0]))
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def _loss_inputs(rng, B=2, H=4, W=5, A=3, R=12, C=6, S=20, F=7):
    out = {
        "rpn_cls_logits": rng.randn(B, H, W, 2, A).astype(np.float32),
        "rpn_bbox_pred": rng.randn(B, 4 * A, H, W).astype(np.float32),
        "cls_score": rng.randn(B, R, C).astype(np.float32),
        "bbox_pred": rng.randn(B, R, 4).astype(np.float32),
        "rcnn_labels": rng.randint(-1, C, (B, R)).astype(np.int32),
        "rcnn_bbox_targets": (rng.randn(B, R, 4) * 2).astype(np.float32),
    }
    out["rcnn_bbox_weights"] = np.repeat(
        (out["rcnn_labels"] > 0)[..., None], 4, -1).astype(np.float32)
    n = A * H * W
    pids = np.stack([rng.permutation(n)[:S] for _ in range(B)])
    pids[:, -3:] = -1  # padding
    fg = np.stack([rng.permutation(n)[:F] for _ in range(B)])
    fg[:, -2:] = -1
    sparse = {"rpn_pids": pids.astype(np.int32),
              "rpn_label_vals": rng.choice([-1.0, 0.0, 1.0], (B, S))
              .astype(np.float32),
              "fg_pids": fg.astype(np.int32),
              "fg_targets": (rng.randn(B, F, 4) * 2).astype(np.float32)}
    dense = {"label": rng.choice([-1.0, 0.0, 1.0], (B, n)).astype(np.float32),
             "bbox_target": rng.randn(B, 4 * A, H, W).astype(np.float32),
             "bbox_weight": (rng.rand(B, 4 * A, H, W) > 0.7)
             .astype(np.float32)}
    return out, sparse, dense


@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_losses_match_jax(rng, form):
    out, sparse, dense = _loss_inputs(rng)
    batch = sparse if form == "sparse" else dense
    _, jm = jlosses.total_loss({k: jnp.asarray(v) for k, v in out.items()},
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               batch_images=2, rpn_batch_size=256)
    _, tm = tlosses.total_loss(
        {k: torch.from_numpy(v) for k, v in out.items()},
        {k: torch.from_numpy(v) for k, v in batch.items()},
        batch_images=2, rpn_batch_size=256)
    assert tm.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(
        float(tlosses.smooth_l1(torch.tensor([-2.0, -0.5, 0.0, 0.5, 3.0]))
              .sum()),
        float(jlosses.smooth_l1(jnp.asarray([-2.0, -0.5, 0.0, 0.5, 3.0]))
              .sum()))


def test_schedule_and_step_iters_match_jax():
    for args in ((0.015, 0.0005, 1000, [5330], 0.1),
                 (0.01, 0.001, 10, [20, 40], 0.5), (0.02, 0.02, 0, [], 0.1)):
        a, b = jopt.warmup_multistep(*args), topt.warmup_multistep(*args)
        for c in (0, 1, 7, 9, 10, 11, 19, 20, 39, 40, 41, 999, 1000, 6000):
            assert b(c) == float(a(c)), (args, c)
    assert topt.lr_step_iters("5.33", 1000) == jopt.lr_step_iters("5.33", 1000)
    assert topt.lr_step_iters("4,6", 77) == jopt.lr_step_iters("4,6", 77)
    assert topt.lr_step_iters("", 9) == []


def test_fixed_params_match_the_jax_mask():
    from torch_port import tiny_jax_detector, tiny_torch_detector

    _, variables = tiny_jax_detector(0)
    fixed = ["conv0", "bn0", "stage1", "bn_data"]
    mask = jopt.fixed_param_mask(variables["params"], fixed)
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(mask):
        keys = [p.key for p in path]
        want[".".join(keys[:-1])] = leaf
    model = tiny_torch_detector()
    got = {}
    for name, _ in model.named_parameters():
        got[name.rsplit(".", 1)[0]] = not topt.is_fixed(name, fixed)
    assert got == want
    assert not all(got.values()) and any(got.values())


def test_sgd_matches_the_optax_chain(rng):
    """Three steps of make_optimizer on two parameters, one frozen: the
    update order (weight decay, momentum trace, lr at the count before the
    step) and the frozen mask."""
    import optax

    cfg = default_config()
    cfg.TRAIN.lr, cfg.TRAIN.warmup, cfg.TRAIN.warmup_lr = 0.02, True, 0.002
    cfg.TRAIN.warmup_step, cfg.TRAIN.lr_step, cfg.TRAIN.wd = 2, "0.5", 0.01
    cfg.network.FIXED_PARAMS = ["stage1"]
    w0 = {"trunk": {"stage1_unit1": {"w": rng.randn(4).astype(np.float32)},
                    "stage2_unit1": {"w": rng.randn(4).astype(np.float32)}}}
    grads = [{k: {u: {"w": rng.randn(4).astype(np.float32)}
                  for u in v} for k, v in w0.items()} for _ in range(3)]
    tx, _ = jopt.make_optimizer(cfg, epoch_size=4, params=w0)
    jp = jax.tree.map(jnp.asarray, w0)
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)

    model = torch.nn.Module()
    model.trunk = torch.nn.Module()
    for u in ("stage1_unit1", "stage2_unit1"):
        m = torch.nn.Module()
        m.w = torch.nn.Parameter(torch.from_numpy(w0["trunk"][u]["w"].copy()))
        model.trunk.add_module(u, m)
    opt, sched, _ = topt.make_optimizer(cfg, 4, model)
    for g in grads:
        for u in ("stage1_unit1", "stage2_unit1"):
            p = getattr(model.trunk, u).w
            p.grad = (torch.from_numpy(g["trunk"][u]["w"])
                      if p.requires_grad else None)
        opt.step()
        sched.step()
    for u in ("stage1_unit1", "stage2_unit1"):
        np.testing.assert_allclose(getattr(model.trunk, u).w.detach(),
                                   np.asarray(jp["trunk"][u]["w"]),
                                   rtol=1e-6, atol=1e-7)
    assert torch.equal(model.trunk.stage1_unit1.w,
                       torch.from_numpy(w0["trunk"]["stage1_unit1"]["w"]))


def test_checkpoint_resume_continues_identically(tmp_path, rng):
    from sniper_tpu_torch.train import checkpoint

    cfg = default_config()
    cfg.network.FIXED_PARAMS = []

    def build():
        torch.manual_seed(0)
        m = torch.nn.Linear(3, 2)
        opt, sched, _ = topt.make_optimizer(cfg, 10, m)
        return m, opt, sched

    x = torch.from_numpy(rng.randn(5, 3).astype(np.float32))

    def step(m, opt, sched):
        opt.zero_grad()
        m(x).square().sum().backward()
        opt.step()
        sched.step()

    m, opt, sched = build()
    for _ in range(3):
        step(m, opt, sched)
    path = checkpoint.save_checkpoint(str(tmp_path), 1, m, opt, sched, step=3)
    assert path.endswith("epoch_0001.pt")
    assert checkpoint.latest_epoch(str(tmp_path)) == 1
    m2, opt2, sched2 = build()
    assert checkpoint.load_checkpoint(str(tmp_path), m2, opt2, sched2) == 3
    step(m, opt, sched)
    step(m2, opt2, sched2)
    assert torch.equal(m.weight, m2.weight) and torch.equal(m.bias, m2.bias)
    with pytest.raises(FileNotFoundError):
        checkpoint.load_checkpoint(str(tmp_path / "none"), m2)
