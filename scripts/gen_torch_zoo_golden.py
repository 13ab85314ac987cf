"""Generate the fixture that holds the port's model-zoo detectors against the
JAX package's: ResNeXt-101 and MobileNetV2.

For each of the two tiny detectors of tests/torch_port.py's ZOO (TINY with
the X101 trunk at full width and 64 groups, units (1,1,1,1); with the
MobileNetV2 trunk at full width, stride 32, head_fc_dim 512), on the CPU:

- the inference forward of sniper_tpu.models.detector.SNIPERDetector on
  ``zoo_variables`` (the port's seeded init written into the flax tree)
  perturbed as tests/test_torch_detector.py does (BatchNorms, offset convs,
  biases), over seeded unit-noise images (64x96 for X101, 128x160 for
  MobileNetV2: a 4x5 map at stride 32): rois, roi_scores, roi_valid,
  cls_prob and bbox_pred;
- STEPS[kind] steps of sniper_tpu.train.trainer.make_train_step on a
  one-device CPU mesh, with scripts/gen_torch_train_golden.py's recipe
  (SGD, warm-up, weight decay), the trunk's FIXED_PARAMS ([conv0, bn0,
  stage1] for X101, the yml's [first_conv] for MobileNetV2) and batch (its
  chips at 128x128 for MobileNetV2, so that both maps are 4x4 and the RPN
  targets index the same 144 anchors); the sampler takes every live
  candidate, so neither framework's draws decide the result. The fixture
  keeps the per-step metrics, a few parameter leaves and running
  statistics. X101 takes three steps from its init (every offset at zero,
  so step 1 runs on the kinks). MobileNetV2 takes one, from its init
  perturbed as the forward's: its 52 BatchNorms in training mode make the
  fp32 trunk ill-conditioned, so that the two frameworks' C5 maps already
  differ by 7e-5 (relative L2; flax's lies 6.7e-5 from an fp64 evaluation
  of the port's trunk, the port's 2.7e-5) and their trunk gradients by up
  to 5e-3, and every update compounds it: rpn_cls_loss 9e-5 apart at step
  1 and 1.7e-3 at step 2 (rpn_bbox_loss 5.6%), past the steps' rtol 1e-3.

tests/test_torch_zoo_detector.py runs the port on the same variables and
inputs and compares. The JAX side takes about 3 min here (its train-step
compiles at X101's width), which is why its outputs are frozen.
Regenerate (only after an intentional change of the semantics):
    python scripts/gen_torch_zoo_golden.py
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import gen_torch_train_golden as gg  # noqa: E402  (sets up jax on the CPU)

import jax  # noqa: E402

FIXTURE = os.path.join(gg.ROOT, "tests", "fixtures",
                       "torch_zoo_golden.json")
KINDS = ("resnext", "mobilenetv2")
FWD_HW = {"resnext": (64, 96), "mobilenetv2": (128, 160)}
TRAIN_HW = {"resnext": (gg.H, gg.W), "mobilenetv2": (2 * gg.H, 2 * gg.W)}
STEPS = {"resnext": gg.N_STEPS, "mobilenetv2": 1}
FIXED = {"resnext": ["conv0", "bn0", "stage1"],
         "mobilenetv2": ["first_conv"]}
FWD_KEYS = ("rois", "roi_scores", "roi_valid", "cls_prob", "bbox_pred")
HEAD_LEAVES = (
    ("params", "rcnn/bbox_pred/bias"),
    ("params", "rcnn/cls_score/bias"),
    ("params", "rcnn/offset/bias"),
    ("params", "rpn/rpn_cls_score/bias"),
    ("params", "conv_new_1/bias"),
)
LEAVES = {
    "resnext": HEAD_LEAVES + (
        ("params", "trunk/stage4_unit1/offset/bias"),
        ("params", "trunk/stage4_unit1/bn2/bias"),
        ("params", "trunk/stage2_unit1/bn2/scale"),
        ("params", "trunk/stage3_unit1/sc_bn/bias"),
        ("params", "trunk/stage1_unit1/bn1/scale"),  # frozen
        ("batch_stats", "trunk/stage2_unit1/bn1/mean"),
        ("batch_stats", "trunk/stage3_unit1/sc_bn/var"),
        ("batch_stats", "trunk/stage4_unit1/bn2/var"),
        ("batch_stats", "trunk/stage1_unit1/bn2/mean"),  # frozen
    ),
    "mobilenetv2": HEAD_LEAVES + (
        ("params", "trunk/seq3_block1/depthwise/batchnorm/bias"),
        ("params", "trunk/seq3_block1/depthwise/conv2d/kernel"),
        ("params", "trunk/seq6_block0/linear/batchnorm/scale"),
        ("params", "trunk/last_conv/batchnorm/scale"),
        ("params", "trunk/first_conv/batchnorm/scale"),  # frozen
        # FIXED_PARAMS freezes first_conv's parameters, not its statistics
        ("batch_stats", "trunk/first_conv/batchnorm/mean"),
        ("batch_stats", "trunk/seq5_block2/linear/batchnorm/var"),
        ("batch_stats", "trunk/last_conv/batchnorm/mean"),
    ),
}


def metric_names(kind):
    # MobileNetV2 has no deformable unit, hence no trunk DCN telemetry
    return tuple(m for m in gg.METRICS
                 if kind == "resnext" or m != "dcn_offset_max")


def forward_inputs(kind):
    h, w = FWD_HW[kind]
    rng = np.random.RandomState(31)
    data = rng.randn(2, h, w, 3).astype(np.float32)
    im_info = np.array([[h, w, 1.0], [h - 8, w - 20, 1.0]], np.float32)
    return data, im_info


def forward_variables(kind):
    from test_torch_detector import _perturb
    from torch_port import zoo_variables

    return zoo_variables(kind, seed=3, perturb=lambda v: _perturb(
        v, np.random.RandomState(7)))


def model_kwargs(kind):
    from torch_port import ZOO

    return dict(gg.model_kwargs(), **ZOO[kind])


def train_variables(kind):
    from test_torch_detector import _perturb
    from torch_port import zoo_variables

    perturb = None
    if kind == "mobilenetv2":
        perturb = lambda v: _perturb(v, np.random.RandomState(8))  # noqa: E731
    return zoo_variables(kind, seed=2, perturb=perturb, **gg.model_kwargs())


def make_cfg(kind):
    cfg = gg.make_cfg()
    cfg.network.FIXED_PARAMS = list(FIXED[kind])
    return cfg


def make_batch(kind):
    """gg.make_batch with the trunk's chips: the same GT boxes, RPN targets
    (144 anchors at 4x4 either way) and valid ranges."""
    batch = gg.make_batch()
    h, w = TRAIN_HW[kind]
    if (h, w) != (gg.H, gg.W):
        rng = np.random.RandomState(22)
        batch["data"] = rng.randn(gg.B, h, w, 3).astype(np.float32)
        batch["im_info"] = np.array([[h, w, 1.0], [h - 8, w - 4, 1.0]],
                                    np.float32)
    return batch


def run_forward(kind):
    from torch_port import zoo_jax_detector

    model = zoo_jax_detector(kind)
    data, im_info = forward_inputs(kind)
    out = jax.jit(lambda v, d, i: model.apply(v, d, i, train=False))(
        forward_variables(kind), data, im_info)
    return {k: np.asarray(out[k]).tolist() for k in FWD_KEYS}


def run_train(kind):
    import jax.numpy as jnp

    from sniper_tpu.parallel.mesh import make_mesh, shard_batch
    from sniper_tpu.train.optimizer import make_optimizer
    from sniper_tpu.train.trainer import TrainState, make_train_step
    from torch_port import zoo_jax_detector

    model = zoo_jax_detector(kind, pool_kernel="fused", **gg.model_kwargs())
    variables = train_variables(kind)
    tx, _ = make_optimizer(make_cfg(kind), epoch_size=100,
                           params=variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=jax.tree.map(jnp.asarray, variables["params"]),
                       batch_stats=jax.tree.map(jnp.asarray,
                                                variables["batch_stats"]),
                       opt_state=tx.init(variables["params"]))
    mesh = make_mesh(1)
    step = make_train_step(model, tx, mesh, gg.B,
                           pixel_means=(0.0, 0.0, 0.0))
    batch = shard_batch(mesh, make_batch(kind))
    metrics = []
    for i in range(STEPS[kind]):
        state, m = step(state, batch, jax.random.PRNGKey(i))
        metrics.append({k: float(m[k]) for k in metric_names(kind)})
    final = {"params": state.params, "batch_stats": state.batch_stats}
    return metrics, {f"{c}/{p}": gg.leaf(final[c], p).tolist()
                     for c, p in LEAVES[kind]}


def main():
    out = {}
    for kind in KINDS:
        fwd = run_forward(kind)
        metrics, leaves = run_train(kind)
        out[kind] = {"forward": fwd, "steps": STEPS[kind],
                     "metrics": metrics, "leaves": leaves}
        print(kind, "valid rois", np.sum(fwd["roi_valid"], axis=1))
        for i, m in enumerate(metrics):
            print(kind, i, m)
    with open(FIXTURE, "w") as f:
        json.dump(out, f)
        f.write("\n")
    print(f"wrote {FIXTURE}")


if __name__ == "__main__":
    main()
