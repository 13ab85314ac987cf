"""Generate the fixture that holds the port's data-parallel training step
against the JAX package's.

One step of sniper_tpu.train.trainer.make_train_step on a 2-device CPU mesh
(the 1-D 'data' mesh of sniper_tpu/parallel/mesh.py, the global batch of 4
chips sharded 2 + 2), for network.BN_MODE "sync" (flax BatchNorm over the
global batch) and "local" (LocalBatchNorm with one group per device), with
the tiny detector of __graft_entry__.py:62-73 (full width, units (1,1,1,1),
81 classes, 21 anchors, fp32, the einsum pool: a pallas_call has no
sharding rule). Its variables are the port's seeded init
(tests/torch_dp.py:tiny_detector, offsets at normal(1e-3) so that no
sample starts on a kink, where the einsum pool's autodiff and the port's
backward take different subgradients) written into the flax tree, its
batch tests/torch_dp.py:make_batch (the two devices' halves with
different valid label counts) and its optimizer that file's recipe.

The sampler's draws decide which rois train, so the fixture keeps them:
the key that the step's ``make_rng("sampling")`` derives (read from an
op-by-op apply of the same model, variables and key), turned into each
global image's fg and bg priorities as sniper_tpu/ops/proposals.py:269
splits them; tests/test_torch_dp_step.py feeds each rank its rows. The
fixture also keeps the step's metrics, a few parameter leaves after the
step and some BatchNorm running statistics.

The two DP steps take about a minute on the CPU with their compiles, which
is why the outputs are frozen. Regenerate (only after an intended change
of the semantics):
    python scripts/gen_torch_dp_golden.py
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import gen_torch_train_golden as gg  # noqa: E402  (sets up jax on the CPU)

import jax  # noqa: E402

FIXTURE = os.path.join(gg.ROOT, "tests", "fixtures", "torch_dp_golden.json")
MODES = ("sync", "local")
SAMPLING_KEY = 11
METRICS = gg.METRICS
LEAVES = (
    ("params", "rcnn/bbox_pred/bias"),
    ("params", "rcnn/cls_score/bias"),
    ("params", "rcnn/offset/bias"),
    ("params", "rpn/rpn_cls_score/bias"),
    ("params", "rpn/rpn_bbox_pred/bias"),
    ("params", "conv_new_1/bias"),
    ("params", "trunk/stage4_unit1/offset/bias"),
    ("params", "trunk/stage2_unit1/bn1/scale"),
    ("params", "trunk/stage3_unit1/bn3/bias"),
    ("params", "trunk/stage4_unit1/bn2/scale"),
    ("params", "trunk/stage1_unit1/bn1/scale"),  # frozen
    ("batch_stats", "trunk/stage2_unit1/bn1/mean"),
    ("batch_stats", "trunk/stage2_unit1/bn1/var"),
    ("batch_stats", "trunk/stage3_unit1/bn2/mean"),
    ("batch_stats", "trunk/stage4_unit1/bn2/var"),
    ("batch_stats", "trunk/stage1_unit1/bn2/mean"),  # frozen
)


def jax_model(mode):
    import jax.numpy as jnp

    from __graft_entry__ import _flagship

    kw = dict(bn_mode="local", bn_groups=2) if mode == "local" else {}
    return _flagship(units=(1, 1, 1, 1), tiny=True, dtype=jnp.float32, **kw)


def initial_variables():
    import jax.numpy as jnp

    from torch_dp import H, W, tiny_detector
    from torch_port import flax_shapes, port_to_flax

    shapes = flax_shapes(jax_model("sync"), jnp.zeros((1, H, W, 3)),
                         jnp.asarray([[H, W, 1.0]]), train=False)
    return port_to_flax(shapes, tiny_detector())


def sampler_priorities(model, variables, batch, key):
    """The fg and bg priorities [B, N_CAND] of each global image that the
    sampler draws from the key the step derives from ``key``."""
    import sniper_tpu.models.detector as jdet
    from test_torch_sampler import _jax_priorities
    from torch_dp import N_CAND

    keys = []
    orig = jdet.multi_proposal_target

    def spy(*args, **kw):
        keys.append(args[6])
        return orig(*args, **kw)

    jdet.multi_proposal_target = spy
    try:
        model.apply(variables, *(batch[k] for k in (
            "data", "im_info", "gt_boxes", "valid_ranges")), train=True,
            rngs={"sampling": key}, mutable=["batch_stats", "intermediates"])
    finally:
        jdet.multi_proposal_target = orig
    assert len(keys) == 1
    fg, bg = _jax_priorities(keys[0], len(batch["data"]), N_CAND)
    return fg, bg


def run_mode(mode, variables):
    import jax.numpy as jnp

    from sniper_tpu.parallel.mesh import make_mesh, shard_batch
    from sniper_tpu.train.optimizer import make_optimizer
    from sniper_tpu.train.trainer import TrainState, make_train_step
    from torch_dp import B_GLOBAL, make_batch, make_cfg

    model = jax_model(mode)
    tx, _ = make_optimizer(make_cfg(), epoch_size=100,
                           params=variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=jax.tree.map(jnp.asarray, variables["params"]),
                       batch_stats=jax.tree.map(jnp.asarray,
                                                variables["batch_stats"]),
                       opt_state=tx.init(variables["params"]))
    mesh = make_mesh(2)
    step = make_train_step(model, tx, mesh, B_GLOBAL // 2,
                           pixel_means=(0.0, 0.0, 0.0))
    batch = make_batch()
    key = jax.random.PRNGKey(SAMPLING_KEY)
    fg, bg = sampler_priorities(model, variables, batch, key)
    state, m = step(state, shard_batch(mesh, batch), key)
    final = {"params": state.params, "batch_stats": state.batch_stats}
    return {"metrics": {k: float(m[k]) for k in METRICS},
            "leaves": {f"{c}/{p}": gg.leaf(final[c], p).tolist()
                       for c, p in LEAVES},
            "priorities": [fg.tolist(), bg.tolist()]}


def main():
    variables = initial_variables()
    out = {}
    for mode in MODES:
        out[mode] = run_mode(mode, variables)
        print(mode, out[mode]["metrics"])
    with open(FIXTURE, "w") as f:
        json.dump(out, f)
        f.write("\n")
    print(f"wrote {FIXTURE}")


if __name__ == "__main__":
    main()
