"""Generate the fixtures that hold the port's training step against the JAX
package's.

Three steps of sniper_tpu.train.trainer.make_train_step on a one-device CPU
mesh: the tiny detector of tests/torch_port.py (units 1,1,1,1, 64x64
chips, B=2, fp32, the fused pool with its hand-written backward in
interpret mode), its flax init (every C5 offset conv and the head's offset
FC at zero, so step 1 runs on the kinks), the recipe's SGD with warm-up and
FIXED_PARAMS. The sampler takes every live candidate (num_rois = post-NMS
count + GT rows, fg_fraction 1.0), so the draws of the two frameworks'
generators cannot decide the result. The fixture keeps the per-step
metrics, a few parameter leaves after the three steps and some BatchNorm
running statistics; tests/test_torch_train_step.py runs the port's step
from the same variables and batch and compares.

``--mask`` writes the second fixture: the same detector with the mask
branch (mask_size 28, every mask layer He-initialised so that its
gradients are not buried under five 0.01-scale layers, ``mask_offset`` at
zero: the 14x14 pool's window starts on the kinks at step 1), and the
batch also carries ``gt_masks`` rasterized from simple polygons
(``rasterize_gt_masks``); its metrics add ``mask_loss`` and its leaves the
mask layers'. tests/test_torch_mask_train.py compares against it. Its steps
run op by op (``jax.disable_jit``): a roi equal to its GT box samples the
112^2 grid at exact half cells, so a 2x2 block half inside the polygon
blends to 0.5 up to the last bit, right at the targets' >= 0.5 threshold,
and the fused jitted step rounds some such cells (21 at step 0 here) to the
other side than the JAX package's own op-by-op evaluation does, which the
port reproduces bit for bit.

``--autofocus`` writes the third fixture: the same detector with the
FocusPixel head (its flax init), and the batch also carries each chip's
FocusPixel labels (``scale_label``, painted from its GT boxes by the JAX
assigner's ``_focus_map`` with AUTOFOCUS_PARAMS, so that the labels hold
1, -1 and 0); its metrics add ``focus_loss`` and its leaves the head's
biases. tests/test_torch_autofocus.py compares against it.

``--mask --autofocus`` writes the fourth fixture: both branches at once, as
configs/sniper_res101_e2e_mask_autofocus.yml trains them (the mask
fixture's init and GT masks, the FocusPixel labels), all six losses among
its metrics and both branches' leaves; made op by op like ``--mask``.
tests/test_torch_mask_autofocus_train.py compares against it.

``--ohem`` writes the fifth: the first fixture's detector and batch trained
with OHEM (``ohem_rois`` OHEM_ROIS of the 16 + G sampled rois per image,
TRAIN.ENABLE_OHEM with BATCH_ROIS_OHEM), so the R-CNN terms see each
chip's hardest rois only; it prints each step's smallest relative gap
between the k-th and the (k+1)-th roi loss of a chip, which must stay far
above the frameworks' fp32 differences for the two to keep the same rois.
tests/test_torch_ohem.py compares against it.

The fixture of a set of flags is tests/fixtures/torch_train[_mask]
[_autofocus][_ohem]_golden.json. The JAX steps take about 50 s here with
their compile (minutes op by op with the mask branch), which is why their
outputs are frozen. Regenerate (only after an intentional change of the
semantics):
    python scripts/gen_torch_train_golden.py [--mask] [--autofocus] [--ohem]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

# generation runs under the test suite's environment (tests/conftest.py):
# the same backend and host-device count, hence the same XLA reductions
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
import jax  # noqa: E402

if jax.config.jax_platforms and \
        jax.config.jax_platforms.split(",")[0] != "cpu":
    jax.config.update("jax_platforms", "cpu")

FIXTURES = os.path.join(ROOT, "tests", "fixtures")

B, H, W = 2, 64, 64
G = 4  # GT rows per chip, the last one padding
N_STEPS = 3
INIT_KEY = 2
FIXED = ["conv0", "bn0", "stage1", "bn_data"]
METRICS = ("loss", "rpn_cls_loss", "rpn_bbox_loss", "rcnn_cls_loss",
           "rcnn_bbox_loss", "rcnn_acc", "rcnn_fg_frac", "offset_max",
           "offset_clamp_frac", "dcn_offset_max")
# (collection, flax path) of the leaves the fixture keeps
LEAVES = (
    ("params", "rcnn/bbox_pred/bias"),
    ("params", "rcnn/cls_score/bias"),
    ("params", "rcnn/offset/bias"),
    ("params", "rpn/rpn_cls_score/bias"),
    ("params", "conv_new_1/bias"),
    ("params", "trunk/stage4_unit1/offset/bias"),
    ("params", "trunk/stage2_unit1/bn1/scale"),
    ("params", "trunk/stage3_unit1/bn3/bias"),
    ("params", "trunk/stage1_unit1/bn1/scale"),  # frozen
    ("batch_stats", "trunk/stage2_unit1/bn1/mean"),
    ("batch_stats", "trunk/stage2_unit1/bn1/var"),
    ("batch_stats", "trunk/stage4_unit1/bn2/var"),
    ("batch_stats", "trunk/stage1_unit1/bn2/mean"),  # frozen
)
# the branches' own leaves, kept beside LEAVES
MASK_LEAVES = (
    ("params", "mask_offset/bias"),
    ("params", "mask/mask_conv_3x3_1/bias"),
    ("params", "mask/mask_deconv/bias"),
    ("params", "mask/mask_out/bias"),
)
AF_LEAVES = (
    ("params", "autofocus/conv_new_2/bias"),
    ("params", "autofocus/conv_new_3/bias"),
    ("params", "autofocus/conv_new_out/bias"),
)
OHEM_ROIS = 8  # of the 16 + G sampled rois per image
# (small_thresh, dc_low, dc_high) of the FocusPixel labels: the GT boxes of
# make_batch (sqrt areas 16 to 43 px) fall on both sides of small_thresh
AUTOFOCUS_PARAMS = (32.0, 5.0, 90.0)


def make_cfg():
    from sniper_tpu.config import default_config

    cfg = default_config()
    cfg.TRAIN.lr = 0.01
    cfg.TRAIN.warmup = True
    cfg.TRAIN.warmup_lr = 0.001
    cfg.TRAIN.warmup_step = 2
    cfg.TRAIN.lr_step = "1.0"
    cfg.TRAIN.wd = 0.0005
    cfg.network.FIXED_PARAMS = list(FIXED)
    return cfg


def model_kwargs(mask=False, autofocus=False):
    from torch_port import TINY

    kw = dict(num_rois=TINY["post_nms_top_n"] + G, fg_fraction=1.0,
              train_pre_nms=TINY["pre_nms_top_n"],
              train_post_nms=TINY["post_nms_top_n"])
    if mask:
        kw["with_mask"] = True
    if autofocus:
        kw["autofocus"] = True
    return kw


def gt_polygons(gt):
    """Per GT row of gt [G,5] (rows with class -1 are padding), its
    polygons: an ellipse of 16 vertices inscribed in the box, for the first
    row a triangle and a square beside it (two segments)."""
    out = []
    for i, (x1, y1, x2, y2, c) in enumerate(gt):
        if c < 0:
            out.append([])
            continue
        if i == 0:
            mx, my = (x1 + x2) / 2, (y1 + y2) / 2
            out.append([[x1, y2, mx, y1, x2, y2],
                        [x1, y1, mx, y1, mx, my, x1, my]])
            continue
        t = np.arange(16) * (2 * np.pi / 16)
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        pts = np.stack([cx + (x2 - x1) / 2 * np.cos(t),
                        cy + (y2 - y1) / 2 * np.sin(t)], 1)
        out.append([pts.reshape(-1).tolist()])
    return out


def make_batch(mask=False, autofocus=False):
    """Unit-noise chips (the random RPN's scores stay spread, far from
    ties), GT boxes of three sizes, sparse RPN targets; with ``mask`` the
    GT masks of gt_polygons, rasterized as the chip loader does; with
    ``autofocus`` the FocusPixel labels of the GT boxes."""
    rng = np.random.RandomState(21)
    A = 9
    n = A * (H // 16) * (W // 16)
    gt = np.full((B, G, 5), -1.0, np.float32)
    gt[0, :3] = [[4, 6, 40, 44, 1], [20, 10, 60, 30, 2], [8, 30, 24, 50, 3]]
    gt[1, :3] = [[10, 12, 50, 58, 4], [2, 2, 22, 20, 1], [30, 20, 62, 40, 2]]
    S, F = 32, 8
    pids = np.stack([rng.permutation(n)[:S] for _ in range(B)])
    pids[:, -4:] = -1
    fg = np.stack([rng.permutation(n)[:F] for _ in range(B)])
    fg[:, -2:] = -1
    batch = {
        "data": rng.randn(B, H, W, 3).astype(np.float32),
        "im_info": np.array([[H, W, 1.0], [H - 8, W - 4, 1.0]], np.float32),
        "gt_boxes": gt,
        "valid_ranges": np.array([[0.0, 1e5], [0.0, 40.0]], np.float32),
        "rpn_pids": pids.astype(np.int32),
        "rpn_label_vals": rng.choice([0.0, 1.0], (B, S), p=[0.7, 0.3])
        .astype(np.float32),
        "fg_pids": fg.astype(np.int32),
        "fg_targets": (rng.randn(B, F, 4) * 0.2).astype(np.float32),
    }
    if mask:
        from sniper_tpu.data.mask_utils import rasterize_gt_masks

        batch["gt_masks"] = np.stack([
            rasterize_gt_masks(gt_polygons(g), g[:, :4], grid=112,
                               max_n_gts=G) for g in gt])
    if autofocus:
        from sniper_tpu.data.anchor_targets import (
            AnchorTargetAssigner,
            AutoFocusParams,
        )

        assigner = AnchorTargetAssigner(
            H, autofocus=AutoFocusParams(*AUTOFOCUS_PARAMS))
        batch["scale_label"] = np.stack([
            assigner._focus_map(g[g[:, 4] >= 0, :4]) for g in gt])
    return batch


def initial_variables(mask=False, autofocus=False):
    from torch_port import tiny_jax_detector

    kw = model_kwargs(mask, autofocus)
    if mask:
        kw["mask_head_init"] = jax.nn.initializers.he_normal()
    _, variables = tiny_jax_detector(INIT_KEY, **kw)
    return variables


def leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return np.asarray(tree)


def fixture_path(mask=False, autofocus=False, ohem=False):
    flags = "".join(f"_{n}" for n, on in (("mask", mask),
                                          ("autofocus", autofocus),
                                          ("ohem", ohem)) if on)
    return os.path.join(FIXTURES, f"torch_train{flags}_golden.json")


def metric_names(mask=False, autofocus=False):
    return (METRICS + (("mask_loss",) if mask else ())
            + (("focus_loss",) if autofocus else ()))


def leaf_names(mask=False, autofocus=False):
    return (LEAVES + (MASK_LEAVES if mask else ())
            + (AF_LEAVES if autofocus else ()))


def ohem_gap(outputs, k):
    """The smallest relative gap, over the chips, between the k-th and the
    (k+1)-th largest per-roi loss (cls + bbox, as ohem_select ranks them)
    of a JAX training forward's outputs; inf when no chip has k + 1 valid
    rois."""
    import jax.numpy as jnp

    from sniper_tpu.models.losses import smooth_l1

    labels = np.asarray(outputs["rcnn_labels"])
    logp = np.asarray(jax.nn.log_softmax(
        jnp.asarray(outputs["cls_score"], jnp.float32), axis=-1))
    cls = -np.take_along_axis(logp, np.maximum(labels, 0)[..., None],
                              -1)[..., 0]
    diff = np.asarray(outputs["bbox_pred"] - outputs["rcnn_bbox_targets"],
                      np.float32)
    box = (np.asarray(outputs["rcnn_bbox_weights"])
           * np.asarray(smooth_l1(diff))).sum(-1)
    gaps = []
    for c, b, lab in zip(cls, box, labels):
        t = np.sort(np.where(lab >= 0, c + b, -np.inf))[::-1]
        if np.isfinite(t[k]):
            gaps.append((t[k - 1] - t[k]) / abs(t[k - 1]))
    return min(gaps, default=np.inf)


def run_jax(mask=False, autofocus=False, ohem=False):
    import jax.numpy as jnp

    from sniper_tpu.models.detector import SNIPERDetector
    from sniper_tpu.parallel.mesh import make_mesh, shard_batch
    from sniper_tpu.train.optimizer import make_optimizer
    from sniper_tpu.train.trainer import TrainState, make_train_step
    from torch_port import TINY

    cfg = make_cfg()
    model = SNIPERDetector(**dict(TINY, dtype=jnp.float32,
                                  pool_kernel="fused",
                                  **model_kwargs(mask, autofocus)))
    variables = initial_variables(mask, autofocus)
    tx, _ = make_optimizer(cfg, epoch_size=100, params=variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=jax.tree.map(jnp.asarray, variables["params"]),
                       batch_stats=jax.tree.map(jnp.asarray,
                                                variables["batch_stats"]),
                       opt_state=tx.init(variables["params"]))
    mesh = make_mesh(1)
    step = make_train_step(model, tx, mesh, B, pixel_means=(0.0, 0.0, 0.0),
                           with_mask=mask, with_autofocus=autofocus,
                           ohem_rois=OHEM_ROIS if ohem else 0)
    batch = shard_batch(mesh, make_batch(mask, autofocus))
    metrics = []
    with jax.disable_jit(mask):
        for i in range(N_STEPS):
            if ohem:
                out = model.apply(
                    {"params": state.params,
                     "batch_stats": state.batch_stats},
                    batch["data"], batch["im_info"], batch["gt_boxes"],
                    batch["valid_ranges"], train=True,
                    rngs={"sampling": jax.random.PRNGKey(i)},
                    mutable=["batch_stats", "intermediates"])[0]
                print(f"step {i}: smallest relative gap at the OHEM "
                      f"threshold {ohem_gap(out, OHEM_ROIS):.3e}")
            state, m = step(state, batch, jax.random.PRNGKey(i))
            metrics.append({k: float(m[k])
                            for k in metric_names(mask, autofocus)})
    final = {"params": state.params, "batch_stats": state.batch_stats}
    return metrics, {f"{c}/{p}": leaf(final[c], p).tolist()
                     for c, p in leaf_names(mask, autofocus)}


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mask", action="store_true",
                   help="with the mask branch")
    p.add_argument("--autofocus", action="store_true",
                   help="with the FocusPixel head")
    p.add_argument("--ohem", action="store_true",
                   help=f"with OHEM over {OHEM_ROIS} rois per image")
    args = p.parse_args()
    metrics, leaves = run_jax(args.mask, args.autofocus, args.ohem)
    path = fixture_path(args.mask, args.autofocus, args.ohem)
    with open(path, "w") as f:
        json.dump({"steps": N_STEPS, "metrics": metrics, "leaves": leaves},
                  f, indent=1)
        f.write("\n")
    print(f"wrote {path}")
    for i, m in enumerate(metrics):
        print(i, m)


if __name__ == "__main__":
    main()
