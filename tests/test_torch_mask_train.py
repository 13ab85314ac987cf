"""The port's mask training against the JAX package, on the CPU in fp32.

- The 14x14 two-pass pool's gradients: d(feat), d(off_w), d(off_b) of
  fused_offset_pool(pooled_size=14) against jax.grad through the JAX mask
  branch's route (fused_offset_pool(extract="einsum"), margin 1 bin) at
  fc_scale 0 (every window start on the tent kinks, the zero-initialised
  ``mask_offset`` of step 1), 0.01 (interior) and 0.1 (the clip rails), a
  few rois on a 16x20 map; the same fp32 arithmetic summed in another
  order: within test_torch_deform_bwd's 2e-5 * max|ref|.
- mask_targets_from_dense against the JAX op: targets and class ids equal,
  invalid rois and rois partly outside their GT box included.
- crop_polys and rasterize_gt_masks byte for byte, append_flipped_images
  with polygons equal, and mask_loss within rtol 1e-6 (the same fp32
  expression).
- The tiny mask detector's training forward on converted weights, with
  the sampler's draws injected (the key the JAX detector hands its
  sampler, turned into the same uniform priorities): mask_targets equal,
  mask_logits within 1e-4 of their scale (two frameworks' fp32 layers in
  another order).
- Three training steps with masks against the frozen JAX steps of
  tests/fixtures/torch_train_mask_golden.json, with
  test_torch_train_step's tolerances (mask_loss within rtol 1e-3).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sniper_tpu.data import mask_utils as jmask_utils
from sniper_tpu.data import roidb as jroidb
from sniper_tpu.models import losses as jlosses
from sniper_tpu.ops import deform as jdeform
from sniper_tpu.ops.mask_target import (
    mask_targets_from_dense as jmask_targets,
)
from sniper_tpu_torch.data import mask_utils as tmask_utils
from sniper_tpu_torch.data import roidb as troidb
from sniper_tpu_torch.models import losses as tlosses
from sniper_tpu_torch.ops import deform as tdeform
from sniper_tpu_torch.ops.mask_target import mask_targets_from_dense
from test_torch_deform_bwd import _close, _random_rois
from test_torch_sampler import _jax_priorities
from test_torch_train_step import check_three_steps
from torch_port import close_to_scale, tiny_torch_detector

import gen_torch_train_golden as gg  # on sys.path via test_torch_train_step


@pytest.mark.parametrize("fc_scale", [0.0, 0.01, 0.1])
def test_pool_p14_grads_match_jax(rng, fc_scale):
    P, C, B, H, W, rpi = 14, 4, 2, 16, 20, 2
    rois = _random_rois(rng, B, rpi, span=300)
    feat = rng.randn(B, H, W, C).astype(np.float32)
    off_k = (rng.randn(P * P * C, 2 * P * P) * fc_scale).astype(np.float32)
    off_b = (rng.randn(2 * P * P) * fc_scale).astype(np.float32)
    gct = rng.randn(B * rpi, P * P * C).astype(np.float32)

    def loss(feat, off_k, off_b):
        out = jdeform.fused_offset_pool(
            feat, jnp.asarray(rois), off_k, off_b, rois_per_image=rpi,
            pooled_size=P, margin_bins=1, extract="einsum")
        return jnp.sum(out * gct)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(feat), jnp.asarray(off_k), jnp.asarray(off_b))
    tf = torch.from_numpy(feat).requires_grad_()
    tw = torch.from_numpy(off_k.T.copy()).requires_grad_()
    tb = torch.from_numpy(off_b).requires_grad_()
    out = tdeform.fused_offset_pool(tf, torch.from_numpy(rois), tw, tb,
                                    rois_per_image=rpi, pooled_size=P,
                                    margin_bins=1)
    (out * torch.from_numpy(gct)).sum().backward()
    for name, a, b in zip(("dfeat", "doff_k", "doff_b"),
                          (tf.grad, tw.grad.t(), tb.grad), want):
        _close(a, b, name=name)
    if fc_scale == 0.0:  # the kink conventions decide the FC's gradient
        assert float(np.abs(np.asarray(want[1])).max()) > 0


def _polygon(rng, box, n):
    """A star-shaped polygon of n vertices around the box's centre, some
    vertices past the box."""
    x1, y1, x2, y2 = box
    t = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(0.3, 0.65, n)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    return np.stack([cx + r * (x2 - x1) * np.cos(t),
                     cy + r * (y2 - y1) * np.sin(t)], 1).reshape(-1)


def test_mask_targets_match_jax(rng):
    B, M, G, D = 2, 12, 5, 112
    boxes = np.zeros((B, G, 5), np.float32)
    xy = rng.uniform(0, 200, (B, G, 2))
    wh = rng.uniform(8, 120, (B, G, 2))
    boxes[..., :2], boxes[..., 2:4] = xy, xy + wh
    boxes[..., 4] = rng.randint(1, 5, (B, G))
    boxes[:, -1] = -1.0  # a padded row
    dense = np.stack([jmask_utils.rasterize_gt_masks(
        [[_polygon(rng, b[:4], 12)] for b in boxes[i, :G - 1]],
        boxes[i, :G - 1], grid=D, max_n_gts=G) for i in range(B)])
    matched = rng.randint(0, G - 1, (B, M))
    matched[:, -3:] = -1  # invalid rois
    rois = np.zeros((B, M, 5), np.float32)
    rois[..., 0] = np.arange(B)[:, None]
    g = np.take_along_axis(boxes, matched.clip(0)[..., None], 1)
    # rois around their GT box: shifted and rescaled, partly outside it
    c = (g[..., :2] + g[..., 2:4]) / 2 + rng.uniform(-20, 20, (B, M, 2))
    half = (g[..., 2:4] - g[..., :2]) / 2 * rng.uniform(0.5, 1.6, (B, M, 1))
    rois[..., 1:3], rois[..., 3:5] = c - half, c + half
    want_t, want_c = jmask_targets(jnp.asarray(rois), jnp.asarray(matched),
                                   jnp.asarray(boxes),
                                   jnp.asarray(dense, jnp.float32))
    got_t, got_c = mask_targets_from_dense(
        torch.from_numpy(rois), torch.from_numpy(matched),
        torch.from_numpy(boxes), torch.from_numpy(dense).float())
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    t = got_t.numpy()
    assert (t[:, -3:] == -1).all() and (t[:, :-3] == 1).any()
    assert (t[:, :-3] == 0).any()  # cells outside the object or the box


def test_crop_and_rasterize_match_jax(rng):
    boxes = np.array([[10, 20, 90, 70], [30, 5, 60, 100], [0, 0, 3, 3],
                      [50, 50, 51, 120]], np.float32)
    polys = [[_polygon(rng, b, 10)] for b in boxes]
    polys[1].append(_polygon(rng, boxes[1], 5))  # two segments
    polys[2] = []  # a GT without polygons
    crop, scale = np.array([8.0, 4.0, 200.0, 200.0]), 1.37
    got = tmask_utils.crop_polys(polys, crop, scale)
    want = jmask_utils.crop_polys(polys, crop, scale)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)
    cboxes = (boxes - crop[[0, 1, 0, 1]]) * scale
    for grid, n in ((112, 6), (28, 3)):
        a = tmask_utils.rasterize_gt_masks(got, cboxes, grid=grid,
                                           max_n_gts=n)
        b = jmask_utils.rasterize_gt_masks(want, cboxes, grid=grid,
                                           max_n_gts=n)
        assert a.dtype == np.uint8 and a.shape == (n, grid, grid)
        np.testing.assert_array_equal(a, b)
        assert a[0].any() and not a[2].any()


def test_flip_with_masks_matches_jax(rng):
    roidb = []
    for i in range(2):
        boxes = np.array([[10, 20, 90, 70], [30, 5, 60, 100]], np.float32)
        roidb.append({"image": f"img{i}", "width": 160 + 8 * i,
                      "height": 120, "boxes": boxes, "flipped": False,
                      "gt_masks": [[_polygon(rng, b, 8)] for b in boxes]})
    roidb[1]["gt_masks"][0].append(_polygon(rng, roidb[1]["boxes"][0], 4))
    got = troidb.append_flipped_images(copy.deepcopy(roidb))
    want = jroidb.append_flipped_images(copy.deepcopy(roidb))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
        assert a["flipped"] == b["flipped"]
        for pa, pb in zip(a["gt_masks"], b["gt_masks"]):
            assert len(pa) == len(pb)
            for x, y in zip(pa, pb):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # x -> width - x - 1 on the even coordinates only
    seg = np.asarray(got[2]["gt_masks"][0][0])
    orig = roidb[0]["gt_masks"][0][0]
    np.testing.assert_allclose(seg[0::2], 160 - orig[0::2] - 1, rtol=1e-6)
    np.testing.assert_array_equal(seg[1::2], orig[1::2].astype(np.float32))


def test_mask_loss_matches_jax(rng):
    logits = rng.randn(6, 28, 28, 2).astype(np.float32) * 3
    targets = rng.choice([-1.0, 0.0, 1.0], (6, 28, 28)).astype(np.float32)
    targets[2] = -1.0  # an invalid roi
    want = jlosses.mask_loss(jnp.asarray(logits), jnp.asarray(targets))
    got = tlosses.mask_loss(torch.from_numpy(logits),
                            torch.from_numpy(targets))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_mask_train_forward_matches_jax(monkeypatch):
    """The training forward of the tiny mask detector, JAX and port, from
    the same converted variables and batch (gen_torch_train_golden's mask
    fixture), the port's sampler fed the JAX sampler's draws."""
    import sniper_tpu.models.detector as jdet
    from sniper_tpu.models.detector import SNIPERDetector
    from torch_port import TINY

    keys = []
    orig = jdet.multi_proposal_target

    def spy(*args, **kw):
        keys.append(args[6])  # the sampler's key
        return orig(*args, **kw)

    monkeypatch.setattr(jdet, "multi_proposal_target", spy)
    variables = gg.initial_variables(mask=True)
    kw = gg.model_kwargs(mask=True)
    jmodel = SNIPERDetector(**dict(TINY, dtype=jnp.float32, **kw))
    batch = gg.make_batch(mask=True)
    want, _ = jmodel.apply(
        variables, jnp.asarray(batch["data"]), jnp.asarray(batch["im_info"]),
        jnp.asarray(batch["gt_boxes"]), jnp.asarray(batch["valid_ranges"]),
        gt_masks=jnp.asarray(batch["gt_masks"]), train=True,
        rngs={"sampling": jax.random.PRNGKey(7)},
        mutable=["batch_stats", "intermediates"])
    assert len(keys) == 1
    fg_u, bg_u = _jax_priorities(keys[0], gg.B, kw["train_post_nms"] + gg.G)
    model = tiny_torch_detector(variables, **kw).train()
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = model(t["data"], t["im_info"], t["gt_boxes"],
                    t["valid_ranges"], gt_masks=t["gt_masks"], train=True,
                    priorities=(torch.from_numpy(fg_u),
                                torch.from_numpy(bg_u)))
    m = min(model.num_mask_rois, model.num_rois)
    assert got["mask_logits"].shape == (gg.B * m, 28, 28, 2)
    np.testing.assert_array_equal(got["rcnn_labels"].numpy(),
                                  np.asarray(want["rcnn_labels"]))
    tgt = got["mask_targets"].numpy()
    np.testing.assert_array_equal(tgt, np.asarray(want["mask_targets"]))
    assert (tgt == 1).any() and (tgt == 0).any() and (tgt == -1).any()
    close_to_scale(got["mask_logits"], want["mask_logits"])


def test_three_mask_train_steps_match_jax():
    check_three_steps(mask=True)


def test_init_detector_mask_layers_follow_the_flax_init():
    """models/init.py gives the mask layers the JAX package's inits:
    normal(0.01) on every MaskHead layer with zero biases, zeros on the
    mask_offset FC (normal(offset_std) when asked)."""
    from sniper_tpu_torch.models.init import init_detector

    m = init_detector(tiny_torch_detector(with_mask=True),
                      seed=1).requires_grad_(False)
    for layer in m.mask.children():
        assert abs(float(layer.weight.std()) / 0.01 - 1) < 0.05, layer
        assert float(layer.bias.abs().max()) == 0.0
    assert float(m.mask_offset.weight.abs().max()) == 0.0
    assert float(m.mask_offset.bias.abs().max()) == 0.0
    a = init_detector(tiny_torch_detector(with_mask=True), seed=1,
                      offset_std=1e-3).requires_grad_(False)
    assert abs(float(a.mask_offset.weight.std()) / 1e-3 - 1) < 0.05
