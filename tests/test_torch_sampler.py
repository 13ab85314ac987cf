"""The port's box encoding and training sampler against the JAX package, on
the CPU in fp32.

multi_proposal_target gets the JAX package's own fg/bg priorities (the
jax.random draws of sniper_tpu/ops/proposals.py:196-199,269) and
distinct RPN scores, so both frameworks rank the same candidates. The
proposals are decoded in each framework (exp differs in the last ulp), so
the whole op is compared on inputs whose decoded boxes keep clear of the
NMS threshold (small deltas, few anchors per cell). Labels, bbox weights
and matched GT indices must be identical; rois and regression targets agree
to fp32 rounding of the decode: atol 1e-3 px for rois, 1e-4 for the
std-normalized targets (divided by stds of 0.1), rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sniper_tpu.ops import boxes as jboxes
from sniper_tpu.ops import proposals as jprop
from sniper_tpu_torch.ops import anchors as tanchors
from sniper_tpu_torch.ops import boxes as tboxes
from sniper_tpu_torch.ops.proposals import multi_proposal_target
from conftest import random_boxes


@pytest.mark.parametrize("as_torch", [False, True])
def test_box_encode_half_matches_jax(rng, as_torch):
    a = random_boxes(rng, 30, hw=(300, 300))[:, :4]
    b = random_boxes(rng, 12, hw=(300, 300))[:, :4]
    b[3] = a[3]  # an exact match
    b[4] = [1000, 1000, 1010, 1010]  # no overlap
    conv = torch.from_numpy if as_torch else np.asarray
    for fn in ("bbox_overlaps", "ignore_overlaps"):
        got = getattr(tboxes, fn)(conv(a), conv(b))
        want = getattr(jboxes, fn)(a, b)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6,
                                   atol=1e-7, err_msg=fn)
    got = tboxes.bbox_transform(conv(a[:12]), conv(b))
    np.testing.assert_allclose(np.asarray(got), jboxes.bbox_transform(
        a[:12], b), rtol=1e-5, atol=1e-6)
    got = tboxes.filter_boxes_mask(conv(a), 40.0)
    np.testing.assert_array_equal(np.asarray(got),
                                  jboxes.filter_boxes_mask(a, 40.0))


def _jax_priorities(key, B, n_cand):
    """The uniform draws multi_proposal_target makes from ``key``."""
    fg, bg = [], []
    for k in jax.random.split(key, B):
        kf, kb = jax.random.split(k)
        fg.append(np.asarray(jax.random.uniform(kf, (n_cand,))))
        bg.append(np.asarray(jax.random.uniform(kb, (n_cand,))))
    return np.stack(fg), np.stack(bg)


@pytest.mark.parametrize("fg_fraction,valid_hi,num_rois", [
    (0.25, 1e5, 48),
    (0.25, 90.0, 48),  # large GTs out of range
    # as many slots as candidates, and the candidates on out-of-range GTs
    # neither fg nor bg: an ignore-labelled tail
    (0.5, 60.0, 70),
])
def test_multi_proposal_target_matches_jax(rng, fg_fraction, valid_hi,
                                           num_rois):
    fh, fw, stride = 10, 12, 16
    ratios, scales = (1.0,), (2, 4, 8)
    A, B, G = 3, 2, 6
    post_nms = 64
    anchors = tanchors.make_anchors_ahw(fh, fw, stride, ratios, scales)
    n = A * fh * fw
    fg = np.stack([((rng.permutation(n) + 1.0) / (n + 1)).astype(np.float32)
                   .reshape(A, fh, fw) for _ in range(B)])
    deltas = (rng.randn(B, 4 * A, fh, fw) * 0.05).astype(np.float32)
    im_info = np.array([[fh * stride, fw * stride, 1.0],
                        [fh * stride - 20, fw * stride - 40, 1.0]],
                       np.float32)
    gt = np.full((B, G, 5), -1.0, np.float32)
    for b in range(B):
        for g in range(G - 1):  # the last row stays padding
            x, y = rng.uniform(0, fw * stride - 110), rng.uniform(
                0, fh * stride - 110)
            s = rng.uniform(12, 100)
            gt[b, g] = [x, y, x + s, y + s * rng.uniform(0.7, 1.3),
                        rng.randint(1, 5)]
    # valid_hi < 100 puts the large GTs out of range (ignore labels)
    vr = np.array([[0.0, valid_hi], [20.0, valid_hi]], np.float32)
    kw = dict(pre_nms=300, post_nms=post_nms, thresh=0.7, min_size=0.0,
              num_rois=num_rois, fg_fraction=fg_fraction, fg_thresh=0.5,
              bg_thresh_hi=0.5, bg_thresh_lo=0.0,
              bbox_stds=(0.1, 0.1, 0.2, 0.2), bbox_means=(0.0, 0.0, 0.0, 0.0))
    key = jax.random.PRNGKey(3)
    want = jprop.multi_proposal_target(
        jnp.asarray(fg), jnp.asarray(deltas), jnp.asarray(im_info),
        jnp.asarray(gt), jnp.asarray(vr), jnp.asarray(anchors), key, **kw)
    fg_u, bg_u = _jax_priorities(key, B, post_nms + G)
    got = multi_proposal_target(
        torch.from_numpy(fg), torch.from_numpy(deltas),
        torch.from_numpy(im_info), torch.from_numpy(gt),
        torch.from_numpy(vr), torch.from_numpy(anchors),
        priorities=(torch.from_numpy(fg_u), torch.from_numpy(bg_u)), **kw)
    labels = np.asarray(want.labels)
    assert (labels > 0).any() and (labels == 0).any()
    if num_rois == post_nms + G:
        assert (labels == -1).any()
    side = np.sqrt((gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1]))
    assert ((side > valid_hi) & (gt[..., 4] > 0)).any() == (valid_hi < 100)
    np.testing.assert_array_equal(got.labels.numpy(), labels)
    np.testing.assert_array_equal(got.bbox_weights.numpy(),
                                  np.asarray(want.bbox_weights))
    np.testing.assert_array_equal(got.matched_gt.numpy(),
                                  np.asarray(want.matched_gt))
    np.testing.assert_allclose(got.rois.numpy(), np.asarray(want.rois),
                               atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(want.bbox_targets), atol=1e-4,
                               rtol=1e-5)


def test_multi_proposal_target_draws_from_the_generator(rng):
    """Without injected priorities the draws come from the generator: the
    same seed gives the same sample."""
    fh = fw = 6
    anchors = torch.from_numpy(tanchors.make_anchors_ahw(
        fh, fw, 16, (1.0,), (2, 4)))
    fg = torch.from_numpy(rng.rand(1, 2, fh, fw).astype(np.float32))
    deltas = torch.zeros(1, 8, fh, fw)
    info = torch.tensor([[96.0, 96.0, 1.0]])
    gt = torch.tensor([[[10.0, 10.0, 50.0, 60.0, 1.0]]])
    vr = torch.tensor([[0.0, 1e5]])
    kw = dict(pre_nms=72, post_nms=20, num_rois=12)
    outs = [multi_proposal_target(
        fg, deltas, info, gt, vr, anchors,
        generator=torch.Generator().manual_seed(5), **kw) for _ in range(2)]
    assert torch.equal(outs[0].rois, outs[1].rois)
    assert torch.equal(outs[0].labels, outs[1].labels)
    assert int((outs[0].labels > 0).sum()) >= 1  # the GT itself is fg
