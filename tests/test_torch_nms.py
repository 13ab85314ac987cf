"""The port's NMS and proposal op against the JAX package, on the CPU.

Inputs come from a numpy seed and go through both frameworks in fp32.
Boxes carry no tied scores: nms_jax's first-index tie rule holds in both,
but lax.top_k's and torch.topk's tie orders differ. Keep lists must be
identical (the plain torch NMS computes the IoU in nms_jax's fp32 order).

The proposal op is held in two halves. The box decode agrees to fp32
rounding (exp differs in the last ulp between XLA and torch): atol 1e-3 px,
rtol 1e-5. The top-k and NMS that follow are held exactly, on the
JAX-decoded boxes given to both: fed each framework's own decode, an IoU
within an ulp of the threshold (all 600 candidates enter NMS at
min_size 0) can flip a keep decision on some CPUs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sniper_tpu.ops import nms as jnms
from sniper_tpu.ops import proposals as jprop
from sniper_tpu_torch.ops import anchors as tanchors
from sniper_tpu_torch.ops import nms as tnms
from sniper_tpu_torch.ops.proposals import multi_proposal
from conftest import random_boxes
from torch_port import cuda_or_skip


def _distinct_scores(rng, n):
    return ((rng.permutation(n) + 1.0) / (n + 1)).astype(np.float32)


def _boxes_batch(rng, b, n, hw=(256, 256)):
    dets = np.stack([random_boxes(rng, n, hw=hw) for _ in range(b)])
    dets[..., 4] = np.stack([_distinct_scores(rng, n) for _ in range(b)])
    return dets


def _jax_keep(dets, max_out, thresh):
    keep, valid = jax.jit(jnms.nms_jax, static_argnums=(2, 3))(
        jnp.asarray(dets[:, :4]), jnp.asarray(dets[:, 4]), max_out, thresh)
    return np.asarray(keep), np.asarray(valid)


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_plain_nms_matches_nms_jax(rng, thresh):
    dets = _boxes_batch(rng, 2, 150)
    keep, valid = tnms.nms(torch.from_numpy(dets[..., :4].copy()),
                           torch.from_numpy(dets[..., 4].copy()), 64, thresh)
    for i in range(2):
        jk, jv = _jax_keep(dets[i], 64, thresh)
        np.testing.assert_array_equal(keep[i].numpy(), jk)
        np.testing.assert_array_equal(valid[i].numpy(), jv)


def test_plain_nms_padding_and_degenerate_boxes(rng):
    """NEG_INF entries are never picked (and end the keep list);
    degenerate boxes (+1 area <= 0) have IoU 0 with everything."""
    dets = random_boxes(rng, 40, hw=(128, 128))
    dets[:, 4] = _distinct_scores(rng, 40)
    dets[5, 2:4] = dets[5, 0:2] - 3.0  # inverted box
    boxes = np.concatenate([dets[:, :4], np.zeros((24, 4), np.float32)])
    scores = np.concatenate([dets[:, 4], np.full(24, jnms.NEG_INF,
                                                 np.float32)])
    keep, valid = tnms.nms(torch.from_numpy(boxes)[None],
                           torch.from_numpy(scores)[None], 64, 0.5)
    jk, jv = _jax_keep(np.concatenate([boxes, scores[:, None]], 1), 64, 0.5)
    np.testing.assert_array_equal(keep[0].numpy(), jk)
    np.testing.assert_array_equal(valid[0].numpy(), jv)
    assert int(keep[0][valid[0]].max()) < 40
    assert (keep[0][~valid[0]] == -1).all()


def test_plain_nms_matches_nms_pallas_interpret(rng):
    from jax.experimental.pallas import tpu as pltpu

    from sniper_tpu.ops.pallas.nms import nms_pallas

    dets = _boxes_batch(rng, 1, 100)[0]
    with pltpu.force_tpu_interpret_mode():
        jk, jv = nms_pallas(jnp.asarray(dets[:, :4]),
                            jnp.asarray(dets[:, 4]), 64, 0.5)
    keep, valid = tnms.nms(torch.from_numpy(dets[None, :, :4].copy()),
                           torch.from_numpy(dets[None, :, 4].copy()), 64, 0.5)
    np.testing.assert_array_equal(keep[0].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(jv))


@pytest.mark.parametrize("thresh", [0.3, 0.7])
def test_host_nms_copies_match(rng, thresh):
    """The port's NumPy copies give the JAX package's host results."""
    dets = random_boxes(rng, 80, hw=(200, 200))
    assert tnms.nms_np(dets, thresh) == jnms.nms_np(dets, thresh)
    np.testing.assert_array_equal(
        tnms.soft_nms_np(dets, sigma=0.55), jnms.soft_nms_np(dets, sigma=0.55))
    sets = [random_boxes(rng, n, hw=(200, 200)) for n in (0, 7, 30)]
    for a, b in zip(tnms.soft_nms_np_batched(sets, sigma=0.55),
                    jnms.soft_nms_np_batched(sets, sigma=0.55)):
        np.testing.assert_array_equal(a, b)
    w_t, w_j = tnms.NMSWrapper(thresh, -1), jnms.NMSWrapper(thresh, -1)
    np.testing.assert_array_equal(w_t(dets), w_j(dets))


def test_anchor_copy_matches():
    a = tanchors.make_anchors_ahw(6, 9, 16, (0.5, 1, 2), (2, 4, 7, 10))
    b = jprop.make_anchors_ahw(6, 9, 16, (0.5, 1, 2), (2, 4, 7, 10))
    np.testing.assert_array_equal(a, b)
    dev = jprop.anchors_ahw_on_device(6, 9, 16, (0.5, 1, 2), (2, 4, 7, 10))
    np.testing.assert_array_equal(a, np.asarray(dev))


@pytest.mark.parametrize("min_size", [0.0, 16.0])
def test_multi_proposal_matches_jax(rng, min_size):
    from functools import partial

    from sniper_tpu_torch.ops import proposals as tprop

    fh, fw, stride = 12, 16, 16
    ratios, scales = (0.5, 1, 2), (2, 4, 7)
    A = 9
    B = 2
    anchors = tanchors.make_anchors_ahw(fh, fw, stride, ratios, scales)
    fg = np.stack([_distinct_scores(rng, A * fh * fw).reshape(A, fh, fw)
                   for _ in range(B)])
    deltas = (rng.randn(B, 4 * A, fh, fw) * 0.2).astype(np.float32)
    im_info = np.array([[fh * stride, fw * stride, 1.0],
                        [fh * stride - 30, fw * stride - 50, 1.5]],
                       np.float32)
    pre_nms, post_nms, thresh = 600, 50, 0.7

    # decode: to fp32 rounding
    jprops, jscores = jax.vmap(partial(
        jprop._decode_single, anchors=jnp.asarray(anchors),
        min_size=min_size))(jnp.asarray(fg), jnp.asarray(deltas),
                            jnp.asarray(im_info))
    tprops, tscores = tprop._decode(
        torch.from_numpy(fg), torch.from_numpy(deltas),
        torch.from_numpy(im_info), torch.from_numpy(anchors), min_size)
    np.testing.assert_allclose(tprops.numpy(), np.asarray(jprops), atol=1e-3,
                               rtol=1e-5)
    np.testing.assert_array_equal(tscores.numpy(), np.asarray(jscores))

    # top-k + NMS (_proposal_single after the decode): exact on the same
    # boxes
    def jselect(props, scores):
        top_scores, top_idx = jax.lax.top_k(scores, pre_nms)
        top_props = props[top_idx]
        keep, valid = jnms.nms_jax(top_props, top_scores, post_nms, thresh)
        safe = jnp.maximum(keep, 0)
        return (jnp.where(valid[:, None], top_props[safe], 0.0),
                jnp.where(valid, top_scores[safe], 0.0), valid)

    jr, js, jv = jax.vmap(jselect)(jprops, jscores)
    tr, ts, tv = tprop.select(torch.from_numpy(np.array(jprops)),
                              torch.from_numpy(np.array(jscores)),
                              pre_nms=pre_nms, post_nms=post_nms,
                              thresh=thresh)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    # the whole op: the batch index column on the selected boxes
    rois, scores, valid = multi_proposal(
        torch.from_numpy(fg), torch.from_numpy(deltas),
        torch.from_numpy(im_info), torch.from_numpy(anchors),
        pre_nms=pre_nms, post_nms=post_nms, thresh=thresh, min_size=min_size)
    assert rois.shape == (B, post_nms, 5) and scores.shape == (B, post_nms)
    np.testing.assert_array_equal(rois[..., 0].numpy(),
                                  np.repeat(np.arange(B), post_nms)
                                  .reshape(B, post_nms))


@pytest.mark.cuda
def test_nms_kernel_matches_plain(rng):
    dev = cuda_or_skip()
    dets = _boxes_batch(rng, 3, 3000, hw=(800, 1200))
    boxes = torch.from_numpy(dets[..., :4].copy()).to(dev)
    scores = torch.from_numpy(dets[..., 4].copy()).to(dev)
    k1, v1 = tnms.nms(boxes, scores, 300, 0.7)
    k2, v2 = tnms.nms_plain(boxes, scores, 300, 0.7)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


@pytest.mark.cuda
def test_nms_kernel_rejects_what_it_does_not_take():
    dev = cuda_or_skip()
    boxes = torch.zeros(1, 10, 4, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        tnms.nms(boxes, torch.zeros(1, 10, device=dev), 5, 0.5)
