"""The port's NMS and proposal op against the JAX package, on the CPU.

Inputs come from a numpy seed and go through both frameworks in fp32.
Keep lists must be identical (the plain torch NMS computes the IoU in
nms_jax's fp32 order). Tied scores, repeated and inverted boxes, as a
random-weight RPN emits them, enter the sorted entry's cases, whose order
is fixed by a stable sort before either framework sees it.

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
    def jdecode():
        return jax.vmap(partial(
            jprop._decode_single, anchors=jnp.asarray(anchors),
            min_size=min_size))(jnp.asarray(fg), jnp.asarray(deltas),
                                jnp.asarray(im_info))

    def tdecode(dtype=torch.float32):
        return tprop._decode(*(torch.from_numpy(a).to(dtype) for a in (
            fg, deltas, im_info, anchors)), min_size)

    jprops, jscores = jdecode()
    tprops, tscores = tdecode()
    report = ""
    if not np.allclose(tprops.numpy(), np.asarray(jprops), atol=1e-3,
                       rtol=1e-5):
        # which side moved: each decode again, and each against a float64
        # decode of the same inputs
        ref = tdecode(torch.float64)[0].numpy()
        gap = {"jax - f64": np.asarray(jprops) - ref,
               "torch - f64": tprops.numpy() - ref,
               "jax again - jax": np.asarray(jdecode()[0]) - np.asarray(jprops),
               "torch again - torch": tdecode()[0].numpy() - tprops.numpy()}
        report = "; ".join(f"max |{k}| {np.abs(v).max():.3g}"
                           for k, v in gap.items())
    np.testing.assert_allclose(tprops.numpy(), np.asarray(jprops), atol=1e-3,
                               rtol=1e-5, err_msg=report)
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


def _tied_batch(rng, b, n, hw=(256, 256)):
    """As a random-weight RPN emits boxes: 40% repeats of 12 boxes per
    image (the whole canvas among them), 1% inverted (area <= 0), half the
    scores exactly 1.0 and a third on a 1/256 grid below it."""
    h, w = hw
    dets = np.stack([random_boxes(rng, n, hw=hw, max_size=min(h, w) // 2)
                     for _ in range(b)])
    reps = dets[:, :12, :4].copy()
    reps[:, 0] = [0.0, 0.0, w - 1.0, h - 1.0]
    u = rng.uniform(size=(b, n))
    pick = rng.randint(0, 12, (b, n))
    dets[..., :4] = np.where((u < 0.4)[..., None],
                             np.take_along_axis(reps, pick[..., None], 1),
                             dets[..., :4])
    inv = u > 0.99
    dets[inv, :4] = dets[inv][:, [2, 3, 0, 1]] - 2.0
    v = rng.uniform(size=(b, n))
    dets[..., 4] = np.where(
        v < 0.5, 1.0, np.where(v < 0.8, 1.0 - rng.randint(1, 26, (b, n))
                               / 256.0, dets[..., 4]))
    return dets


def _nms_case(rng, kind, b, n, hw=(256, 256)):
    """[b, n, 5] boxes and scores: "distinct" scores, "tied" (_tied_batch)
    or "padded" (tied, with all but a sixth of each image at NEG_INF;
    "half-padded": all but a half)."""
    if kind == "distinct":
        return _boxes_batch(rng, b, n, hw)
    dets = _tied_batch(rng, b, n, hw)
    if kind.endswith("padded"):
        dets[:, n // (2 if kind == "half-padded" else 6):, 4] = jnms.NEG_INF
        for d in dets:
            rng.shuffle(d)
    return dets


def _sorted(dets):
    """dets sorted as the proposal op's top-k leaves them: descending,
    ties in index order, NEG_INF last; and the order."""
    order = np.argsort(-dets[..., 4], axis=1, kind="stable")
    return np.take_along_axis(dets, order[..., None], 1), order


def _nms_both(fn, dets, max_out, thresh, dev="cpu"):
    t = torch.from_numpy(np.ascontiguousarray(dets)).to(dev)
    return fn(t[..., :4].contiguous(), t[..., 4].contiguous(), max_out,
              thresh)


def _threshold_pairs(rng, k, thresh=0.7):
    """[k, 2, 5] images of two boxes of one size, the second shifted by dx
    near the shift at which their IoU is thresh, kept where the fp32 IoU
    in nms_jax's order lies within 3 ulps of thresh: ties at the threshold
    and its neighbours on both sides."""
    w = rng.uniform(20, 500, 40 * k).astype(np.float32)
    h = rng.uniform(20, 500, 40 * k).astype(np.float32)
    t = np.float32(thresh)
    dx0 = (w * (1 - t) / (1 + t)).astype(np.float32)
    dx = (dx0 + rng.randint(-40, 41, 40 * k) * np.spacing(dx0)).astype(
        np.float32)
    one = np.float32(1)
    a = np.stack([np.zeros_like(w), np.zeros_like(w), w - one, h - one], 1)
    b = np.stack([dx, np.zeros_like(w), dx + w - one, h - one], 1)
    iw = np.maximum(np.float32(0), np.minimum(a[:, 2], b[:, 2])
                    - np.maximum(a[:, 0], b[:, 0]) + one)
    ih = np.maximum(np.float32(0), np.minimum(a[:, 3], b[:, 3])
                    - np.maximum(a[:, 1], b[:, 1]) + one)
    inter = iw * ih
    area_a = (a[:, 2] - a[:, 0] + one) * (a[:, 3] - a[:, 1] + one)
    area_b = (b[:, 2] - b[:, 0] + one) * (b[:, 3] - b[:, 1] + one)
    ovr = inter / (area_a + area_b - inter)
    ulps = np.abs(ovr.view(np.int32) - t.view(np.int32))
    pick = np.flatnonzero(ulps <= 3)[:k]
    dets = np.zeros((len(pick), 2, 5), np.float32)
    dets[:, 0, :4], dets[:, 1, :4] = a[pick], b[pick]
    dets[:, :, 4] = [1.0, 0.5]
    return dets, ovr[pick]


@pytest.mark.parametrize("kind", ["distinct", "tied", "padded"])
def test_sorted_entry_matches_nms_and_jax(rng, kind):
    """nms_sorted on sorted input (its CPU route) gives nms's and
    nms_jax's keep lists; on the unsorted input nms keeps the same boxes,
    by their original indices. N = 300 is not a multiple of 64; in
    "padded" max_out is above the live count."""
    dets = _nms_case(rng, kind, 2, 300)
    sdets, order = _sorted(dets)
    ks, vs = _nms_both(tnms.nms_sorted, sdets, 64, 0.7)
    kn, vn = _nms_both(tnms.nms, sdets, 64, 0.7)
    np.testing.assert_array_equal(ks.numpy(), kn.numpy())
    np.testing.assert_array_equal(vs.numpy(), vn.numpy())
    for i in range(2):
        jk, jv = _jax_keep(sdets[i], 64, 0.7)
        np.testing.assert_array_equal(ks[i].numpy(), jk)
        np.testing.assert_array_equal(vs[i].numpy(), jv)
    ku, vu = _nms_both(tnms.nms, dets, 64, 0.7)
    mapped = np.take_along_axis(order, ks.clamp_min(0).long().numpy(), 1)
    np.testing.assert_array_equal(ku.numpy(),
                                  np.where(vs.numpy(), mapped, -1))
    np.testing.assert_array_equal(vu.numpy(), vs.numpy())
    if kind == "padded":
        assert not vs.numpy()[:, -1].any()
    if kind == "tied":
        assert (sdets[..., 4] == 1.0).mean() > 0.4


# (B, N, max_out, input, canvas): the earlier random case, the main path's
# shapes (the three test scales and training), and the edges: N not a
# multiple of 64, N = 1, max_out above the live count, scans past 1024
# boxes
NMS_KERNEL_CASES = {
    "random-3x3000": (3, 3000, 300, "distinct", (800, 1200)),
    **{f"{label}-{kind}": (b, 6000, m, kind, (1408, 2048))
       for label, b, m in (("scale0", 4, 300), ("scale1", 8, 200),
                           ("scale2", 8, 100), ("training", 16, 300))
       for kind in ("distinct", "tied")},
    "n1000-tied": (2, 1000, 300, "tied", (256, 256)),
    "n1": (1, 1, 5, "distinct", (256, 256)),
    "n700-padded": (3, 700, 300, "padded", (256, 256)),
    # scans that run on past the first range of tiles the kernel resumes
    # from its saved state: to the last tile, and to a dead box in tile 5
    "n6000-deep": (2, 6000, 6000, "distinct", (4096, 4096)),
    "n6000-half-padded": (2, 6000, 3000, "half-padded", (4096, 4096)),
}


def test_plain_nms_at_the_threshold(rng):
    """nms_plain against nms_jax on pairs whose IoU ties the threshold or
    misses it by an ulp or two: the kernel's cases below."""
    dets, ovr = _threshold_pairs(rng, 256)
    assert (ovr == np.float32(0.7)).any() and (ovr < np.float32(0.7)).any()
    keep, valid = _nms_both(tnms.nms_sorted, dets, 2, 0.7)
    np.testing.assert_array_equal(valid[:, 1].numpy(),
                                  ovr < np.float32(0.7))
    for i in range(0, len(dets), 37):
        jk, jv = _jax_keep(dets[i], 2, 0.7)
        np.testing.assert_array_equal(keep[i].numpy(), jk)


@pytest.mark.cuda
def test_nms_kernel_exact_at_the_threshold(rng):
    """The kernel's IoU rounds as nms_plain's does (no FMA contraction):
    4096 two-box images at, and an ulp or two around, IoU 0.7."""
    dev = cuda_or_skip()
    dets, ovr = _threshold_pairs(rng, 4096)
    assert len(dets) > 1000 and (ovr == np.float32(0.7)).sum() > 50
    k1, v1 = _nms_both(tnms.nms_sorted, dets, 2, 0.7, dev)
    k2, v2 = _nms_both(tnms.nms_plain, dets, 2, 0.7, dev)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


@pytest.mark.cuda
@pytest.mark.parametrize("thresh", [-0.5, 0.0, 0.3, 1.0, 1.5])
def test_nms_kernel_thresholds(rng, thresh):
    """Thresholds at which every pair suppresses (<= 0: empty
    intersections too), the usual ones, and those that leave every box
    (> 1), on tied input with inverted boxes."""
    dev = cuda_or_skip()
    dets = _nms_case(rng, "tied", 3, 700)
    for fn, d in ((tnms.nms, dets), (tnms.nms_sorted, _sorted(dets)[0])):
        k1, v1 = _nms_both(fn, d, 100, thresh, dev)
        k2, v2 = _nms_both(tnms.nms_plain, d, 100, thresh, dev)
        assert torch.equal(k1, k2) and torch.equal(v1, v2), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(NMS_KERNEL_CASES))
def test_nms_kernel_matches_plain(rng, case):
    """Both entries' kernel against nms_plain: nms on the unsorted input,
    nms_sorted on it sorted."""
    dev = cuda_or_skip()
    b, n, max_out, kind, hw = NMS_KERNEL_CASES[case]
    dets = _nms_case(rng, kind, b, n, hw)
    for fn, d in ((tnms.nms, dets), (tnms.nms_sorted, _sorted(dets)[0])):
        k1, v1 = _nms_both(fn, d, max_out, 0.7, dev)
        k2, v2 = _nms_both(tnms.nms_plain, d, max_out, 0.7, dev)
        assert torch.equal(k1, k2) and torch.equal(v1, v2), fn.__name__


@pytest.mark.cuda
def test_nms_kernel_rejects_what_it_does_not_take():
    dev = cuda_or_skip()
    boxes = torch.zeros(1, 10, 4, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        tnms.nms(boxes, torch.zeros(1, 10, device=dev), 5, 0.5)
    with pytest.raises(ValueError):
        tnms.nms_sorted(boxes, torch.zeros(1, 10, device=dev), 5, 0.5)
    flat = torch.zeros(41, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        tnms.nms_sorted(flat[1:].view(1, 10, 4), torch.zeros(1, 10, device=dev),
                        5, 0.5)
