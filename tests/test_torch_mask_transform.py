"""The port's NumPy copy of data/mask_transform.py against the JAX
package's: the cases of tests/test_mask_transform.py run on the port's
functions, then seeded random boxes and masks through both, equal result
for result (the same NumPy and OpenCV arithmetic)."""

import numpy as np
import pytest

from sniper_tpu.data import mask_transform as jmt
from sniper_tpu_torch.data import mask_transform as tmt
from sniper_tpu_torch.infer.masks import rle_to_binary_mask


def test_intersect_box_mask_paste():
    gt_mask = np.zeros((100, 100), bool)
    gt_mask[20:41, 30:51] = True  # gt box (30,20)-(50,40) inclusive
    out = tmt.intersect_box_mask([40, 30, 60, 50], [30, 20, 50, 40], gt_mask)
    assert out.shape == (21, 21)
    assert out[:11, :11].all()
    assert not out[11:, :].any() and not out[:, 11:].any()


def test_intersect_box_mask_disjoint():
    out = tmt.intersect_box_mask([0, 0, 10, 10], [50, 50, 60, 60],
                                 np.ones((100, 100), bool))
    assert out.shape == (21, 21) and not out.any()


def test_mask_overlap_identity_and_disjoint():
    box = [10, 10, 30, 30]
    mask = np.zeros((21, 21), bool)
    mask[5:15, 5:15] = True
    assert tmt.mask_overlap(box, box, mask, mask) == pytest.approx(1.0)
    assert tmt.mask_overlap(box, [100, 100, 120, 120], mask, mask) == 0.0
    m_full = np.ones((21, 21), bool)
    iou = tmt.mask_overlap([0, 0, 20, 20], [0, 10, 20, 30], m_full, m_full)
    assert iou == pytest.approx(11 * 21 / (2 * 441 - 11 * 21))


def test_mask_voc2coco_rle_paste():
    mask = np.ones((7, 7), np.float32)
    boxes = np.array([[10, 20, 29, 39, 0.9]], np.float32)
    rles = tmt.mask_voc2coco([mask], boxes, im_height=60, im_width=50)
    dec = rle_to_binary_mask(rles[0])
    assert dec.shape == (60, 50) and dec[20:40, 10:30].all()
    assert dec.sum() == 20 * 20
    boxes2 = np.array([[40, 50, 60, 70, 0.9]], np.float32)
    dec2 = rle_to_binary_mask(
        tmt.mask_voc2coco([mask], boxes2, im_height=60, im_width=50)[0])
    assert dec2[50:60, 40:50].all() and dec2.sum() == 100


def _box(rng, lo=0, hi=80):
    x1, y1 = rng.randint(lo, hi, 2)
    return [int(x1), int(y1), int(x1 + rng.randint(0, 30)),
            int(y1 + rng.randint(0, 30))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_cases_match_jax(seed):
    rng = np.random.RandomState(seed)
    image_mask = rng.rand(120, 120) > 0.5
    for _ in range(20):
        ex, gt = _box(rng), _box(rng)
        np.testing.assert_array_equal(
            tmt.intersect_box_mask(ex, gt, image_mask),
            jmt.intersect_box_mask(ex, gt, image_mask))
        b1, b2 = _box(rng), _box(rng)
        m1 = rng.rand(b1[3] - b1[1] + 1, b1[2] - b1[0] + 1) > 0.4
        m2 = rng.rand(b2[3] - b2[1] + 1, b2[2] - b2[0] + 1) > 0.4
        assert tmt.mask_overlap(b1, b2, m1, m2) == \
            jmt.mask_overlap(b1, b2, m1, m2)
    n = 6
    masks = [rng.rand(14, 14).astype(np.float32) for _ in range(n)]
    boxes = np.concatenate([rng.uniform(-20, 90, (n, 2)), np.zeros((n, 3))],
                           1)
    boxes[:, 2:4] = boxes[:, :2] + rng.uniform(2, 50, (n, 2))
    got = tmt.mask_voc2coco(masks, boxes, 80, 100, binary_thresh=0.45)
    want = jmt.mask_voc2coco(masks, boxes, 80, 100, binary_thresh=0.45)
    assert got == want and len(got) == n
