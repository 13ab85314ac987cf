"""The port's chip loader and roidb building against the JAX package's, on
the CPU: NumPy code on both sides, so every array must be identical.

The synthetic roidb has GT boxes across the three training scales' valid
ranges and RPN proposals loaded from a pickle (load_rpn_proposals), so the
epoch mines negative chips. Both loaders get the same roidb, config, seed
and injected image loader; two epochs (the chip stride is re-rolled at
each) must give the same chip counts and the same batches, array for
array, in the default uint8 + sparse-target form.
"""

import copy
import pickle

import numpy as np
import pytest

from sniper_tpu.config import default_config
from sniper_tpu.data import bbox_regression as jbr
from sniper_tpu.data import roidb as jroidb
from sniper_tpu.data.loader import ChipLoader as JChipLoader
from sniper_tpu_torch.data import bbox_regression as tbr
from sniper_tpu_torch.data import roidb as troidb
from sniper_tpu_torch.data.loader import ChipLoader
from torch_port import synth_image_loader


def make_gt_roidb(rng, n_images=3):
    roidb = []
    for i in range(n_images):
        w, h = (640, 480) if i % 2 == 0 else (480, 640)
        # small, medium and large GTs: each scale's valid range gets some
        sizes = np.concatenate([rng.uniform(12, 30, 3), rng.uniform(40, 90, 2),
                                rng.uniform(150, 300, 2)])
        n = len(sizes)
        x1 = rng.uniform(0, w - sizes - 1)
        y1 = rng.uniform(0, h - sizes - 1)
        boxes = np.stack([x1, y1, x1 + sizes, y1 + sizes], 1).astype(np.float32)
        classes = rng.randint(1, 5, n)
        overlaps = np.zeros((n, 5), np.float32)
        overlaps[np.arange(n), classes] = 1.0
        roidb.append({
            "image": f"img{i}:{h}x{w}", "width": w, "height": h,
            "boxes": boxes, "gt_classes": classes.astype(np.int32),
            "gt_overlaps": overlaps, "max_overlaps": np.ones(n, np.float32),
            "max_classes": classes, "flipped": False,
        })
    return roidb


def make_cfg():
    cfg = default_config()
    cfg.TRAIN.SCALES = [(1400, 2000), (800, 1280), (-1, 512)]
    cfg.TRAIN.VALID_RANGES = [(-1, 80), (32, 150), (120, -1)]
    cfg.TRAIN.USE_NEG_CHIPS = True
    cfg.TRAIN.NUM_THREAD = 4
    cfg.network.ANCHOR_SCALES = (2, 4, 7, 10, 13, 16, 24)
    cfg.network.ANCHOR_RATIOS = (0.5, 1, 2)
    cfg.network.NUM_ANCHORS = 21
    cfg.dataset.NUM_CLASSES = 5
    return cfg


@pytest.fixture(scope="module")
def roidbs(tmp_path_factory):
    """(port roidb, JAX roidb), each built by its own package's functions
    from the same GT roidb and proposal pickle."""
    rng = np.random.RandomState(5)
    gt = make_gt_roidb(rng)
    props = []
    for r in gt:
        n = 60
        x1 = rng.uniform(0, r["width"] - 60, n)
        y1 = rng.uniform(0, r["height"] - 60, n)
        s = rng.uniform(16, 200, n)
        props.append(np.stack([x1, y1, np.minimum(x1 + s, r["width"] - 1),
                               np.minimum(y1 + s, r["height"] - 1),
                               rng.rand(n)], 1).astype(np.float32))
    pkl = tmp_path_factory.mktemp("props") / "rpn.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"boxes": props}, f)
    cfg = make_cfg()
    out = []
    for mod, br in ((troidb, tbr), (jroidb, jbr)):
        r = mod.load_rpn_proposals(str(pkl), copy.deepcopy(gt), 5,
                                   use_cache=False)
        r = mod.append_flipped_images(r)
        r = mod.filter_roidb(r, 0.5, 0.5, 0.0)
        means, stds = br.add_bbox_regression_targets(r, cfg)
        out.append((r, means, stds))
    return out


def _assert_same(a, b, where):
    assert type(a) is type(b) or isinstance(a, np.ndarray), where
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=where)
    else:
        assert a == b, where


def test_roidb_building_matches_jax(roidbs):
    (tr, tmeans, tstds), (jr, jmeans, jstds) = roidbs
    assert len(tr) == len(jr) == 6  # flipped copies appended
    assert any((r["max_overlaps"] < 1).any() for r in tr)  # proposals
    np.testing.assert_array_equal(tmeans, jmeans)
    np.testing.assert_array_equal(tstds, jstds)
    for i, (a, b) in enumerate(zip(tr, jr)):
        _assert_same(a, b, f"roidb[{i}]")


@pytest.mark.parametrize("cpp_chips", [False, True])
def test_chip_loader_matches_jax(roidbs, cpp_chips):
    """cpp_chips: both packages' native set-cover loader (the NumPy
    set-cover where native/libsniper_chips.so is absent)."""
    (tr, _, _), (jr, _, _) = roidbs
    cfg = make_cfg()
    cfg.TRAIN.CPP_CHIPS = cpp_chips
    loaders = [cls(copy.deepcopy(r), cfg, 4, image_loader=synth_image_loader,
                   seed=3)
               for cls, r in ((ChipLoader, tr), (JChipLoader, jr))]
    negs = 0
    for epoch in range(2):
        n_t, n_j = (ld.reset() for ld in loaders)
        assert n_t == n_j > 0, epoch
        assert len(loaders[0]) == len(loaders[1])
        assert loaders[0].schedule == loaders[1].schedule
        negs += sum(len(r.get("neg_chips", [])) for r in loaders[0].roidb)
        for k, (a, b) in enumerate(zip(*loaders)):
            assert a.keys() == b.keys()
            assert a["data"].dtype == np.uint8 and "rpn_pids" in a
            for key in a:
                np.testing.assert_array_equal(
                    a[key], b[key], err_msg=f"epoch {epoch} batch {k} {key}")
    assert negs > 0  # the epochs mined negative chips


def add_polygons(roidb, rng):
    """Each GT gets an ellipse of 12 to 20 vertices inscribed in its box,
    every third one a second, triangular segment."""
    for r in roidb:
        polys = []
        for i, (x1, y1, x2, y2) in enumerate(r["boxes"]):
            t = np.arange(rng.randint(12, 21)) * 2 * np.pi
            t = t / len(t)
            cx, cy, ax, ay = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, \
                (y2 - y1) / 2
            segs = [np.stack([cx + ax * np.cos(t), cy + ay * np.sin(t)], 1)
                    .reshape(-1).tolist()]
            if i % 3 == 0:
                segs.append([x1, y1, cx, y1, x1, cy])
            polys.append(segs)
        r["gt_masks"] = polys
    return roidb


def test_chip_loader_with_masks_matches_jax():
    """TRAIN.WITH_MASK: the flipped roidb's polygons, then two epochs of
    batches, gt_masks [B, MAX_GT_BOXES, 112, 112] uint8 included, equal to
    the JAX loader's."""
    rng = np.random.RandomState(8)
    gt = add_polygons(make_gt_roidb(rng, n_images=2), rng)
    cfg = make_cfg()
    cfg.TRAIN.WITH_MASK = True
    cfg.TRAIN.USE_NEG_CHIPS = False
    cfg.TRAIN.MAX_GT_BOXES = 20
    built = []
    for mod, br in ((troidb, tbr), (jroidb, jbr)):
        r = mod.append_flipped_images(copy.deepcopy(gt))
        r = mod.filter_roidb(r, 0.5, 0.5, 0.0)
        br.add_bbox_regression_targets(r, cfg)
        built.append(r)
    for i, (a, b) in enumerate(zip(*built)):
        _assert_same(a, b, f"roidb[{i}]")
    loaders = [cls(r, cfg, 2, image_loader=synth_image_loader, seed=5)
               for cls, r in ((ChipLoader, built[0]), (JChipLoader, built[1]))]
    filled = 0
    for epoch in range(2):
        assert loaders[0].reset() == loaders[1].reset() > 0
        for k, (a, b) in enumerate(zip(*loaders)):
            assert a.keys() == b.keys()
            m = a["gt_masks"]
            assert m.dtype == np.uint8 and m.shape == (2, 20, 112, 112)
            filled += int((m.reshape(2, 20, -1).max(-1) > 0).sum())
            for key in a:
                np.testing.assert_array_equal(
                    a[key], b[key], err_msg=f"epoch {epoch} batch {k} {key}")
    assert filled > 0
