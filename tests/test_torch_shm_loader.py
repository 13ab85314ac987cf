"""The loader process (data/shm_loader.py, TRAIN.LOADER_PROCESS) and the
re-roll process pool (TRAIN.NUM_PROCESS > 1) against the in-process
ChipLoader, on the CPU: NumPy on both sides, so every array must be
identical.

- ProcessChipLoader gives ChipLoader's chip counts, lengths and batches bit
  for bit over two epochs (the chip stride re-rolled at each, negative
  chips mined from proposals); an epoch abandoned mid-way respawns the
  child; a child's exception re-raises in the parent with its traceback.
- A NUM_PROCESS 2 re-roll gives the serial re-roll's chips and batches.

This module imports neither jax nor the JAX package: the spawned children
import it to unpickle the injected image loaders.
"""

import copy
import pickle

import numpy as np
import pytest

from sniper_tpu_torch.config import default_config
from sniper_tpu_torch.data.loader import ChipLoader
from sniper_tpu_torch.data.roidb import load_rpn_proposals
from sniper_tpu_torch.data.shm_loader import ProcessChipLoader


def image_loader(path):
    """A deterministic uint8 BGR image for 'img<i>:<h>x<w>' (module level:
    the loader process unpickles it)."""
    i, hw = path.split(":")
    h, w = (int(v) for v in hw.split("x"))
    rng = np.random.RandomState(int(i.removeprefix("img")))
    return rng.randint(0, 255, (h, w, 3)).astype(np.uint8)


def failing_loader(path):
    raise OSError(f"cannot read {path}")


def make_cfg():
    cfg = default_config()
    cfg.TRAIN.SCALES = [(1400, 2000), (800, 1280), (-1, 256)]
    cfg.TRAIN.VALID_RANGES = [(-1, 80), (32, 150), (120, -1)]
    cfg.TRAIN.CHIP_SIZE = 256
    cfg.TRAIN.USE_NEG_CHIPS = True
    cfg.TRAIN.NUM_THREAD = 2
    cfg.TRAIN.CPP_CHIPS = False
    cfg.network.ANCHOR_SCALES = (2, 4, 7)
    cfg.network.ANCHOR_RATIOS = (0.5, 1, 2)
    cfg.network.NUM_ANCHORS = 9
    cfg.dataset.NUM_CLASSES = 5
    return cfg


@pytest.fixture(scope="module")
def roidb(tmp_path_factory):
    """Three images with small and large GT boxes and 400 proposals each,
    loaded as negative-chip candidates."""
    rng = np.random.RandomState(4)
    gt = []
    for i in range(3):
        w, h = (320, 240) if i % 2 == 0 else (240, 320)
        sizes = np.concatenate([rng.uniform(12, 30, 3),
                                rng.uniform(60, 150, 2)])
        x1, y1 = rng.uniform(0, w - sizes - 1), rng.uniform(0, h - sizes - 1)
        cls = rng.randint(1, 5, sizes.size)
        ov = np.zeros((sizes.size, 5), np.float32)
        ov[np.arange(sizes.size), cls] = 1.0
        gt.append({"image": f"img{i}:{h}x{w}", "width": w, "height": h,
                   "boxes": np.stack([x1, y1, x1 + sizes, y1 + sizes], 1)
                   .astype(np.float32),
                   "gt_classes": cls.astype(np.int32), "gt_overlaps": ov,
                   "max_overlaps": np.ones(sizes.size, np.float32),
                   "max_classes": cls, "flipped": False})
    props = []
    for r in gt:
        s = rng.uniform(10, 70, 400)
        x1 = rng.uniform(0, r["width"] - s - 1)
        y1 = rng.uniform(0, r["height"] - s - 1)
        props.append(np.stack([x1, y1, x1 + s, y1 + s, rng.rand(400)], 1)
                     .astype(np.float32))
    pkl = str(tmp_path_factory.mktemp("props") / "synth_rpn.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"boxes": props}, f)
    return load_rpn_proposals(pkl, gt, 5, use_cache=False)


def _batches(loader):
    return [{k: v.copy() for k, v in b.items()} for b in loader]


def _assert_same(a, b, what):
    assert len(a) == len(b) > 0, what
    for k, (x, y) in enumerate(zip(a, b)):
        assert x.keys() == y.keys()
        for key in x:
            np.testing.assert_array_equal(x[key], y[key],
                                          err_msg=f"{what} batch {k} {key}")


def test_process_loader_matches_chip_loader(roidb):
    cfg = make_cfg()
    ref = ChipLoader(copy.deepcopy(roidb), cfg, 2, image_loader=image_loader,
                     seed=3)
    proc = ProcessChipLoader(roidb, cfg, 2, seed=3, image_loader=image_loader)
    try:
        negs = 0
        for epoch in range(2):
            assert proc.reset() == ref.reset(), epoch
            assert len(proc) == len(ref) > 1
            negs += sum(len(r.get("neg_chips", [])) for r in ref.roidb)
            _assert_same(_batches(proc), _batches(ref), f"epoch {epoch}")
        assert negs > 0  # the epochs mined negative chips
        pid = proc.proc.pid
        # an epoch abandoned mid-way kills the child; the next call
        # respawns it and replays one reset
        it = iter(proc)
        next(it)
        it.close()
        assert not proc.proc.is_alive()
        assert proc.reset() > 0 and proc.proc.pid != pid
        assert len(_batches(proc)) == len(proc)
    finally:
        proc.close()
    assert not proc.proc.is_alive()


def test_cut_epochs_keep_the_child_and_its_rolls(roidb):
    """batches(limit) closes a cut epoch in the child: the same process
    serves three cut epochs, each the in-process loader's cut epoch."""
    cfg = make_cfg()
    ref = ChipLoader(copy.deepcopy(roidb), cfg, 2, image_loader=image_loader,
                     seed=4)
    proc = ProcessChipLoader(roidb, cfg, 2, seed=4, image_loader=image_loader)
    try:
        pid = None
        for epoch in range(3):
            assert proc.reset() == ref.reset(), epoch
            assert len(proc) == len(ref) > 1
            got = [{k: v.copy() for k, v in b.items()}
                   for b in proc.batches(1)]
            _assert_same(got, list(ref.batches(1)), f"epoch {epoch}")
            assert len(got) == 1
            pid = pid or proc.proc.pid
            assert proc.proc.is_alive() and proc.proc.pid == pid, epoch
    finally:
        proc.close()


def test_child_error_reraises_in_parent(roidb):
    proc = ProcessChipLoader(roidb, make_cfg(), 2, image_loader=failing_loader)
    try:
        proc.reset()
        with pytest.raises(RuntimeError, match="OSError: cannot read img"):
            list(proc)
    finally:
        proc.close()
    proc.proc.join(timeout=10)
    assert not proc.proc.is_alive()


def test_reroll_pool_matches_serial(roidb):
    cfg = make_cfg()
    cfg.TRAIN.NUM_THREAD = 1
    serial = ChipLoader(copy.deepcopy(roidb), cfg, 2,
                        image_loader=image_loader, seed=5)
    cfg2 = copy.deepcopy(cfg)
    cfg2.TRAIN.NUM_PROCESS = 2
    pooled = ChipLoader(copy.deepcopy(roidb), cfg2, 2,
                        image_loader=image_loader, seed=5)
    try:
        for epoch in range(2):
            assert pooled.reset() == serial.reset()
            pool = pooled._reroll_pool
            assert pool is not None
            assert pooled.schedule == serial.schedule
            for a, b in zip(pooled.roidb, serial.roidb):
                assert [(tuple(c.box), c.im_scale) for c in a["crops"]] == \
                    [(tuple(c.box), c.im_scale) for c in b["crops"]]
                for x, y in zip(a["props_in_chips"], b["props_in_chips"]):
                    np.testing.assert_array_equal(x, y)
            _assert_same(_batches(pooled)[:2], _batches(serial)[:2],
                         f"epoch {epoch}")
        assert pooled._reroll_pool is pool  # one pool across epochs
    finally:
        pooled.close()
    assert pooled._reroll_pool is None


def test_process_loader_carries_gt_masks(roidb):
    """TRAIN.WITH_MASK: the uint8 gt_masks cross the shared memory
    unchanged (dtype, shape and bytes), beside the other arrays."""
    rng = np.random.RandomState(6)
    masked = copy.deepcopy(roidb)
    for r in masked:
        polys = []
        for x1, y1, x2, y2 in r["boxes"]:
            t = np.sort(rng.uniform(0, 2 * np.pi, 10))
            polys.append([np.stack(
                [(x1 + x2) / 2 + (x2 - x1) / 2 * np.cos(t),
                 (y1 + y2) / 2 + (y2 - y1) / 2 * np.sin(t)], 1).reshape(-1)])
        r["gt_masks"] = polys
    cfg = make_cfg()
    cfg.TRAIN.WITH_MASK = True
    cfg.TRAIN.MAX_GT_BOXES = 12
    ref = ChipLoader(copy.deepcopy(masked), cfg, 2,
                     image_loader=image_loader, seed=1)
    proc = ProcessChipLoader(masked, cfg, 2, seed=1,
                             image_loader=image_loader)
    try:
        assert proc.reset() == ref.reset()
        got = _batches(proc)
        _assert_same(got, _batches(ref), "with masks")
    finally:
        proc.close()
    assert all(b["gt_masks"].dtype == np.uint8
               and b["gt_masks"].shape == (2, 12, 112, 112) for b in got)
    assert any(b["gt_masks"].any() for b in got)


def test_process_loader_carries_scale_label(roidb):
    """TRAIN.AUTO_FOCUS: each chip's FocusPixel labels (scale_label, [H*W]
    float32 in {-1, 0, 1}) cross the shared memory unchanged, beside the
    other arrays, over flipped and unflipped images."""
    from sniper_tpu_torch.data.roidb import append_flipped_images

    cfg = make_cfg()
    cfg.TRAIN.AUTO_FOCUS = True
    cfg.TRAIN.AUTO_FOCUS_SMALL_THRESH = 64
    cfg.TRAIN.AUTO_FOCUS_DC_LOW = 5
    cfg.TRAIN.AUTO_FOCUS_DC_HIGH = 90
    flipped = append_flipped_images(copy.deepcopy(roidb))
    ref = ChipLoader(copy.deepcopy(flipped), cfg, 2,
                     image_loader=image_loader, seed=2)
    proc = ProcessChipLoader(flipped, cfg, 2, seed=2,
                             image_loader=image_loader)
    try:
        assert proc.reset() == ref.reset()
        got = _batches(proc)
        _assert_same(got, _batches(ref), "with scale_label")
    finally:
        proc.close()
    side = cfg.TRAIN.CHIP_SIZE // 16
    labels = np.concatenate([b["scale_label"] for b in got])
    assert labels.dtype == np.float32 and labels.shape[1] == side * side
    assert set(np.unique(labels)) == {-1.0, 0.0, 1.0}
