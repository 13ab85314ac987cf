"""The AutoFocus modules of the port against the JAX package's, on the CPU.

- ``AutoFocusHead`` through convert against flax's, and a tiny detector's
  ``focus_prob`` against the JAX forward on converted weights (fp32:
  within 1e-5, the convolutions summing in another order);
- ``gmask`` and ``add_chips`` against the JAX copy on seeded random maps,
  thresholds, dilations and minimum sizes, [-1, hi] coarse specs among
  them: identical chip lists, bit for bit (the same NumPy, SciPy and
  Python arithmetic on both sides);
- the FocusPixel labels (``_focus_map``) and a ``ChipLoader`` epoch's
  ``scale_label`` with TRAIN.AUTO_FOCUS against the JAX assigner and
  loader, flipped images included: bit for bit;
- ``focus_loss`` and ``total_loss`` against JAX (within 1e-6 relative):
  the focus term when the outputs have ``focus_logits`` and the batch
  ``scale_label`` (JAX ``with_autofocus=True``), none without the label
  (a head that only TEST.AUTO_FOCUS asked for: JAX
  ``with_autofocus=False``);
- the FocusPixel head's init and its MXNet import against the JAX import;
- ``TestChipIterator`` over several FocusChips per image, spread over the
  canvas tiers, against the JAX iterator, batch for batch;
- three training steps of the tiny detector with the FocusPixel head
  against tests/fixtures/torch_train_autofocus_golden.json
  (``scripts/gen_torch_train_golden.py --autofocus``), with focus_loss
  among the losses, under test_torch_train_step's tolerances.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sniper_tpu.chips import autofocus as jaf
from sniper_tpu.config import default_config as jax_default_config
from sniper_tpu.data import anchor_targets as jat
from sniper_tpu.data import test_loader as jtl
from sniper_tpu.models import losses as jlosses
from sniper_tpu_torch.chips import autofocus as taf
from sniper_tpu_torch.config import default_config
from sniper_tpu_torch.data import anchor_targets as tat
from sniper_tpu_torch.data import test_loader as ttl
from sniper_tpu_torch.models import losses as tlosses
from test_torch_train_step import check_three_steps
from torch_port import (
    close_to_scale,
    synth_image_loader,
    tiny_jax_detector,
    tiny_torch_detector,
)


def test_autofocus_head_matches_flax(rng):
    from sniper_tpu.models.heads import AutoFocusHead as JHead
    from sniper_tpu_torch.convert import flax_to_torch
    from sniper_tpu_torch.models.heads import AutoFocusHead

    feat = rng.randn(2, 6, 7, 24).astype(np.float32)
    head = JHead(dtype=jnp.float32)
    params = head.init({"params": __import__("jax").random.PRNGKey(1)},
                       jnp.asarray(feat))["params"]
    want = np.asarray(head.apply({"params": params}, jnp.asarray(feat)))
    port = AutoFocusHead(24)
    port.load_state_dict({
        f"{name}.{'weight' if leaf == 'kernel' else leaf}": torch.tensor(
            flax_to_torch(np.asarray(v), leaf).copy())
        for name, layer in params.items() for leaf, v in layer.items()})
    with torch.no_grad():
        got = port(torch.from_numpy(feat).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32 and got.shape == (2, 6, 7, 2)
    close_to_scale(got.numpy(), want, rtol=1e-5)


def test_detector_focus_prob_matches_jax(rng):
    """A tiny detector with the FocusPixel head on converted weights: the
    boxes' outputs as without it, focus_prob [B,H,W] within 1e-5; the
    RPN-only detector has no head."""
    jmodel, variables = tiny_jax_detector(0, autofocus=True)
    model = tiny_torch_detector(variables, autofocus=True)
    data = rng.randn(2, 64, 96, 3).astype(np.float32) * 50
    info = np.array([[64, 96, 1.0], [60, 80, 1.0]], np.float32)
    want = jmodel.apply(variables, jnp.asarray(data), jnp.asarray(info),
                        train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(data), torch.from_numpy(info))
    assert got["focus_prob"].shape == (2, 4, 6)
    np.testing.assert_allclose(got["focus_prob"].numpy(),
                               np.asarray(want["focus_prob"]), rtol=0,
                               atol=1e-5)
    close_to_scale(got["cls_prob"], want["cls_prob"])
    rpn = tiny_torch_detector(autofocus=True, rpn_only=True)
    assert not rpn.with_autofocus
    assert {n for n, _ in rpn.named_children()} == {"trunk", "rpn"}


def _random_map(rng, fh, fw):
    """Sparse blobs on low noise: some cells above every threshold used."""
    m = rng.rand(fh, fw).astype(np.float32) * 0.3
    for _ in range(rng.randint(1, 5)):
        y, x = rng.randint(0, fh), rng.randint(0, fw)
        m[y:y + rng.randint(1, 4), x:x + rng.randint(1, 5)] = rng.uniform(
            0.3, 1.0)
    return m


# (map h, w, dilation, threshold, min size in cells, image w, h, scale)
GMASK_CASES = [
    (30, 40, 3, 0.2, 8, 640, 480, 1.0),
    (30, 40, 2, 0.35, 4, 640, 480, 0.8),
    (12, 15, 1, 0.5, 4, 240, 192, 0.25),
    (24, 32, 3, 0.02, 16, 500, 375, 0.768),  # min size above the map
    (8, 33, 2, 0.4, 3, 520, 120, 1.5),
    (20, 20, -1, 0.3, 5, 311, 299, 1.0),  # no dilation
]


@pytest.mark.parametrize("case", range(len(GMASK_CASES)))
def test_gmask_matches_jax(case):
    fh, fw, d, thr, ms, iw, ih, cs = GMASK_CASES[case]
    rng = np.random.RandomState(100 + case)
    for _ in range(4):
        m = _random_map(rng, fh, fw)
        kw = dict(thresh_value=thr, ms=ms, im_width=iw, im_height=ih,
                  cscale=cs)
        want = jaf.gmask(m, d, **kw)
        got = taf.gmask(m, d, **kw)
        assert got == want
        assert all(type(v) is type(w) for g, x in zip(got, want)
                   for v, w in zip(g, x))


# (test scales, chip hyperparameters, image sizes)
ADD_CHIPS_CASES = [
    ([(480, 512), (800, 1280), (1400, 2000)],
     [(3, 0.2, 16), (3, 0.3, 20), (-1, -1, -1)], [(640, 480), (480, 640)]),
    ([(-1, 240), (-1, 768)], [(2, 0.35, 4), (-1, -1, -1)],
     [(960, 768), (500, 375)]),
    ([(-1, 512), (800, 1280)], [(3, 0.25, 6), (-1, -1, -1)],
     [(640, 427), (333, 500)]),
]


@pytest.mark.parametrize("case", range(len(ADD_CHIPS_CASES)))
def test_add_chips_matches_jax(case, capsys):
    """Per image several current chips (one without a map), each with its
    map over the chip's extent at stride 16, through the coarse-to-fine
    scales: the same FocusChips and areas at every scale."""
    scales, hyper, sizes = ADD_CHIPS_CASES[case]
    rng = np.random.RandomState(200 + case)
    cfgs = []
    for make in (jax_default_config, default_config):
        cfg = make()
        cfg.TEST.SCALES = scales
        cfg.TEST.CHIP_HYPERPARAMS = hyper
        cfgs.append(cfg)
    roidb = [{"width": w, "height": h,
              "inference_crops": np.array([[0.0, 0, w, h]])}
             for w, h in sizes]
    roidbs = [copy.deepcopy(roidb), copy.deepcopy(roidb)]
    for s in range(len(scales) - 1):
        maps = []
        for r in roidbs[0]:
            sc = ttl.scale_for_image(r["width"], r["height"], scales[s])
            row = []
            for j, c in enumerate(r["inference_crops"]):
                fh = int(np.ceil((c[3] - c[1]) * sc / 16))
                fw = int(np.ceil((c[2] - c[0]) * sc / 16))
                row.append(None if j == 1 else
                           _random_map(rng, max(fh, 1), max(fw, 1)))
            maps.append(row)
        want = jaf.add_chips(roidbs[0], maps, s, cfgs[0])
        got = taf.add_chips(roidbs[1], maps, s, cfgs[1])
        assert got == want
        for a, b in zip(roidbs[1], roidbs[0]):
            np.testing.assert_array_equal(a["inference_crops"],
                                          b["inference_crops"])
        out = capsys.readouterr().out.splitlines()
        assert out[0] == out[1] and out[0].startswith(
            "Percent of pixels to be processed: ")
    assert any(len(r["inference_crops"]) > 1 for r in roidbs[1]) or \
        len(scales) == 2


def _gt_boxes(rng, n, span):
    """GT boxes of every FocusPixel class: tiny (under dc_low and under
    the 10 px min size), small, medium, large, and some past the chip."""
    side = np.concatenate([rng.uniform(2, 6, 2), rng.uniform(8, 60, n),
                           rng.uniform(60, 120, 3), rng.uniform(120, 300, 2)])
    x1 = rng.uniform(-40, span, side.size)
    y1 = rng.uniform(-40, span, side.size)
    asp = rng.uniform(0.5, 2.0, side.size)
    return np.stack([x1, y1, x1 + side * asp, y1 + side / asp],
                    1).astype(np.float32)


def test_focus_map_matches_jax(rng):
    """The assigner with AutoFocusParams: every target, the FocusPixel
    labels among them, identical to the JAX assigner's sparse form on
    chips at several scales and offsets."""
    af = (64, 5, 90)
    kw = dict(chip_size=256, anchor_scales=(2, 4, 7), rpn_batch_size=64)
    jas = jat.AnchorTargetAssigner(
        **kw, autofocus=jat.AutoFocusParams(*af), sparse=True)
    tas = tat.AnchorTargetAssigner(**kw, autofocus=tat.AutoFocusParams(*af))
    for k in range(6):
        boxes = _gt_boxes(rng, 8, 300)
        gtids = np.arange(len(boxes))
        nids = np.sort(rng.choice(gtids, len(gtids) // 2, replace=False))
        classes = rng.randint(1, 5, len(boxes))
        crop = np.array([rng.uniform(0, 80), rng.uniform(0, 80), 0, 0])
        crop[2:] = crop[:2] + 256 / (0.5 + 0.25 * k)
        args = (crop, 0.5 + 0.25 * k, nids, gtids, boxes, classes)
        want = jas(*args, np.random.RandomState(k))
        got = tas(*args, np.random.RandomState(k))
        for name in ("gt_boxes", "rpn_pids", "rpn_label_vals", "fg_pids",
                     "fg_targets", "gt_keep", "focus_label"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name),
                                          err_msg=f"chip {k} {name}")
        assert got.focus_label.dtype == np.float32
        assert got.focus_label.shape == (16 * 16,)
    # the order of painting: a later box overwrites an earlier one
    over = np.array([[0, 0, 40, 40], [0, 0, 80, 80]], np.float64)
    for a in (tas, jas):
        m = a._focus_map(over).reshape(16, 16)
        assert m[0, 0] == -1.0 and m[5, 5] == -1.0
        m = a._focus_map(over[::-1]).reshape(16, 16)
        assert m[0, 0] == 1.0 and m[5, 5] == -1.0


def _loader_roidb(rng, n_images=3):
    roidb = []
    for i in range(n_images):
        w, h = (480, 360) if i % 2 == 0 else (360, 480)
        boxes = _gt_boxes(rng, 5, min(w, h) - 140)
        boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]], 0, w - 1)
        boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]], 0, h - 1)
        boxes = boxes[(boxes[:, 2] - boxes[:, 0] > 1)
                      & (boxes[:, 3] - boxes[:, 1] > 1)]
        cls = rng.randint(1, 5, len(boxes))
        ov = np.zeros((len(boxes), 5), np.float32)
        ov[np.arange(len(boxes)), cls] = 1.0
        roidb.append({"image": f"img{i}:{h}x{w}", "width": w, "height": h,
                      "boxes": boxes, "gt_classes": cls.astype(np.int32),
                      "gt_overlaps": ov,
                      "max_overlaps": np.ones(len(boxes), np.float32),
                      "max_classes": cls, "flipped": False})
    return roidb


def test_chip_loader_scale_label_matches_jax(rng):
    """A ChipLoader epoch with TRAIN.AUTO_FOCUS (the AutoFocus yml's
    thresholds), flipped images included: the same batches as the JAX
    loader's, scale_label among them, array for array."""
    from sniper_tpu.data import roidb as jroidb
    from sniper_tpu.data.loader import ChipLoader as JChipLoader
    from sniper_tpu_torch.data import roidb as troidb
    from sniper_tpu_torch.data.loader import ChipLoader

    gt = _loader_roidb(rng)
    loaders = []
    for make, mod, cls in ((jax_default_config, jroidb, JChipLoader),
                           (default_config, troidb, ChipLoader)):
        cfg = make()
        cfg.TRAIN.SCALES = [(1400, 2000), (800, 1280), (-1, 256)]
        cfg.TRAIN.VALID_RANGES = [(-1, 80), (32, 150), (120, -1)]
        cfg.TRAIN.CHIP_SIZE = 256
        cfg.TRAIN.USE_NEG_CHIPS = False
        cfg.TRAIN.CPP_CHIPS = False
        cfg.TRAIN.NUM_THREAD = 2
        cfg.TRAIN.AUTO_FOCUS = True
        cfg.TRAIN.AUTO_FOCUS_SMALL_THRESH = 64
        cfg.TRAIN.AUTO_FOCUS_DC_LOW = 5
        cfg.TRAIN.AUTO_FOCUS_DC_HIGH = 90
        cfg.network.ANCHOR_SCALES = (2, 4, 7)
        cfg.network.NUM_ANCHORS = 9
        cfg.dataset.NUM_CLASSES = 5
        r = mod.append_flipped_images(copy.deepcopy(gt))
        loaders.append(cls(r, cfg, 2, image_loader=synth_image_loader,
                           seed=3))
    jl, tl = loaders
    assert tl.reset() == jl.reset() > 0
    n_labels = 0
    for k, (a, b) in enumerate(zip(tl, jl)):
        assert a.keys() == b.keys() and "scale_label" in a
        for key in a:
            np.testing.assert_array_equal(a[key], np.asarray(b[key]),
                                          err_msg=f"batch {k} {key}")
        n_labels += int((a["scale_label"] != 0).sum())
        assert a["scale_label"].shape == (2, 16 * 16)
    assert k + 1 == len(tl) and n_labels > 0
    assert any(r["flipped"] for r in tl.roidb)


@pytest.mark.parametrize("with_label", [True, False])
def test_focus_and_total_loss_match_jax(rng, with_label):
    logits = (rng.randn(3, 5, 6, 2) * 2).astype(np.float32)
    labels = rng.choice([-1.0, 0.0, 1.0], (3, 30)).astype(np.float32)
    labels[1] = -1.0  # a chip with nothing to learn
    want = jlosses.focus_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = tlosses.focus_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

    # total_loss on outputs with focus_logits against the JAX loss with
    # with_autofocus=with_label; the batch carries scale_label only then
    B, R, C, A, H, W = 3, 8, 5, 3, 5, 6
    out = {"rpn_cls_logits": rng.randn(B, H, W, 2, A),
           "rpn_bbox_pred": rng.randn(B, 4 * A, H, W),
           "cls_score": rng.randn(B, R, C),
           "rcnn_labels": rng.randint(-1, C, (B, R)),
           "bbox_pred": rng.randn(B, R, 4),
           "rcnn_bbox_targets": rng.randn(B, R, 4),
           "rcnn_bbox_weights": (rng.rand(B, R, 4) > 0.5) * 1.0,
           "focus_logits": logits}
    batch = {"rpn_pids": rng.randint(-1, A * H * W, (B, 16)),
             "rpn_label_vals": rng.choice([0.0, 1.0], (B, 16)),
             "fg_pids": rng.randint(-1, A * H * W, (B, 4)),
             "fg_targets": rng.randn(B, 4, 4)}
    if with_label:
        batch["scale_label"] = labels
    j_in = [{k: jnp.asarray(np.asarray(v, np.int32 if k.endswith(
        ("pids", "labels")) else np.float32)) for k, v in d.items()}
        for d in (out, batch)]
    t_in = [{k: torch.from_numpy(np.asarray(v, np.int32 if k.endswith(
        ("pids", "labels")) else np.float32)) for k, v in d.items()}
        for d in (out, batch)]
    _, want = jlosses.total_loss(*j_in, B, 16, with_autofocus=with_label)
    _, got = tlosses.total_loss(*t_in, B, 16)
    assert set(got) == set(want)
    assert ("focus_loss" in got) == with_label
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)


def test_init_detector_autofocus_layers_follow_the_flax_init():
    """models/init.py gives the FocusPixel head normal(0.01) weights and
    zero biases, as flax's init_n01 does."""
    from sniper_tpu_torch.models.init import init_detector

    m = init_detector(tiny_torch_detector(autofocus=True),
                      seed=1).requires_grad_(False)
    for layer in m.autofocus.children():
        assert abs(float(layer.weight.std()) / 0.01 - 1) < 0.1, layer
        assert float(layer.bias.abs().max()) == 0.0


def test_autofocus_mxnet_import_matches_jax(rng):
    """An MXNet .params with conv_new_2_weight and the like: the port's
    import fills the FocusPixel head as convert of the JAX import does."""
    from sniper_tpu.train import pretrained as jpre
    from sniper_tpu_torch.convert import convert
    from sniper_tpu_torch.train import pretrained as tpre

    _, variables = tiny_jax_detector(4, autofocus=True)
    port = tiny_torch_detector(variables, autofocus=True)
    rows = dict(tpre.mapping_rows(port))
    for name in ("conv_new_2", "conv_new_3", "conv_new_out"):
        for leaf in ("weight", "bias"):
            assert rows[f"autofocus.{name}.{leaf}"] == f"{name}_{leaf}"
    state = port.state_dict()
    flat = {mx: (rng.randn(*state[key].shape) * 0.1).astype(np.float32)
            for key, mx in rows.items()
            if key.startswith(("autofocus.", "rpn."))}
    jvars, _ = jpre.import_reference_params(flat, variables)
    tstate, trep = tpre.import_reference_params(flat, port)
    want = convert(jvars, port)
    for key in want:
        np.testing.assert_array_equal(tstate[key].numpy(), want[key].numpy(),
                                      err_msg=key)
    assert {mx for _, mx in trep.loaded} == set(flat)


def test_test_chip_iterator_over_focus_chips_matches_jax():
    """Several FocusChips per image of both orientations, binned into the
    tiers of the AutoFocus yml's finer scales: the same batches, canvas
    for canvas, as the JAX iterator's."""
    chips = {
        (640, 480): [[0, 0, 640, 480], [10.5, 20.25, 170.5, 180.25],
                     [300, 100, 620, 420], [0, 240, 320, 480],
                     [400.75, 0, 639.5, 90]],
        (480, 640): [[0, 0, 480, 640], [50, 60, 210, 620],
                     [100, 100, 260, 260]],
    }
    roidb = [{"image": f"img{i}:{h}x{w}", "width": w, "height": h,
              "flipped": i == 2,
              "inference_crops": np.array(chips[(w, h)], np.float64)}
             for i, (w, h) in enumerate([(640, 480), (480, 640),
                                         (640, 480)])]
    hw_seen = set()
    for s, spec in enumerate([(800, 1280), (1400, 2000)]):
        cfgs = []
        for make in (jax_default_config, default_config):
            cfg = make()
            cfg.TEST.SCALES = [(480, 512), (800, 1280), (1400, 2000)]
            cfgs.append(cfg)
        jit = jtl.TestChipIterator(roidb, cfgs[0], s + 1, 2,
                                   image_loader=synth_image_loader)
        tit = ttl.TestChipIterator(roidb, cfgs[1], s + 1, 2,
                                   image_loader=synth_image_loader)
        assert len(tit) == len(jit)
        for k, (a, b) in enumerate(zip(tit, jit)):
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key],
                                              err_msg=f"{spec} {k} {key}")
            hw_seen.add((s, a["data"].shape[1:3]))
        assert k + 1 == len(tit)
    # both finer scales bin the chips into more than one tier
    assert len({hw for s, hw in hw_seen if s == 0}) > 1
    assert len({hw for s, hw in hw_seen if s == 1}) > 1


def test_three_autofocus_train_steps_match_jax():
    check_three_steps(mask=False, autofocus=True)
