"""Generate the fixture that holds the port's AutoFocus inference against the
JAX package's.

The JAX CLI's ``run_detection`` (main_test.py) runs a tiny detector with
the FocusPixel head coarse to fine over three small scales of three
synthetic 320x256 images: per scale, the chips' FocusPixel maps become the
next scale's FocusChips (``sniper_tpu.chips.autofocus.add_chips``), which
the test iterator bins into its canvas tiers. Twice: the box detector, and
the same detector with the mask branch.

The tiny detector's random FocusPixel head gives maps within a hair of 0.5.
Its output layer is scaled by FOCUS_GAIN so the maps spread over (0, 1),
and each scale's threshold (CHIP_HYPERPARAMS) is set, just before
``add_chips`` reads it, to the middle of the widest gap between the
scale's map values between their MIN_Q and MAX_Q quantiles: so every map
value lies at least the recorded margin from the threshold, and a 1e-6
difference between the two frameworks' maps cannot move a pixel across it.

The fixture keeps each scale's thresholds and margins, the
``inference_crops`` every scale ran on, and the aggregated detections (with
masks, each kept mask's mean and maximum). tests/test_torch_autofocus_
pipeline.py runs the port's ``run_detection`` with the same variables,
images and thresholds and compares. The JAX runs compile one program per
canvas tier and take a few minutes, which is why they are frozen.
Regenerate (only after an intentional change of the semantics):
    python scripts/gen_torch_autofocus_golden.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

# generation runs under the test suite's environment (tests/conftest.py)
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
import jax  # noqa: E402

if jax.config.jax_platforms and \
        jax.config.jax_platforms.split(",")[0] != "cpu":
    jax.config.update("jax_platforms", "cpu")

FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                       "torch_autofocus_golden.json")
IM_W, IM_H, N_IMAGES = 320, 256, 3
INIT_KEY = 7
FOCUS_GAIN = 2.0
MIN_Q, MAX_Q = 0.75, 0.92


def synth_loader(name):
    """A deterministic BGR 'photo' for roidb entry 'im<i>': noise and
    bright blocks."""
    rng = np.random.RandomState(3000 + int(name.removeprefix("im")))
    im = rng.randint(40, 200, (IM_H, IM_W, 3), np.uint8)
    for _ in range(4):
        x, y = rng.randint(0, IM_W - 90), rng.randint(0, IM_H - 70)
        im[y:y + rng.randint(20, 70), x:x + rng.randint(20, 90)] = (
            rng.randint(0, 255, 3, np.uint8))
    return im


def roidb():
    return [{"image": f"im{i}", "width": IM_W, "height": IM_H,
             "flipped": False} for i in range(N_IMAGES)]


def configure(cfg, thresholds=None):
    """The AutoFocus yml's test settings, cut to three small scales (coarse
    to fine), on ``cfg`` (either package's config tree)."""
    cfg.TEST.SCALES = [(96, 128), (160, 256), (256, 384)]
    cfg.TEST.BATCH_IMAGES = [2, 2, 2]
    cfg.TEST.VALID_RANGES = [(60, -1), (24, 120), (-1, 60)]
    cfg.TEST.AUTO_FOCUS = True
    cfg.TEST.DO_PRUNING = [False, True, True]
    thr = thresholds or (0.5, 0.5)
    cfg.TEST.CHIP_HYPERPARAMS = [[3, thr[0], 3], [3, thr[1], 4],
                                 [-1, -1, -1]]
    cfg.TEST.USE_CACHE = [False, False, False]
    cfg.TEST.NMS = -1
    cfg.TEST.NMS_SIGMA = 0.55
    cfg.TEST.MAX_PER_IMAGE = 12
    cfg.network.PIXEL_MEANS = [103.939, 116.779, 123.68]
    return cfg


def variables(mask=False):
    """The JAX model and the tiny detector's flax variables
    (tests/torch_port.py) with the FocusPixel head, its output layer scaled
    by FOCUS_GAIN; with ``mask``, the mask branch's parameters added from a
    seeded NumPy draw (He-scaled convs, so the masks vary; the 14x14 pool's
    offset FC at zero, as flax inits it), which spares the flax init of the
    mask model."""
    import jax.numpy as jnp

    from sniper_tpu.models.detector import SNIPERDetector
    from torch_port import TINY, tiny_jax_detector, tiny_torch_detector

    model, v = tiny_jax_detector(INIT_KEY, autofocus=True)
    out = v["params"]["autofocus"]["conv_new_out"]
    out["kernel"] = out["kernel"] * FOCUS_GAIN
    if not mask:
        return model, v
    rng = np.random.RandomState(INIT_KEY)
    params = dict(v["params"])
    port = tiny_torch_detector(autofocus=True, with_mask=True)
    for key, t in port.state_dict().items():
        mod, leaf = key.rsplit(".", 1)
        if not mod.startswith("mask"):
            continue
        shape = tuple(t.shape)
        if leaf == "weight" and len(shape) == 4:  # OIHW, deconv IOHW
            shape = ((shape[2], shape[3], shape[0], shape[1])
                     if mod == "mask.mask_deconv"
                     else (shape[2], shape[3], shape[1], shape[0]))
        elif leaf == "weight":
            shape = shape[::-1]
        if leaf == "bias" or mod == "mask_offset":
            value = np.zeros(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[:-1]))
            value = (rng.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(
                np.float32)
        node = params
        for part in mod.split("."):
            node[part] = dict(node.get(part, {}))
            node = node[part]
        node["kernel" if leaf == "weight" else leaf] = value
    model = SNIPERDetector(**dict(TINY, dtype=jnp.float32,
                                  num_rois=TINY["post_nms_top_n"],
                                  autofocus=True, with_mask=True))
    return model, {"params": params, "batch_stats": v["batch_stats"]}


def pick_threshold(maps):
    """(threshold, margin): the middle of the widest gap between the map
    values between the MIN_Q and MAX_Q quantiles, and half its width."""
    vals = np.unique(np.concatenate([m.reshape(-1) for row in maps
                                     for m in row if m is not None]))
    lo, hi = int(len(vals) * MIN_Q), int(len(vals) * MAX_Q)
    gaps = vals[lo + 1:hi + 1] - vals[lo:hi]
    k = int(np.argmax(gaps))
    return float((vals[lo + k] + vals[lo + k + 1]) / 2), float(gaps[k] / 2)


class _Keep:
    """Dataset stand-in: hands back the aggregated detections (and
    masks)."""

    def __init__(self, num_classes, masks):
        self.num_classes = num_classes
        if masks:
            self.evaluate_segmentations = lambda m, r: m

    def evaluate_detections(self, all_boxes, roidb):
        return all_boxes


def run_jax(mask=False):
    import main_test as jmain
    from sniper_tpu.chips import autofocus as jaf
    from sniper_tpu.config import default_config
    from sniper_tpu.data import test_loader as jtl
    from torch_port import TINY

    model, v = variables(mask)
    cfg = configure(default_config())
    crops = [[r["inference_crops"].tolist()
              for r in jtl.init_inference_crops(roidb())]]
    thresholds, margins = [], []
    real = jaf.add_chips

    def add_chips(rdb, maps, s, cfg_):
        thr, margin = pick_threshold(maps)
        cfg_.TEST.CHIP_HYPERPARAMS[s][1] = thr
        thresholds.append(thr)
        margins.append(margin)
        out = real(rdb, maps, s, cfg_)
        crops.append([np.asarray(r["inference_crops"]).tolist()
                      for r in rdb])
        return out

    jaf.add_chips = add_chips
    defaults = jtl.TestChipIterator.__init__.__defaults__
    jtl.TestChipIterator.__init__.__defaults__ = (synth_loader, None)
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            stats = jmain.run_detection(
                cfg, model, v, roidb(), _Keep(TINY["num_classes"], mask),
                out_dir)
    finally:
        jaf.add_chips = real
        jtl.TestChipIterator.__init__.__defaults__ = defaults
    final = stats["bbox"] if mask else stats
    out = {"thresholds": thresholds, "margins": margins, "crops": crops,
           "dets": [[np.asarray(final[c][i], np.float32).tolist()
                     for i in range(N_IMAGES)]
                    for c in range(TINY["num_classes"])]}
    if mask:
        out["mask_stats"] = [[
            np.stack([m.reshape(len(m), -1).mean(1), m.reshape(
                len(m), -1).max(1)], 1).tolist() if len(m) else []
            for _, m in stats["segm"][c]] if c else []
            for c in range(TINY["num_classes"])]
    n = sum(len(d) for row in out["dets"] for d in row)
    print(f"{'mask+' if mask else ''}autofocus: thresholds {thresholds}, "
          f"margins {margins}, chips per scale "
          f"{[sum(len(c) for c in s) for s in crops]}, {n} detections")
    return out


def main():
    fixture = {"box": run_jax(False), "mask": run_jax(True)}
    with open(FIXTURE, "w") as f:
        json.dump(fixture, f)
        f.write("\n")
    print(f"wrote {FIXTURE}")


if __name__ == "__main__":
    main()
