"""AutoFocus coarse-to-fine inference throughput on the card, against the
full pyramid over the same images.

Port of scripts/bench_autofocus.py. Each pass is one
``main_test.run_detection`` over N_IMAGES synthetic 640x480 images, the
program's own coarse-to-fine loop: the coarse scale's detection with the
FocusPixel head, ``add_chips`` turning its maps into the next scale's
FocusChips, the finer scales over their canvas tiers, chip-border pruning
and the aggregation's soft-NMS. A random head's maps carry no signal (they
sit near 0.5, above every threshold), so ``add_chips`` receives planted
maps instead: a centred binary blob over ``density`` of each chip's cells
(``planted_maps``). The head still runs at every scale, so its device cost
is paid. The full pyramid is the same config with TEST.AUTO_FOCUS off.

    python -m sniper_tpu_torch.bench_autofocus

prints one JSON object: img/s of the full pyramid and of each density,
and the percent of the finest scale's pixels that the FocusChips cover
(the reference's "percent of pixels processed"). sniper_tpu_torch.bench
reports the d=0.05 point as its autofocus_* keys.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

N_IMAGES = 32
IM_W, IM_H = 640, 480
AF_CONFIG = (Path(__file__).resolve().parents[1] / "configs"
             / "sniper_res101_e2e_autofocus.yml")


def synth_loader(name: str) -> np.ndarray:
    """Image ``im<i>``: uniform noise seeded by its index, made at every
    read (the bench's stand-in for a decode)."""
    rng = np.random.RandomState(int(name.removeprefix("im")))
    return rng.randint(0, 255, (IM_H, IM_W, 3), np.uint8)


def make_cfg():
    """The AutoFocus yml's model and scales coarse to fine, with the test
    settings of scripts/bench_autofocus.py:make_cfg: batches 8/8/4, map
    threshold 0.5 at both focus scales (planted maps are binary), NMS -1
    (soft-NMS, sigma 0.55), 200 detections per image, the aggregation in
    one thread."""
    from sniper_tpu_torch.config import load_config

    cfg = load_config(str(AF_CONFIG))
    t = cfg.TEST
    t.SCALES = [(480, 512), (800, 1280), (1400, 2000)]
    t.BATCH_IMAGES = [8, 8, 4]
    t.AUTO_FOCUS = True
    t.DO_PRUNING = [False, True, True]
    t.CHIP_HYPERPARAMS = [[3, 0.5, 16], [3, 0.5, 20], [-1, -1, -1]]
    t.VALID_RANGES = [(75, -1), (32, 180), (-1, 75)]
    t.NMS = -1
    t.NMS_SIGMA = 0.55
    t.MAX_PER_IMAGE = 200
    t.CONCURRENT_JOBS = 1
    t.USE_CACHE = [False, False, False]
    return cfg


def make_roidb(n: int) -> list:
    return [{"image": f"im{i}", "width": IM_W, "height": IM_H,
             "flipped": False} for i in range(n)]


def planted_maps(all_maps, density: float):
    """Each chip's FocusPixel map replaced by a centred binary blob over
    ``density`` of its cells (the maps' shapes are the head's)."""
    out = []
    for per_im in all_maps:
        row = []
        for m in per_im:
            if m is None:
                row.append(None)
                continue
            fh, fw = m.shape
            planted = np.zeros((fh, fw), np.float32)
            side = math.sqrt(density)
            bh, bw = max(1, round(fh * side)), max(1, round(fw * side))
            y0, x0 = (fh - bh) // 2, (fw - bw) // 2
            planted[y0:y0 + bh, x0:x0 + bw] = 1.0
            row.append(planted)
        out.append(row)
    return out


@contextlib.contextmanager
def focus_chips(density=None):
    """Wrap main_test.add_chips from outside: with ``density``, plant the
    maps it receives (planted_maps); record each call's scale, percent of
    the next scale's pixels, host time of the real add_chips and the
    FocusChips it made (restored on exit). Yields the list of records."""
    from sniper_tpu_torch import main_test

    real = main_test.add_chips
    calls = []

    def add_chips(roidb, maps, s, cfg):
        if density is not None:
            maps = planted_maps(maps, density)
        t0 = time.perf_counter()
        chip_area, total_area = real(roidb, maps, s, cfg)
        calls.append(dict(
            scale=s, host_ms=(time.perf_counter() - t0) * 1e3,
            pct=100.0 * chip_area / max(total_area, 1e-9),
            chips=[len(r["inference_crops"]) for r in roidb]))
        return [chip_area, total_area]

    main_test.add_chips = add_chips
    try:
        yield calls
    finally:
        main_test.add_chips = real


class Detections:
    """Stands in for a dataset: ``evaluate_detections`` counts the
    aggregated detections and raises on a malformed or non-finite one."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def evaluate_detections(self, all_boxes, roidb):
        total = 0
        for cls in all_boxes[1:]:
            for dets in cls:
                if dets.ndim != 2 or dets.shape[1] != 5:
                    raise ValueError(f"bad detection shape {dets.shape}")
                if not np.isfinite(dets).all():
                    raise ValueError("non-finite detections")
                total += len(dets)
        return {"detections": total, "images": len(roidb)}


def synchronize(device):
    """Wait for ``device``'s work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_pipeline(cfg, model, device, roidb, image_loader, density=None):
    """One run_detection over a copy of ``roidb``: with ``density``
    AutoFocus on planted maps, else the full pyramid (TEST.AUTO_FOCUS
    off). Returns (seconds, the add_chips records, the detection
    counts)."""
    from sniper_tpu_torch.main_test import run_detection

    cfg = copy.deepcopy(cfg)
    cfg.TEST.AUTO_FOCUS = density is not None
    with focus_chips(density) as calls, \
            tempfile.TemporaryDirectory() as out_dir:
        synchronize(device)
        t0 = time.perf_counter()
        stats = run_detection(cfg, model, None, copy.deepcopy(roidb),
                              Detections(model.num_classes), out_dir, device,
                              image_loader=image_loader)
        synchronize(device)
        seconds = time.perf_counter() - t0
    return seconds, calls, stats


def bench(densities=(0.05, 0.2), *, device, cfg, model,
          n_images: int = N_IMAGES) -> dict:
    """AutoFocus at each density against the full pyramid on ``n_images``
    images, after one warm-up pass of each mode (every canvas tier's first
    call). Returns {"full_pyramid": {img_per_s, pct_pixels},
    "autofocus_d<density>": {img_per_s, pct_pixels}, ...}; pct_pixels is
    the finest scale's share that the FocusChips cover."""
    roidb = make_roidb(n_images)

    def run(density):
        seconds, calls, stats = run_pipeline(cfg, model, device, roidb,
                                             synth_loader, density)
        if density is not None and not calls:
            raise RuntimeError("AutoFocus made no FocusChips: TEST.SCALES "
                               "needs at least two scales")
        pct = calls[-1]["pct"] if calls else 100.0
        return {"img_per_s": n_images / seconds, "pct_pixels": pct,
                "detections": stats["detections"]}

    print("autofocus warmup (every canvas tier's first call) ...",
          file=sys.stderr, flush=True)
    for density in sorted(set(densities), reverse=True) + [None]:
        run(density)
    results = {"full_pyramid": run(None)}
    for density in densities:
        results[f"autofocus_d{density}"] = run(density)
    return results


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_autofocus: no CUDA device; this bench "
                         "measures the card and has no CPU mode")
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model

    cfg = make_cfg()
    model = init_detector(get_model(cfg), seed=0)
    with contextlib.redirect_stdout(sys.stderr):
        r = bench(device=torch.device("cuda", 0), cfg=cfg, model=model)
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
