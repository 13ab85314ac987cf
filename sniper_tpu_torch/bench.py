"""The port's bench on the card: multi-scale inference throughput, the
training step on a resident batch, the fed training pipeline and AutoFocus.

    python -m sniper_tpu_torch.bench [r101|r50|mnv2|x101] [--batches 4,8,8]
        [--reps 2,1,1]

Port of bench.py. The last line of the output is one JSON object:

- ``metric`` multiscale_inference_throughput_<trunk>, ``value`` in
  ``unit`` images/sec: synthetic 640x480 images through the three test
  scales of configs/sniper_res101_e2e.yml's TEST section (canvases rounded
  up to 64, batches 4/8/8, post-NMS 300/200/100 rois per image), each
  round's batches enqueued before the previous round's outputs are copied
  to the host and decoded per image by the Tester (``detect_outputs``:
  box decode, clipping, rescaling), 8 rounds;
- ``vs_baseline``: that rate over 5.0 img/s, the reference's figure on
  one NVIDIA V100 (its README.md:35), not an H100 number;
- ``device`` and ``power_limit``: the card's name and power limit;
- for r101 (unless ``--batches`` makes it an A/B run of the pyramid), the
  keys of ``bench_train_step`` (train_*), ``bench_train_pipeline``
  (train_pipeline_*, loader_only_ms, upload_only_ms) and the AutoFocus
  sweep of sniper_tpu_torch/bench_autofocus.py (autofocus_*).

Before it, on stderr, a detail line: per scale the mean ms of 4
synchronised batches, img/s, TFLOP per batch and MFU; the round's FLOPs,
each round's ms and ``pipeline_mfu``. Every MFU is a FLOP count made from
the model's shapes (utils/flops.py) over the card's published dense bf16
peak (``resolve_peak``); a card the table does not know stops the run.

The models are the registry's (resnet_mx_101_e2e, resnet_mx_50_e2e,
resnext_mx_101 on the flagship yml, mobilenetv2_e2e on
configs/sniper_mobilenetv2_e2e.yml) with seeded random weights
(models/init.py, seed 0; the offset layers start at zero, as flax's init
does), a bf16 trunk, 81 classes and 21 anchors. Nothing is downloaded.

The bench runs only on a CUDA card: with none it exits non-zero before
measuring anything. No section's failure is caught: any one ends the run
with an error. The sections take the device, the config and the model as
arguments, so that the tests run them at a tiny size on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from sniper_tpu_torch import bench_autofocus

# dense bf16 peak FLOP/s by card name (NVIDIA's H100 data sheet, SXM part,
# without sparsity, at the full 700 W power limit)
PEAK_BF16 = {"H100 80GB HBM3": 989e12, "H100 SXM": 989e12}
V100_IMG_PER_S = 5.0  # the reference's multi-scale rate on one V100
CONFIGS = Path(__file__).resolve().parents[1] / "configs"
FLAGSHIP = CONFIGS / "sniper_res101_e2e.yml"
TRUNKS = {
    "r101": (FLAGSHIP, "resnet_mx_101_e2e"),
    "r50": (FLAGSHIP, "resnet_mx_50_e2e"),
    "x101": (FLAGSHIP, "resnext_mx_101"),
    "mnv2": (CONFIGS / "sniper_mobilenetv2_e2e.yml", "mobilenetv2_e2e"),
}
IM_W, IM_H = 640, 480
# the keys of bench.py's r101 line
R101_KEYS = (
    "metric", "value", "unit", "vs_baseline",
    "train_step_ms", "train_img_per_s", "train_batch", "train_chip",
    "train_step_tflops", "train_mfu",
    "train_pipeline_ms", "train_pipeline_img_per_s", "train_pipeline_steps",
    "loader_only_ms", "upload_only_ms",
    "autofocus_img_per_s", "autofocus_pct_pixels",
    "autofocus_full_pyramid_img_per_s", "autofocus_speedup",
    "autofocus_sweep",
)


def resolve_peak(device_name: str) -> float:
    """The card's dense bf16 peak FLOP/s; ValueError for a card the table
    does not hold."""
    for key, peak in PEAK_BF16.items():
        if key in device_name:
            return peak
    raise ValueError(f"no published bf16 peak for {device_name!r}: add it to "
                     "sniper_tpu_torch.bench.PEAK_BF16")


def card() -> dict:
    """The card's name (torch) and power limit (nvidia-smi)."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return {"device": torch.cuda.get_device_name(0),
            "power_limit": line.rsplit(",", 1)[1].strip()}


def seeded_model(cfg, seed: int = 0):
    """The registry's detector for ``cfg`` with seeded random weights."""
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model

    return init_detector(get_model(cfg), seed=seed)


def train_cfg(cfg):
    """bench.py's training settings on ``cfg``: lr 0.015 with no warm-up
    and no lr_step, FIXED_PARAMS conv0, bn0, stage1, bn_data, 16 chips of
    512x512."""
    cfg.TRAIN.lr = 0.015
    cfg.TRAIN.warmup = False
    cfg.TRAIN.lr_step = ""
    cfg.TRAIN.BATCH_IMAGES = 16
    cfg.TRAIN.CHIP_SIZE = 512
    cfg.network.FIXED_PARAMS = ["conv0", "bn0", "stage1", "bn_data"]
    return cfg


def pipeline_cfg(cfg):
    """``train_cfg`` with the loader's settings of bench.py:413-415: the
    flagship's training scales and valid ranges, no negative chips (a
    synthetic run has no proposals)."""
    cfg = train_cfg(cfg)
    cfg.TRAIN.SCALES = [(1400, 2000), (800, 1280), (-1, 512)]
    cfg.TRAIN.VALID_RANGES = [(-1, 80), (32, 150), (120, -1)]
    cfg.TRAIN.USE_NEG_CHIPS = False
    return cfg


def flagship(trunk: str, section: str):
    """(config, model) of a section at full width: "inference" for
    ``trunk``, "train" and "pipeline" for R101, "autofocus" for the
    AutoFocus yml (bench_autofocus.make_cfg)."""
    from sniper_tpu_torch.config import load_config

    if section == "autofocus":
        cfg = bench_autofocus.make_cfg()
    else:
        path, symbol = TRUNKS[trunk if section == "inference" else "r101"]
        cfg = load_config(str(path))
        cfg.symbol = symbol
        if section == "train":
            cfg = train_cfg(cfg)
        elif section == "pipeline":
            cfg = pipeline_cfg(cfg)
    return cfg, seeded_model(cfg)


# ---------------------------------------------------------------------------
# multi-scale inference
# ---------------------------------------------------------------------------


def scale_specs(cfg, batches=None) -> list[dict]:
    """Per TEST.SCALES entry, a 640x480 image's canvas (its resized size
    rounded up to 64), batch (TEST.BATCH_IMAGES unless ``batches``), scale,
    resized size and post-NMS roi count (TEST.N_PROPOSAL_PER_SCALE, or
    TEST.RPN_POST_NMS_TOP_N at every scale)."""
    from sniper_tpu_torch.data.test_loader import scale_for_image

    t = cfg.TEST
    batches = list(batches or t.BATCH_IMAGES)
    n = t.N_PROPOSAL_PER_SCALE
    post_nms = (list(n) if isinstance(n, (list, tuple))
                else [int(t.RPN_POST_NMS_TOP_N)] * len(t.SCALES))
    specs = []
    for spec, b, rois in zip(t.SCALES, batches, post_nms):
        s = scale_for_image(IM_W, IM_H, spec)
        h, w = int(np.round(IM_H * s)), int(np.round(IM_W * s))
        specs.append(dict(canvas=((h + 63) // 64 * 64, (w + 63) // 64 * 64),
                          batch=int(b), scale=s, hw=(h, w),
                          post_nms=int(rois)))
    return specs


def round_reps(batches, reps=None) -> list[int]:
    """Batches per scale in one round: by default the least common
    multiple of the batches over each batch, so that every image of a
    round passes every scale once. ValueError when batch x reps differs
    between scales."""
    if reps is None:
        lcm = functools.reduce(math.lcm, batches, 1)
        reps = [lcm // b for b in batches]
    if len({b * r for b, r in zip(batches, reps)}) != 1:
        raise ValueError(f"batch x reps must agree across scales: batches "
                         f"{list(batches)}, reps {list(reps)}")
    return list(reps)


def inference_inputs(specs, seed: int = 0) -> list[tuple]:
    """Per scale, (data [b, ch, cw, 3] fp32 normal, im_info [b, 3]) from
    one RandomState(seed), drawn from the smallest canvas up as bench.py
    draws them, so that both benches see the same pixels."""
    rng = np.random.RandomState(seed)
    out = [None] * len(specs)
    order = sorted(range(len(specs)),
                   key=lambda i: specs[i]["canvas"][0] * specs[i]["canvas"][1])
    for i in order:
        sp = specs[i]
        (ch, cw), b, (h, w) = sp["canvas"], sp["batch"], sp["hw"]
        data = rng.randn(b, ch, cw, 3).astype(np.float32)
        info = np.tile([[h, w, sp["scale"]]], (b, 1)).astype(np.float32)
        out[i] = (data, info)
    return out


def bench_inference(cfg, model, *, device, peak: float, batches=None,
                    reps=None, n_rounds: int = 8, n_iter: int = 4):
    """The multi-scale pyramid through ``main_test.make_forward`` and the
    Tester's host decode. Returns (img/s, the detail dict). The detail's
    ``round_ms`` runs from one round's last decode to the next's: the
    first holds two rounds' launches (the host waits on the launch queue),
    the last its decode alone."""
    from sniper_tpu_torch.infer.tester import Tester
    from sniper_tpu_torch.main_test import make_forward
    from sniper_tpu_torch.utils.flops import detector_flops

    specs = scale_specs(cfg, batches)
    reps = round_reps([sp["batch"] for sp in specs], reps)
    images_per_round = specs[0]["batch"] * reps[0]
    tester = Tester(None, cfg, model.num_classes)
    scales = []
    for sp, (data, info) in zip(specs, inference_inputs(specs)):
        fwd = make_forward(model, None, device, cfg.network.PIXEL_MEANS,
                           post_nms_top_n=sp["post_nms"])
        # the inputs stay on the card, as bench.py's device arrays do
        scales.append((fwd, torch.from_numpy(data).to(device),
                       torch.from_numpy(info).to(device), info,
                       [sp["scale"]] * sp["batch"]))
    for sp, (fwd, data, info, _, _) in zip(specs, scales):
        print(f"warmup {tuple(data.shape)} ...", file=sys.stderr, flush=True)
        # the second call captures the scale's CUDA graph on a card
        # (main_test.make_forward), so that no capture falls in the rounds
        for _ in range(2):
            fwd(data, info)
        bench_autofocus.synchronize(device)

    def dispatch_round():
        return [(fwd(data, info), info_np, im_scales)
                for (fwd, data, info, info_np, im_scales), rep
                in zip(scales, reps) for _ in range(rep)]

    def drain(outs):
        for out, info_np, im_scales in outs:
            tester.detect_outputs(out, info_np, im_scales)

    round_ms = []
    t0 = last = time.perf_counter()
    pending = dispatch_round()
    for r in range(n_rounds):
        nxt = dispatch_round() if r < n_rounds - 1 else None
        drain(pending)
        now = time.perf_counter()
        round_ms.append((now - last) * 1e3)
        last, pending = now, nxt
    dt = time.perf_counter() - t0
    ips = n_rounds * images_per_round / dt

    per_scale, round_flops = [], 0
    for sp, rep, (fwd, data, info, _, _) in zip(specs, reps, scales):
        flops = sum(detector_flops(model, sp["batch"], sp["canvas"],
                                   sp["post_nms"]))
        round_flops += flops * rep
        bench_autofocus.synchronize(device)
        t1 = time.perf_counter()
        for _ in range(n_iter):
            fwd(data, info)
            bench_autofocus.synchronize(device)
        step_s = (time.perf_counter() - t1) / n_iter
        per_scale.append({
            "canvas": list(sp["canvas"]), "batch": sp["batch"],
            "post_nms": sp["post_nms"], "step_ms": step_s * 1e3,
            "img_per_s": sp["batch"] / step_s, "flops": flops,
            "tflops": flops / 1e12, "mfu": flops / step_s / peak,
        })
    detail = {
        "peak_bf16_flops": peak, "per_scale": per_scale,
        "images_per_round": images_per_round, "round_ms": round_ms,
        "round_flops": round_flops, "round_flops_T": round_flops / 1e12,
        "pipeline_mfu": round_flops / (dt / n_rounds) / peak,
    }
    return ips, detail


# ---------------------------------------------------------------------------
# the training step on a resident batch
# ---------------------------------------------------------------------------


def train_batch(cfg, b: int, chip: int, seed: int = 0) -> dict:
    """bench.py's 16 chips in the port's batch form, as NumPy.

    The pixels (rng.randn from RandomState(seed), fp32, the step's input
    as it is: no mean to subtract), im_info, valid_ranges and the two GT
    boxes of every chip are bench.py's. bench.py then draws dense RPN
    targets (``label`` with ~10% of the A*H*W anchors labelled,
    ``bbox_target``, ``bbox_weight``), which the JAX step takes; the
    port's step takes the chip loader's sparse form, so the chip loader's
    own assigner (data/anchor_targets.py) labels each chip's anchors
    against those boxes with the same rng: RPN_BATCH_SIZE (256) sampled
    anchors (``rpn_pids``, ``rpn_label_vals``), the fg ones' regression
    targets (``fg_pids``, ``fg_targets``)."""
    from sniper_tpu_torch.data.anchor_targets import AnchorTargetAssigner

    rng = np.random.RandomState(seed)
    gt = np.full((b, 100, 5), -1.0, np.float32)
    gt[:, 0] = [40, 40, 200, 200, 2]
    gt[:, 1] = [250, 250, 400, 420, 7]
    batch = {
        "data": rng.randn(b, chip, chip, 3).astype(np.float32),
        "im_info": np.tile([[chip, chip, 1.0]], (b, 1)).astype(np.float32),
        "gt_boxes": gt,
        "valid_ranges": np.tile([[0.0, float(chip)]], (b, 1)).astype(
            np.float32),
    }
    t = cfg.TRAIN
    assigner = AnchorTargetAssigner(
        chip_size=chip, anchor_scales=cfg.network.ANCHOR_SCALES,
        anchor_ratios=cfg.network.ANCHOR_RATIOS,
        feat_stride=cfg.network.RPN_FEAT_STRIDE,
        rpn_batch_size=t.RPN_BATCH_SIZE, fg_fraction=t.RPN_FG_FRACTION,
        pos_thresh=t.RPN_POSITIVE_OVERLAP, neg_thresh=t.RPN_NEGATIVE_OVERLAP,
        max_n_gts=gt.shape[1])
    ids = np.arange(2)
    targets = [assigner(np.array([0.0, 0.0, chip, chip]), 1.0, ids, ids,
                        gt[i, :2, :4], gt[i, :2, 4], rng) for i in range(b)]
    for key in ("rpn_pids", "rpn_label_vals", "fg_pids", "fg_targets"):
        batch[key] = np.stack([getattr(tg, key) for tg in targets])
    return batch


def _train_step_fn(cfg, model, device, b: int, epoch_size: int):
    from sniper_tpu_torch.train.optimizer import make_optimizer
    from sniper_tpu_torch.train.trainer import make_train_step

    model.to(device)
    opt, sched, _ = make_optimizer(cfg, epoch_size, model)
    return make_train_step(
        model, opt, sched, b, rpn_batch_size=cfg.TRAIN.RPN_BATCH_SIZE,
        pixel_means=cfg.network.PIXEL_MEANS,
        generator=torch.Generator(device=device).manual_seed(0))


def bench_train_step(peak: float, b: int = 16, chip: int = 512, *, device,
                     cfg, model, n_steps: int = 6, n_rounds: int = 3) -> dict:
    """One warm-up step, then ``n_rounds`` rounds of ``n_steps`` steps on
    ``train_batch``'s chips, resident on the card; a round ends when its
    last step's loss reaches the host. train_step_ms is the best round's
    mean step, as bench.py reports it; the median and spread of the rounds
    go to stderr."""
    from sniper_tpu_torch.train.trainer import to_device
    from sniper_tpu_torch.utils.flops import detector_flops

    step = _train_step_fn(cfg, model, device, b, epoch_size=1000)
    batch = to_device(train_batch(cfg, b, chip), device)
    print("train warmup ...", file=sys.stderr, flush=True)
    metrics = step(batch)
    print(f"train warmup loss={float(metrics['loss']):.3f}", file=sys.stderr,
          flush=True)
    rounds = []
    for _ in range(n_rounds):
        bench_autofocus.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(n_steps):
            metrics = step(batch)
        float(metrics["loss"])
        rounds.append((time.perf_counter() - t0) / n_steps)
    best = min(rounds)
    flops = sum(detector_flops(model, b, (chip, chip), model.num_rois,
                               train=True,
                               fixed_params=cfg.network.FIXED_PARAMS))
    print(json.dumps({"train_round_ms": [r * 1e3 for r in rounds],
                      "train_median_ms": statistics.median(rounds) * 1e3,
                      "train_spread_ms": (max(rounds) - best) * 1e3,
                      "train_step_flops": flops}),
          file=sys.stderr, flush=True)
    return {
        "train_step_ms": best * 1e3, "train_img_per_s": b / best,
        "train_batch": b, "train_chip": chip,
        "train_step_tflops": flops / 1e12, "train_mfu": flops / best / peak,
    }


# ---------------------------------------------------------------------------
# the fed training pipeline
# ---------------------------------------------------------------------------


def synth_jpegs(directory: str, n_images: int, num_classes: int,
                rng) -> list:
    """bench.py's synthetic roidb: ``n_images`` smoothed-noise JPEGs, one
    in three portrait, eight GT boxes each of 16-180 px (every valid range
    of the training scales) of classes 1 to num_classes - 1."""
    import cv2

    roidb = []
    for i in range(n_images):
        w, h = (640, 480) if i % 3 else (480, 640)
        im = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
        im = cv2.GaussianBlur(im, (11, 11), 5)
        path = f"{directory}/im{i}.jpg"
        cv2.imwrite(path, im)
        n_gt = 8
        x1 = rng.uniform(0, w - 200, n_gt)
        y1 = rng.uniform(0, h - 200, n_gt)
        s = rng.uniform(16, 180, n_gt)
        boxes = np.stack([x1, y1, np.minimum(x1 + s, w - 1),
                          np.minimum(y1 + s, h - 1)], 1).astype(np.float32)
        roidb.append({
            "image": path, "width": w, "height": h, "boxes": boxes,
            "max_overlaps": np.ones(n_gt),
            "max_classes": rng.randint(1, num_classes, n_gt),
            "flipped": False,
        })
    return roidb


def bench_train_pipeline(b: int = 16, n_images: int = 96,
                         loader_process: bool = False, *, device, cfg,
                         model) -> dict:
    """The rate a training run pays: main_train.run_training's inner loop
    over ``n_images`` JPEGs (decode included) through the ChipLoader (or
    the ProcessChipLoader), batches assembled in one Prefetcher thread and
    staged to the card in a second, the step's metrics read only at the
    epoch's end. One warm-up epoch, then two timed epochs (the chip re-roll
    of ``reset`` outside the clock). Then the loader alone over an epoch,
    and the upload alone: one held batch copied to the card and reduced
    there, synchronised, 5 times."""
    from sniper_tpu_torch.data.loader import ChipLoader, Prefetcher
    from sniper_tpu_torch.train.trainer import to_device

    with tempfile.TemporaryDirectory() as td:
        roidb = synth_jpegs(td, n_images, model.num_classes,
                            np.random.RandomState(0))
        if loader_process:
            from sniper_tpu_torch.data.shm_loader import ProcessChipLoader

            loader = ProcessChipLoader(roidb, cfg, b, seed=0)
        else:
            loader = ChipLoader(roidb, cfg, b, seed=0)
        try:
            n_chips = loader.reset()
            step = _train_step_fn(cfg, model, device, b,
                                  epoch_size=max(len(loader), 1))

            def run_epoch():
                host = Prefetcher(loader.batches())
                pending = [step(bt) for bt in
                           Prefetcher(to_device(x, device) for x in host)]
                [float(v) for m in pending for v in m.values()]
                return len(pending)

            print(f"train pipeline warmup ({n_chips} chips) ...",
                  file=sys.stderr, flush=True)
            run_epoch()
            steps, dt = 0, 0.0
            for _ in range(2):
                loader.reset()
                t0 = time.perf_counter()
                steps += run_epoch()
                dt += time.perf_counter() - t0
            t0 = time.perf_counter()
            n_loader = sum(1 for _ in loader.batches())
            loader_s = (time.perf_counter() - t0) / n_loader
            held = list(loader.batches(1))[0]

            def upload():
                staged = to_device(held, device)
                float(sum(v.float().sum() for v in staged.values()))

            upload()
            t0 = time.perf_counter()
            for _ in range(5):
                upload()
            upload_s = (time.perf_counter() - t0) / 5
        finally:
            loader.close()
    return {
        "train_pipeline_ms": dt / steps * 1e3,
        "train_pipeline_img_per_s": steps * b / dt,
        "train_pipeline_steps": steps,
        "loader_only_ms": loader_s * 1e3,
        "upload_only_ms": upload_s * 1e3,
    }


# ---------------------------------------------------------------------------
# the whole bench
# ---------------------------------------------------------------------------


def autofocus_keys(sweep: dict) -> dict:
    """bench.py's autofocus_* keys of a bench_autofocus sweep: the d=0.05
    point (about the reference's share of fine-scale pixels) against the
    full pyramid, and the sweep itself."""
    full = sweep["full_pyramid"]["img_per_s"]
    head = sweep["autofocus_d0.05"]
    return {
        "autofocus_img_per_s": head["img_per_s"],
        "autofocus_pct_pixels": head["pct_pixels"],
        "autofocus_full_pyramid_img_per_s": full,
        "autofocus_speedup": head["img_per_s"] / full,
        "autofocus_sweep": sweep,
    }


def main(trunk: str = "r101", batches=None, reps=None, *, device,
         peak: float, build=None, pipeline_images: int = 96,
         autofocus_images: int = bench_autofocus.N_IMAGES):
    """The bench of ``trunk`` on ``device``: the pyramid, and for r101
    without custom ``batches`` the training step, the fed pipeline and
    AutoFocus. ``build(section)`` gives each section's (config, model)
    (default ``flagship``). Returns (the result line, the inference
    detail); any section's error propagates."""
    build = build or functools.partial(flagship, trunk)
    cfg, model = build("inference")
    ips, detail = bench_inference(cfg, model, device=device, peak=peak,
                                  batches=batches, reps=reps)
    result = {
        "metric": f"multiscale_inference_throughput_{trunk}",
        "value": ips, "unit": "images/sec",
        "vs_baseline": ips / V100_IMG_PER_S,
    }
    if trunk != "r101" or batches is not None:
        return result, detail
    del model
    torch.cuda.empty_cache()
    cfg, model = build("train")
    result.update(bench_train_step(
        peak, cfg.TRAIN.BATCH_IMAGES, cfg.TRAIN.CHIP_SIZE, device=device,
        cfg=cfg, model=model))
    del model
    torch.cuda.empty_cache()
    cfg, model = build("pipeline")
    result.update(bench_train_pipeline(
        cfg.TRAIN.BATCH_IMAGES, pipeline_images, device=device, cfg=cfg,
        model=model))
    del model
    torch.cuda.empty_cache()
    cfg, model = build("autofocus")
    result.update(autofocus_keys(bench_autofocus.bench(
        (0.05, 0.2), device=device, cfg=cfg, model=model,
        n_images=autofocus_images)))
    return result, detail


def _ints(text):
    return [int(x) for x in text.split(",")] if text else None


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(description="the port's bench on the card")
    p.add_argument("trunk", nargs="?", default="r101", choices=list(TRUNKS))
    p.add_argument("--batches", default=None,
                   help="per-scale batches finest->coarsest, e.g. 8,12,24 "
                        "(default: the flagship yml's TEST.BATCH_IMAGES); "
                        "skips the training and AutoFocus sections")
    p.add_argument("--reps", default=None,
                   help="batches per scale per round, e.g. 3,2,1; "
                        "batch*reps must agree across scales")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sniper_tpu_torch.bench: no CUDA device "
                         "(torch.cuda.is_available() is False); the bench "
                         "measures the card and has no CPU mode")
    device = torch.device("cuda", 0)
    info = card()
    peak = resolve_peak(info["device"])
    # the program's progress lines go to stderr: the result is stdout's
    # last line
    with contextlib.redirect_stdout(sys.stderr):
        result, detail = main(args.trunk, _ints(args.batches),
                              _ints(args.reps), device=device, peak=peak)
    print(json.dumps({**info, **detail}), file=sys.stderr)
    print(json.dumps({**result, **info}))
    return 0


if __name__ == "__main__":
    sys.exit(cli())
