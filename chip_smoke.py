#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (sniper_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. Environment: the card's name and power limit, torch and CUDA versions,
   whether PyYAML and OpenCV are present, and the kernels' build time (the
   kernels are built from csrc/ at first use, into build/sniper_tpu_torch/).
2. Each hand-written kernel against its plain torch version on the card,
   at the shapes the main path gives it at each test scale (canvas, batch
   and roi count from the config), in the same dtype, with TF32 off: the
   errors, the kernel's and the plain version's times.
3. End to end at full R101 width (configs/sniper_res101_e2e.yml) with
   seeded random weights: (a) the kernel path against the plain path on a
   small input, (b) the port's run_detection over a few synthetic 640x480
   images, with the kernels' launch counters zeroed just before and read
   just after, (c) per-scale forward times on the host clock: a smoke
   reading (median and spread over E2E_REPS passes), not a benchmark.

The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA device the
script raises at once.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CONFIG = "configs/sniper_res101_e2e.yml"
N_IMAGES = 8
IM_W, IM_H = 640, 480
E2E_REPS = 15  # timed passes over each scale's batches in phase 3 (c)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events), after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def environment() -> str:
    """Print the environment lines and build the kernels; return the
    card's name and power limit."""
    from sniper_tpu_torch.ops import cuda

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    for mod in ("yaml", "cv2"):
        try:
            m = __import__(mod)
            print(f"{mod}: present ({m.__version__})")
        except ImportError:
            print(f"{mod}: absent")
    t0 = time.perf_counter()
    path = cuda.build()
    cuda.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s: "
          f"{path}")
    log = path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas:", line.strip())
    torch.cuda.synchronize()
    return card


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def main_path_shapes(cfg) -> list[dict]:
    """Per test scale, the shapes the main path gives the kernels: the
    landscape canvas at stride 16, the batch, the post-NMS roi count."""
    from sniper_tpu_torch.data.test_loader import canvas_for_scale

    shapes = []
    for s, spec in enumerate(cfg.TEST.SCALES):
        (ch, cw), _ = canvas_for_scale(spec)
        shapes.append(dict(
            label=f"scale {s}", B=int(cfg.TEST.BATCH_IMAGES[s]),
            H=ch // cfg.network.RPN_FEAT_STRIDE,
            W=cw // cfg.network.RPN_FEAT_STRIDE,
            rois=int(cfg.TEST.N_PROPOSAL_PER_SCALE[s]),
            pre_nms=int(cfg.TEST.RPN_PRE_NMS_TOP_N)))
    return shapes


def check_nms(dev, sh):
    from sniper_tpu_torch.ops.nms import nms, nms_plain

    B, N, max_out, thresh = sh["B"], sh["pre_nms"], sh["rois"], 0.7
    g = torch.Generator().manual_seed(1)
    span = torch.tensor([sh["W"] * 16.0, sh["H"] * 16.0])
    ctr = torch.rand(B, 60, 2, generator=g) * span
    pick = torch.randint(0, 60, (B, N), generator=g)
    c = torch.gather(ctr, 1, pick[..., None].expand(B, N, 2))
    c = c + torch.randn(B, N, 2, generator=g) * 24.0
    wh = torch.exp(torch.randn(B, N, 2, generator=g) * 0.5) * 96.0
    boxes = torch.cat([c - wh / 2, c + wh / 2], dim=-1).to(dev)
    # distinct scores: a random permutation of N levels (no ties)
    scores = torch.stack([torch.randperm(N, generator=g) for _ in range(B)])
    scores = ((scores.float() + 1.0) / (N + 1)).to(dev)

    keep_k, valid_k = nms(boxes, scores, max_out, thresh)
    keep_p, valid_p = nms_plain(boxes, scores, max_out, thresh)
    torch.cuda.synchronize()
    same = torch.equal(keep_k, keep_p) and torch.equal(valid_k, valid_p)
    diff = int((keep_k.long() - keep_p.long()).abs().max())
    ms = time_ms(lambda: nms(boxes, scores, max_out, thresh), 20)
    plain_ms = time_ms(lambda: nms_plain(boxes, scores, max_out, thresh), 2)
    print(f"nms [{sh['label']}]: B={B} N={N} -> {max_out} at {thresh}: keep "
          f"lists {'identical' if same else 'DIFFER'} (max index diff "
          f"{diff}), {int(valid_k.sum())} kept; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms")
    return same, float(diff), ms, plain_ms


def check_im2col(dev, sh):
    from sniper_tpu_torch.ops.deform import (
        deform_im2col,
        deform_im2col_plain,
    )

    B, H, W, C, G, K, d = sh["B"], sh["H"], sh["W"], 512, 4, 3, 2
    g = torch.Generator().manual_seed(2)
    x = torch.randn(B, H, W, C, generator=g).to(dev, torch.bfloat16)
    # +-6 px offsets: many samples leave the map and clamp onto its border
    off = ((torch.rand(B, H, W, G * K * K * 2, generator=g) * 2 - 1) * 6.0)
    off = off.to(dev)
    kw = dict(num_groups=G, kernel_size=K, dilation=d)
    a = deform_im2col(x, off, **kw)
    b = deform_im2col_plain(x, off, **kw)
    torch.cuda.synchronize()
    err = (a.float() - b.float()).abs()
    ok = bool((err <= 2.0 ** -8 * b.float().abs()).all())
    exact = bool(torch.equal(a, b))
    del a, b
    ms = time_ms(lambda: deform_im2col(x, off, **kw), 20)
    plain_ms = time_ms(lambda: deform_im2col_plain(x, off, **kw), 2)
    print(f"deform_im2col [{sh['label']}]: x [{B},{H},{W},{C}] bf16, G={G}, "
          f"dilation {d}, offsets +-6 px: max abs err "
          f"{float(err.max()):.3e}, bit-exact {exact}; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")
    return ok, float(err.max()), ms, plain_ms


def check_pool(dev, sh):
    from sniper_tpu_torch.ops import deform

    B, rpi, C, H, W = sh["B"], sh["rois"], 256, sh["H"], sh["W"]
    P, S, M = 7, 4, 4
    g = torch.Generator().manual_seed(3)
    feat = torch.randn(B, H, W, C, generator=g).to(dev)
    R = B * rpi
    rois = torch.zeros(R, 5)
    rois[:, 0] = torch.arange(B).repeat_interleave(rpi).float()
    span = torch.tensor([W * 16.0 + 120, H * 16.0 + 120])
    xy = torch.rand(R, 2, generator=g) * span - 60
    wh = torch.exp(torch.rand(R, 2, generator=g) * math.log(100.0)) * 8.0
    rois[:, 1:3] = xy
    rois[:, 3:5] = xy + wh
    rois = rois.to(dev)
    off_w = (torch.randn(2 * P * P, P * P * C, generator=g) * 0.03).to(dev)
    off_b = (torch.randn(2 * P * P, generator=g) * 0.3).to(dev)

    geom, roi_h, roi_w, sub_h, sub_w = deform.pool_geometry(
        rois, P=P, S=S, M=M, spatial_scale=1 / 16)
    kw = dict(rois_per_image=rpi, P=P, S=S, M=M)
    pass1_k = deform.pool_pass(feat, geom, None, **kw)
    pass1_p = deform.pool_pass_plain(feat, geom, None, **kw)
    off = pass1_p.reshape(R, -1) @ off_w.t() + off_b
    pypx = deform.window_starts(off, roi_h, roi_w, sub_h, sub_w, P=P, S=S,
                                M=M, trans_std=0.1)
    clamped = float(((pypx == 0) | (pypx == P * S + 2 * M - S)).float()
                    .mean())
    pooled_k = deform.pool_pass(feat, geom, pypx, **kw)
    pooled_p = deform.pool_pass_plain(feat, geom, pypx, **kw)
    full_k = deform.fused_offset_pool(feat, rois, off_w, off_b,
                                      rois_per_image=rpi)
    torch.cuda.synchronize()
    ok, worst, parts = True, 0.0, []
    for name, a, b in (("pass A", pass1_k, pass1_p),
                       ("pass B", pooled_k, pooled_p),
                       ("two-pass", full_k, pooled_p.reshape(R, -1))):
        err = float((a - b).abs().max())
        ok &= bool(torch.allclose(a, b, atol=POOL_ATOL, rtol=POOL_RTOL))
        worst = max(worst, err)
        parts.append(f"{name} {err:.3e}")
    ms = (time_ms(lambda: deform.pool_pass(feat, geom, None, **kw), 10)
          + time_ms(lambda: deform.pool_pass(feat, geom, pypx, **kw), 10))
    plain_ms = (
        time_ms(lambda: deform.pool_pass_plain(feat, geom, None, **kw), 2)
        + time_ms(lambda: deform.pool_pass_plain(feat, geom, pypx, **kw), 2))
    print(f"fused_pool [{sh['label']}]: B={B} rpi={rpi} C={C} map {H}x{W}, "
          f"{clamped:.1%} of window starts on the margin clamp; max abs err "
          f"{', '.join(parts)}; kernel (pass A + pass B) {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms")
    return ok, worst, ms, plain_ms


POOL_ATOL, POOL_RTOL = 1e-4, 1e-4
TOLERANCES = {
    "nms": "identical keep lists (the IoU is computed in nms_jax's fp32 "
           "order, without FMA contraction)",
    "deform_im2col": "one bf16 rounding step (2^-8 relative): both blend in "
                     "fp32 in the same order and round once",
    "fused_pool": f"atol={POOL_ATOL} rtol={POOL_RTOL}: fp32 sums over up to "
                  "~100 taps in another order",
}


def kernel_phase(dev, cfg) -> tuple[bool, list]:
    """Each kernel against its plain version at every test scale's shapes
    (scale 0 first: its times go into the JSON line)."""
    from sniper_tpu_torch.ops import cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shapes = main_path_shapes(cfg)
    results: list = []
    ok = True
    for kernel, check in ((cuda.NMS, check_nms),
                          (cuda.DEFORM_IM2COL, check_im2col),
                          (cuda.FUSED_POOL, check_pool)):
        print(f"{kernel.name}: tolerance {TOLERANCES[kernel.name]}")
        runs = [check(dev, sh) for sh in shapes]
        torch.cuda.synchronize()
        good = all(r[0] for r in runs)
        print(f"{kernel.name}: {'PASS' if good else 'FAIL'}")
        ok &= good
        results.append(dict(kernel=kernel,
                            max_abs_err=max(r[1] for r in runs),
                            ms=runs[0][2], plain_ms=runs[0][3]))
    return ok, results


# ---------------------------------------------------------------------------
# phase 3: end to end
# ---------------------------------------------------------------------------


def synth_image(name: str) -> np.ndarray:
    """A deterministic BGR 'photo': smooth noise and bright rectangles."""
    rng = np.random.RandomState(1000 + int(name.removeprefix("im")))
    im = rng.randint(40, 200, (IM_H, IM_W, 3), np.uint8)
    for _ in range(6):
        x, y = rng.randint(0, IM_W - 160), rng.randint(0, IM_H - 120)
        im[y:y + rng.randint(30, 120), x:x + rng.randint(30, 160)] = (
            rng.randint(0, 255, 3, np.uint8))
    return im


class CountingDataset:
    """Stands in for a dataset: evaluate_detections returns counts and
    checks that every detection is finite [k, 5]."""

    num_classes = 81

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


@contextlib.contextmanager
def plain_versions():
    """Route the detector through the plain torch versions on the card, to
    hold the kernel path against it (restored on exit)."""
    from sniper_tpu_torch.ops import deform, nms, proposals

    saved = (deform.deform_im2col, deform.pool_pass, proposals.nms)
    deform.deform_im2col = deform.deform_im2col_plain
    deform.pool_pass = deform.pool_pass_plain
    proposals.nms = nms.nms_plain
    try:
        yield
    finally:
        deform.deform_im2col, deform.pool_pass, proposals.nms = saved


def e2e_phase(dev, cfg, card: str) -> tuple[bool, dict]:
    """Returns (ok, {kernel name: launches in run_detection})."""
    from sniper_tpu_torch.data.test_loader import (
        TestChipIterator,
        init_inference_crops,
    )
    from sniper_tpu_torch.main_test import (
        _scale_post_nms,
        make_forward,
        run_detection,
    )
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.ops import cuda

    model = get_model(cfg)
    t0 = time.perf_counter()
    init_detector(model, seed=0, offset_std=1e-3)
    model.to(dev).eval()
    print(f"e2e: {CONFIG}: units {model.trunk.units}, "
          f"{cfg.dataset.NUM_CLASSES} classes, {cfg.network.NUM_ANCHORS} "
          f"anchors, pre-NMS {model.pre_nms_top_n}, post-NMS per scale "
          f"{list(cfg.TEST.N_PROPOSAL_PER_SCALE)}, scales "
          f"{[tuple(s) for s in cfg.TEST.SCALES]}, batches "
          f"{list(cfg.TEST.BATCH_IMAGES)}, trunk dtype {model.dtype}; "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, "
          f"seeded random weights (seed 0) with the JAX init distributions, "
          f"EXCEPT the C5 offset convs and the head's offset FC, which get "
          f"normal(1e-3) weights in place of zeros so the deformable "
          f"sampling moves ({time.perf_counter() - t0:.1f} s)")
    ok = True

    # (a) kernel path against the plain path, on a small input
    g = torch.Generator().manual_seed(4)
    data = (torch.randn(1, 256, 320, 3, generator=g) * 50).to(dev)
    info = torch.tensor([[256.0, 320.0, 1.0]], device=dev)
    with torch.inference_mode():
        torch.backends.cudnn.deterministic = True
        out_k = model(data, info)
        with plain_versions():
            out_p = model(data, info)
        torch.backends.cudnn.deterministic = False
    torch.cuda.synchronize()
    same_rois = torch.equal(out_k["rois"], out_p["rois"])
    err = float((out_k["cls_prob"] - out_p["cls_prob"]).abs().max())
    berr = float((out_k["bbox_pred"] - out_p["bbox_pred"]).abs().max())
    good = same_rois and err <= 1e-3 and berr <= 1e-3
    print(f"e2e (a) 256x320 input, kernel path vs plain path on the card: "
          f"rois identical {same_rois}, cls_prob max abs err {err:.3e}, "
          f"bbox_pred max abs err {berr:.3e}; tolerance 1e-3 (bf16 trunk "
          f"identical in both, fp32 pool sums in another order): "
          f"{'PASS' if good else 'FAIL'}")
    ok &= good

    # (b) the main path: run_detection over synthetic images
    roidb = [{"image": f"im{i}", "width": IM_W, "height": IM_H,
              "flipped": False} for i in range(N_IMAGES)]
    for k in cuda.KERNELS:
        k.launches = 0
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        stats = run_detection(cfg, model, None, roidb, CountingDataset(),
                              out_dir, dev, image_loader=synth_image)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in cuda.KERNELS}
    good = stats["detections"] > 0 and all(launches.values())
    print(f"e2e (b) run_detection (cv2 canvases, injected image loader, "
          f"counting dataset) over {N_IMAGES} synthetic {IM_W}x{IM_H} "
          f"images: {stats}, launches {launches}, {wall:.2f} s wall "
          f"including first-call set-up: {'PASS' if good else 'FAIL'}")
    ok &= good

    # (c) per-scale forward times at the shipped batch sizes
    init_inference_crops(roidb)
    ms_per_image = 0.0
    for s in range(len(cfg.TEST.SCALES)):
        bs = cfg.TEST.BATCH_IMAGES[s]
        n = _scale_post_nms(cfg, s, model)
        batches = list(TestChipIterator(roidb, cfg, s, bs,
                                        image_loader=synth_image))
        fwd = make_forward(model, None, dev, cfg.network.PIXEL_MEANS, n)
        out = fwd(batches[0]["data"], batches[0]["im_info"])
        torch.cuda.synchronize()
        shapes_ok = (tuple(out["rois"].shape) == (bs, n, 5)
                     and tuple(out["cls_prob"].shape) == (bs, n, 81)
                     and tuple(out["bbox_pred"].shape) == (bs, n, 4)
                     and all(bool(torch.isfinite(out[k]).all())
                             for k in ("rois", "cls_prob", "bbox_pred")))
        # a smoke reading on the host clock, not a benchmark: the median
        # and the spread over E2E_REPS passes of the scale's batches
        per_rep = []
        for _ in range(E2E_REPS):
            t0 = time.perf_counter()
            for b in batches:
                fwd(b["data"], b["im_info"])
            torch.cuda.synchronize()
            per_rep.append((time.perf_counter() - t0) * 1e3 / len(batches))
        per_rep.sort()
        ms = per_rep[len(per_rep) // 2]
        hw = batches[0]["data"].shape[1:3]
        print(f"e2e (c) scale {s}: canvas {hw[0]}x{hw[1]}, batch {bs}, "
              f"{n} rois/img: median {ms:.2f} ms/batch (min {per_rep[0]:.2f}, "
              f"max {per_rep[-1]:.2f} over {E2E_REPS} passes of "
              f"{len(batches)} batches), {bs * 1e3 / ms:.1f} img/s "
              f"[{card}]; shapes and finiteness "
              f"{'PASS' if shapes_ok else 'FAIL'}")
        ok &= shapes_ok
        ms_per_image += ms / bs
    print(f"e2e (c) three-scale pyramid: {ms_per_image:.2f} ms/img, "
          f"{1e3 / ms_per_image:.1f} img/s (forward only, sum of the "
          f"scales' medians, random weights; a smoke reading) "
          f"[{card}]")
    return ok, launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False); this test "
                         "runs only on the card")
    from sniper_tpu_torch.config import load_config

    dev = torch.device("cuda", 0)
    cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   CONFIG))
    card = environment()
    ok_k, results = kernel_phase(dev, cfg)
    torch.cuda.synchronize()
    ok_e, launches = e2e_phase(dev, cfg, card)
    torch.cuda.synchronize()
    kernels = [{
        "name": r["kernel"].name, "route": "cuda",
        "source": r["kernel"].source, "replaces": r["kernel"].replaces,
        "launches": launches[r["kernel"].name],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"],
    } for r in results]
    if not (ok_k and ok_e):
        print(f"chip_smoke: FAILED (kernels {ok_k}, end to end {ok_e})")
        return 1
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
