#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (sniper_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. Environment: the card's name and power limit, torch and CUDA versions,
   whether PyYAML, OpenCV and the native chip set-cover library are
   present, and the kernels' build time (the kernels are built from csrc/
   at first use, one nvcc per source in parallel, into
   build/sniper_tpu_torch/).
2. Each hand-written kernel against its plain torch version on the card,
   in the same dtype, with TF32 off: the forward kernels at the shapes the
   inference path gives them at each test scale, at the smallest canvas
   tier of AutoFocus's finer scales (configs/sniper_res101_e2e_autofocus.yml:
   FocusChips on 16x20 and 24x32 maps, 300 rois per image) and at the
   training shapes of configs/sniper_res101_e2e.yml, the two backward kernels
   (pool and DCN im2col) at the training shapes, at zero offsets (every
   sample on a kink) and at random offsets, the pool and its backward also
   at P=14 at the mask branch's training shapes (16 chips of 50 rois on
   32x32 maps), the pool at P=14 also at the mask branch's inference shapes
   and the FocusChip tiers, and the ROI patch extraction at the box
   head's shapes (P=7, E=36: phase 11's path) and the mask branch's (P=14,
   E=64) of every test scale in fp32 and bf16, with the whole patch route
   of the 7x7 and 14x14 pools held against the composed-tent pool kernels,
   the trunk's unit epilogue (its forms at R101's and X101's stage 1 and 3
   shapes of scale 0 and at a FocusChip tier, in bf16 ulps), and
   NMS through both entries (``nms`` sorting unsorted input, ``nms_sorted``,
   the proposal op's, on it sorted) on clustered boxes with distinct scores
   and on saturated ones, tied and repeated as a random RPN emits them: the
   errors, the kernel's and the plain version's times (the im2col's and its
   backward's also as an effective rate, the backward's at zero, +-0.5 px
   and +-6 px offsets, the pool's and its backward's per pass), the least
   time the card could take (bytes over 3.35 TB/s or fp32 operations over
   67 TFLOP/s, whichever is larger) and, where one PyTorch call computes
   the same function, that call's time.
3. Inference end to end at full R101 width with seeded random weights:
   (a) the kernel path against the plain path on a small input, (b) the
   port's run_detection over a few synthetic 640x480 images, with the
   kernels' launch counters zeroed just before and read just after (every
   unit epilogue fused, EPILOGUES_FORWARD a counted forward: the counters
   count the eager calls and each signature's capture of its CUDA graph,
   main_test.make_forward, and not the replays, which run no kernel
   wrapper), (c) per-scale forward times on the host clock: a smoke
   reading (median and spread over E2E_REPS passes), not a benchmark, and
   each scale's replayed call against its eager one (a no-op forward hook
   keeps it eager) by the hand kernels' launches in their device traces
   (``replay_check``).
4. Mask-branch inference of configs/sniper_res101_e2e_mask.yml at full
   width and depth with seeded random weights, its 14x14 pool on the fused
   pool kernels (4 pool launches per batch, none of the patch extraction):
   (a) the kernel path against
   the plain path on a small input, (b) run_detection with masks over the
   synthetic images of phase 3, counters zeroed just before and read just
   after, with the aggregated masks of one image pasted and RLE-encoded, (c)
   per-scale forward times (median and spread over MASK_REPS passes), img/s
   and peak memory: a smoke reading, and phase 3 (c)'s replay check; (d)
   one scale-0 batch (a signature's first call, so eager) under
   utils/profiler.device_trace: the ``sniper/mask`` span's device and host
   ms and launches (benchmark/core/spans.table), and the mask branch's roi
   counter (models/detector.MASK_ROIS), which must read B x N.
5. Training at full R101 width: (a) one step's losses and named gradients,
   kernel path against plain path, on 2 chips of 256x256 with an fp32
   trunk; (g) the step's CUDA graph (train/trainer.py) at 16 chips of
   512x512: trainer.GRAPH_WARMUP eager steps then GRAPH_STEPS replayed
   ones, per step eager or replayed, host ms inside the call and device ms
   around it, and the replay share; then the flagship recipe of
   configs/sniper_res101_e2e.yml
   (scripts/train_neg_props_and_sniper.sh's phases) over N_TRAIN_IMAGES
   synthetic images at BATCH_IMAGES 16 and 512x512 chips:
   (r1) a synthetic ImageNet-style R101 backbone written as an MXNet
   .params file and imported with load_pretrained, every loaded tensor
   held against the file; (r2) RPN-only training (TRAIN.ONLY_PROPOSAL):
   the one-step check of (a) for the RPN-only detector, then run_training
   from the imported backbone, its checkpoint written; (r3) proposal
   extraction (TEST.EXTRACT_PROPOSALS) from that checkpoint, restored by
   restore_inference_state, over the training images at the three test
   scales, the kernel path against the plain path on a small batch first;
   (r4) the recipe's SNIPER training from the same backbone with negative
   chips mined from the extracted proposals, twice with the same steps:
   the thread loader, then the loader process (TRAIN.LOADER_PROCESS). Each
   run_training takes WARMUP_STEPS then TIMED_STEPS steps, with the counters
   zeroed just before and read after every step: every step's losses, the
   step times on the host clock (a smoke reading), chips per second, peak
   memory, the loader's own time per batch and the kernels' launches:
   the host's by the kernels' counters, and every step's own in the run's
   device trace (a replay runs no kernel wrapper); every step after the
   warm-up's eager ones replays the step's CUDA graph (every run_training
   of every phase, but for the NCCL group of (d2), which stays eager and
   says why), and every step's trace holds the first step's launches.
   Then configs/sniper_res101_e2e_mask.yml's training from the same
   pieces: (m1) the one-step check of (a) with the mask branch; (m2)
   run_training from (r1)'s backbone with negative chips from (r3)'s
   proposals over the same images, each GT with an ellipse polygon,
   checking every step's launches (X1 3, X2 3, NMS 1, pool 4, its backward
   4, the patch extraction 0), that mask_loss moves and that the mask
   layers get finite gradients, nonzero in the run; (m3) main_test's
   restore of its checkpoint and run_detection with masks on two images,
   its class threshold lowered to below the restored model's top scores so
   that it keeps detections. Then configs/sniper_res101_e2e_autofocus.yml's
   training from the same pieces (phase 6, (t1)-(t3)).
6. AutoFocus (configs/sniper_res101_e2e_autofocus.yml) at full width and
   depth with seeded random weights. Inference, after phase 4: (a) the
   kernel path against the plain path on one FocusChip batch of scale 1's
   smallest tier (focus_prob, cls_prob, bbox_pred within phase 3 (a)'s
   1e-3, rois identical); (b) run_detection coarse to fine with the head's
   own maps, counters zeroed just before and read just after: FocusChips
   and percent of pixels per scale, launches; (c) run_detection with the
   maps that add_chips receives replaced from outside by centred binary
   blobs at AF_DENSITIES of each chip (a random head's maps sit near 0.5,
   above both thresholds, and would focus every pixel), then the same
   config with TEST.AUTO_FOCUS off (the full pyramid over the same scales
   and batches): per-scale ms per batch (median and min-max over AF_REPS
   host-clocked passes, a smoke reading), img/s, percent of pixels,
   add_chips' host ms per image and peak memory; (d)
   configs/sniper_res101_e2e_mask_autofocus.yml with planted maps over two
   images, masks pasted and RLE-encoded. Training, after the mask yml's:
   (t1) the one-step check of 5 (a) with FocusPixel labels, focus_loss and
   the head's gradients; (t2) run_training from (r1)'s backbone with (r3)'s
   negative chips, the thread loader, every step's launches checked (X1 3,
   X2 3, NMS 1, pool 2, its backward 2, the patch extraction 0),
   focus_loss moving, the head's gradients finite and nonzero at every
   step; (t3) main_test's restore of its checkpoint and run_detection
   coarse to fine on two images.
7. The model zoo at full width and depth with seeded random weights, over
   phase 3's synthetic images and phase 5's synthetic roidb: ResNeXt-101
   (configs/sniper_res101_e2e.yml with ``symbol resnext_mx_101``, the CLI's
   ``--set`` form) and MobileNetV2 (configs/sniper_mobilenetv2_e2e.yml).
   (z1) X101 inference: (a) the kernel path against the plain path on a
   small input (phase 3 (a)'s bounds), (b) run_detection at the flagship
   scales and batches, counters zeroed just before and read just after,
   per counted forward (phase 3 (b)) exactly X1 3, NMS 1, pool 2, and none
   of X2, the pool's backward and the patch extraction, (c) per-scale ms
   per batch (median and min-max over ZOO_REPS passes), img/s, peak memory,
   the trunk's share of one batch's forward device time and phase 3 (c)'s
   replay check; (z2) X101 training: the
   one-step check of 5 (a) (the C5 grouped conv2_weight and offset among
   the leaves), a synthetic X101 backbone written from mapping_rows and
   imported by load_pretrained (which first raises under the yml's
   FIXED_PARAMS, as the JAX import does: stage 1's sc_bn has no import
   row), run_training at 16 chips of 512x512 for WARMUP_STEPS +
   ZOO_TIMED_STEPS steps with every step's launches exactly X1 3, X2 3,
   NMS 1, pool 2, its backward 2, the patch extraction 0, then main_test's
   restore and run_detection on two images; (z3) and (z4) the same for
   MobileNetV2 with no DCN launch (X1 0, X2 0), no backbone (the JAX import
   maps no MobileNetV2 trunk weight) and its first_conv bit for bit
   unmoved by the steps (FIXED_PARAMS). Phase 2 holds the kernels at these
   models' shapes too: X1 at X101's C5 width (2048 channels, 512 per
   deformable group) at inference scale 0 and training, with the time of
   the grouped product after it, X2 there at training, and NMS, the pool
   and its backward at MobileNetV2's stride-32 maps.
8. Data parallelism (parallel/, configs/sniper_res101_e2e.yml at full
   width and depth). (d1) One training step on 2 gloo ranks sharing the
   one card (NCCL refuses two ranks on a card), 8 + 8 of 16 chips of
   512x512, sync BatchNorm, fp32 trunk, DDP, through the kernels, against
   the one-process step on the 16 joined chips with the same sampler
   priorities (rank 1's chips sample fewer anchors, so the ranks' valid
   counts differ): the losses, named gradients and the training
   BatchNorms' running-statistics update within the one-process step's own
   spread under pool and BatchNorm noise (scripts/dp_step_controls.py
   shows planted faults failing this gate), the ranks' gradients, updated
   leaves and statistics identical, each rank's launches one step's. (d2) main_train.run_training of the
   recipe (bf16, 16 chips of 512x512) as the one rank of an NCCL group and
   in one process, in turns (one process, NCCL, NCCL, one process),
   WARMUP_STEPS + DP_TIMED_STEPS steps each with every step's launches
   exact: the median ms per step of each. (d3) main_test.make_forward over
   two replicas on the card, bit for bit one replica's output on the same
   halves with the rois' batch index global, and a batch of 3 refused.
   Each path's launches go into the JSON line.
9. The remaining options at full width and depth, from (r1)'s backbone and
   (r3)'s proposals (phase 5), each sub-phase a stage of
   utils/profiler.StageTimer, whose report it prints. (o1) OHEM
   (TRAIN.ENABLE_OHEM on the flagship yml, BATCH_ROIS_OHEM 128 of 300 rois
   per chip): the one-step check of 5 (a) with OHEM, then run_training for
   WARMUP_STEPS + OPT_TIMED_STEPS steps with every step's launches exact
   (X1 3, X2 3, NMS 1, pool 2, its backward 2), and the rois each chip
   kept (min / median / max, every one at least 128). (o2)
   configs/sniper_res101_e2e_mask_autofocus.yml's training (the mask
   branch and the FocusPixel head together, all six losses): the same
   steps, the pool and its backward 4 each per step, mask_loss and
   focus_loss above 0 at the first step and moving. (o3) TRAIN.VISUALIZE on
   the flagship yml, dumps every VIS_FREQ steps over VIS_STEPS: the
   loader's chip renderings and the prediction dumps (pkl with the JAX
   payload's keys, jpg) read back, each dump's launches exactly one test
   forward's (X1 3, NMS 1, pool 2), ms per dump. (o4) demo.detect on a
   synthetic 640x480 JPEG with the seeded weights saved as a checkpoint and
   restored as the CLI restores them: one batch-1 test forward's launches
   per scale, the rendered image written, seconds per image; one detect
   under utils/profiler.device_trace, whose Chrome trace names the csrc
   kernels (its size printed); and one pass of scale 0 through
   Tester.get_detections(per_chip_nms=True), equal to the NumPy soft-NMS of
   the same forward's per-class detections. Each path's launches go into
   the JSON line.

10. The bench (sniper_tpu_torch/bench.py) of R101 once, as
   ``python -m sniper_tpu_torch.bench`` runs it: the three-scale pyramid,
   the training step on a resident batch, the fed pipeline over 96 JPEGs
   and the AutoFocus sweep over 32 images, the counters zeroed just before
   and read just after: its line has every key of bench.py's, each MFU
   lies in (0, 1], the FLOP counts are the full-width closed form's
   (BENCH_FLOPS, BENCH_STEP_FLOPS) and every kernel of the main path
   launched. The line is printed before the card's.
11. R101 box inference with ``--set network.POOL_KERNEL pallas``: the
   R-CNN head's inference pool on the patch route (the ROI patch
   extraction P5, then torch ops), with phase 3's seeded weights, images
   and shapes. (a) one batch per scale against the same weights on the
   fused route: rois bit for bit, cls_prob and bbox_pred within
   PALLAS_ATOL; (b) run_detection with the counters zeroed just before and
   read just after; in both, every batch's launches exactly P5
   ceil(B*rois/PATCH_ROI_CHUNK) (19 / 25 / 13 at scales 0 / 1 / 2), X1 3,
   NMS 1 and no fused pool; (c) per scale, the whole forward's ms per
   batch on each route (host clock, in turns), the pool alone on each
   (CUDA events; scale 0's patch route also by kernel, torch.profiler)
   and the pallas route's peak memory.

The second-to-last line is a JSON object with one entry per kernel (its
launches from the mask inference run, from phase 11's run for the patch
extraction, or from the recipe's training run for the two backward
kernels, with every path's counts beside them, the mask training's,
AutoFocus's, the model zoo's and data parallelism's among them, and phase
9's and 11's); the
last line is {"ok": true, "device": {...}}. Without a CUDA device the
script raises at once.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# a stand-in dataset that counts and checks the aggregated detections
from sniper_tpu_torch.bench_autofocus import Detections

CONFIG = "configs/sniper_res101_e2e.yml"
MASK_CONFIG = "configs/sniper_res101_e2e_mask.yml"
AF_CONFIG = "configs/sniper_res101_e2e_autofocus.yml"
AF_MASK_CONFIG = "configs/sniper_res101_e2e_mask_autofocus.yml"
N_IMAGES = 8
IM_W, IM_H = 640, 480
E2E_REPS = 15  # timed passes over each scale's batches in phase 3 (c)
MASK_REPS = 5  # the same for phase 4 (c)
# the card's published peaks (NVIDIA H100 SXM data sheet) for bound_ms
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # fp32 outside the tensor cores
N_TRAIN_IMAGES = 40  # synthetic roidb of the recipe, before flips
# 25 timed steps: the ~4 batches the loaders buffer during the warm-up
# weigh little in the median
WARMUP_STEPS, TIMED_STEPS = 3, 25


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


REPLAY_TRACES = 3  # traces of a replayed and of an eager call each


def replay_check(fwd, model, data, im_info) -> tuple[bool, str]:
    """A make_forward signature's replayed call against its eager one (a
    no-op forward hook keeps it eager), each traced REPLAY_TRACES times on
    its own (cuda.traced_call): a replay runs no kernel wrapper, so only a
    trace sees its launches. The hand kernels' most launches over each's
    traces (the profiler can lose a record) must agree, and every replayed
    call must have replayed. Returns (ok, the reading)."""
    from sniper_tpu_torch.ops import cuda

    fwd(data, im_info)  # the signature's capture, where it has none yet
    replayed, eager, reasons = [], [], []
    for _ in range(REPLAY_TRACES):
        replayed.append(cuda.traced_call(lambda: fwd(data, im_info))[1])
        reasons.append(fwd.eager_reason)
        h = model.register_forward_hook(lambda *a: None)
        try:
            eager.append(cuda.traced_call(lambda: fwd(data, im_info))[1])
        finally:
            h.remove()
    r, e = cuda.most_launches(replayed), cuda.most_launches(eager)
    good = (r == e and any(e.values())
            and all(x is None for x in reasons))
    return good, (f"replayed call's hand-kernel launches (most of "
                  f"{REPLAY_TRACES} traces) {r}, the eager call's {e}, "
                  f"every replayed call replayed "
                  f"{all(x is None for x in reasons)}: "
                  f"{'PASS' if good else 'FAIL'}")


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time in ms the card could take: the larger of the bytes
    that must move over the memory rate and the fp32 operations over the
    fp32 peak, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def result(ok, err, ms, plain_ms, nbytes, ops, library_ms=None) -> dict:
    b_ms, b_by = bound(nbytes, ops)
    return dict(ok=bool(ok), err=float(err), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)


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
    from sniper_tpu_torch.chips import _native

    native = _native.load() is not None
    print(f"native chip set-cover {_native._SO}: "
          f"{'loaded' if native else 'absent (the NumPy set-cover runs)'}")
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


def post_nms(cfg, s: int) -> int:
    """Scale s's post-NMS roi count by the program's own rule
    (main_test._scale_post_nms) on the config's model, built on the meta
    device (no weights are made)."""
    from sniper_tpu_torch.main_test import _scale_post_nms
    from sniper_tpu_torch.models.registry import get_model

    with torch.device("meta"):
        model = get_model(cfg)
    return _scale_post_nms(cfg, s, model)


def main_path_shapes(cfg) -> list[dict]:
    """Per test scale, the shapes the main path gives the kernels: the
    landscape canvas at the config's stride (16, or 32 for MobileNetV2), the
    batch, the post-NMS roi count."""
    from sniper_tpu_torch.data.test_loader import canvas_for_scale

    stride = int(cfg.network.RPN_FEAT_STRIDE)
    shapes = []
    for s, spec in enumerate(cfg.TEST.SCALES):
        (ch, cw), _ = canvas_for_scale(spec)
        shapes.append(dict(
            label=f"scale {s}", B=int(cfg.TEST.BATCH_IMAGES[s]),
            H=ch // stride, W=cw // stride, stride=stride,
            rois=post_nms(cfg, s),
            pre_nms=int(cfg.TEST.RPN_PRE_NMS_TOP_N)))
    return shapes


def focus_tier_shapes(acfg) -> list[dict]:
    """AutoFocus's FocusChips at every scale after the coarsest, in the
    smallest canvas tier they bin into (the smallest maps the kernels see
    on a path): the landscape tier at stride 16, the scale's batch and
    post-NMS roi count."""
    from sniper_tpu_torch.data.test_loader import (
        canvas_for_scale,
        tier_canvases,
    )

    shapes = []
    for s in range(1, len(acfg.TEST.SCALES)):
        land, _ = canvas_for_scale(acfg.TEST.SCALES[s])
        th, tw = tier_canvases(land)[0]
        shapes.append(dict(
            label=f"autofocus scale {s} tier {th}x{tw}",
            B=int(acfg.TEST.BATCH_IMAGES[s]),
            H=th // acfg.network.RPN_FEAT_STRIDE,
            W=tw // acfg.network.RPN_FEAT_STRIDE, rois=post_nms(acfg, s),
            pre_nms=int(acfg.TEST.RPN_PRE_NMS_TOP_N)))
    return shapes


NMS_INPUTS = ("clustered", "saturated")


def nms_input(kind: str, B: int, N: int, H: int, W: int, seed: int):
    """Unsorted boxes [B,N,4] and scores [B,N] on the CPU, on an image of
    W x H px. "clustered": 60 clusters of jittered boxes with distinct
    scores. "saturated": as a random-weight RPN emits them after the decode
    and clip, large boxes of which 40% repeat 30 boxes per image (the whole
    image among them), 1% inverted (area <= 0), half the scores exactly 1.0
    and a third on a 1/256 grid below it (ties), 5% at NEG_INF (the
    min-size filter)."""
    g = torch.Generator().manual_seed(seed)
    if kind == "clustered":
        span = torch.tensor([W, H], dtype=torch.float32)
        ctr = torch.rand(B, 60, 2, generator=g) * span
        pick = torch.randint(0, 60, (B, N), generator=g)
        c = torch.gather(ctr, 1, pick[..., None].expand(B, N, 2))
        c = c + torch.randn(B, N, 2, generator=g) * 24.0
        wh = torch.exp(torch.randn(B, N, 2, generator=g) * 0.5) * 96.0
        boxes = torch.cat([c - wh / 2, c + wh / 2], dim=-1)
        # distinct scores: a random permutation of N levels (no ties)
        scores = torch.stack([torch.randperm(N, generator=g)
                              for _ in range(B)])
        return boxes, (scores.float() + 1.0) / (N + 1)
    from sniper_tpu_torch.ops.nms import NEG_INF

    hi = torch.tensor([W - 1.0, H - 1.0, W - 1.0, H - 1.0])

    def large(n):
        c = torch.rand(B, n, 2, generator=g) * torch.tensor([W, H])
        wh = torch.exp(torch.randn(B, n, 2, generator=g) * 0.7) * 600.0
        b = torch.cat([c - wh / 2, c + wh / 2], dim=-1)
        return torch.minimum(b.clamp_min(0.0), hi)

    reps = large(30)
    reps[:, 0] = torch.tensor([0.0, 0.0, W - 1.0, H - 1.0])
    boxes = large(N)
    u = torch.rand(B, N, generator=g)
    pick = torch.randint(0, 30, (B, N), generator=g)
    boxes = torch.where((u < 0.4)[..., None],
                        torch.gather(reps, 1, pick[..., None].expand(B, N, 4)),
                        boxes)
    inv = (u > 0.99)[..., None]
    boxes = torch.where(inv, boxes[..., [2, 3, 0, 1]] - 2.0, boxes)
    v = torch.rand(B, N, generator=g)
    scores = torch.where(
        v < 0.5, 1.0,
        torch.where(v < 0.8, 1.0 - torch.randint(1, 26, (B, N), generator=g)
                    / 256.0, torch.rand(B, N, generator=g)))
    return boxes, torch.where(v > 0.95, NEG_INF, scores).float()


def check_nms(dev, sh):
    """Both entries against the plain version on both inputs: ``nms`` on
    unsorted input, ``nms_sorted`` (the proposal op's) on that input
    sorted as the top-k leaves it. The result's time is the sorted entry's
    on the clustered input."""
    from sniper_tpu_torch.ops.nms import nms, nms_plain, nms_sorted

    B, N, max_out, thresh = sh["B"], sh["pre_nms"], sh["rois"], 0.7
    out = None
    for kind in NMS_INPUTS:
        st = sh.get("stride", 16)
        boxes, scores = nms_input(kind, B, N, sh["H"] * st, sh["W"] * st, 1)
        boxes, scores = boxes.to(dev), scores.to(dev)
        s_scores, order = torch.sort(scores, dim=1, descending=True,
                                     stable=True)
        s_boxes = torch.gather(boxes, 1, order[..., None].expand(B, N, 4))
        pairs = [(nms(boxes, scores, max_out, thresh),
                  nms_plain(boxes, scores, max_out, thresh)),
                 (nms_sorted(s_boxes, s_scores, max_out, thresh),
                  nms_plain(s_boxes, s_scores, max_out, thresh))]
        torch.cuda.synchronize()
        same = all(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
                   for k, p in pairs)
        diff = max(int((k[0].long() - p[0].long()).abs().max())
                   for k, p in pairs)
        ms = time_ms(lambda: nms(boxes, scores, max_out, thresh), 20)
        sorted_ms = time_ms(
            lambda: nms_sorted(s_boxes, s_scores, max_out, thresh), 20)
        plain_ms = (time_ms(lambda: nms_plain(s_boxes, s_scores, max_out,
                                              thresh), 2)
                    if out is None else out["plain_ms"])
        kept = int(pairs[1][0][1].sum())
        # bytes: boxes and scores in, keep and valid out; operations: ~14
        # fp32 ops for the IoU test of every kept box against every
        # candidate
        r = result(same, diff, sorted_ms, plain_ms,
                   B * N * 20 + B * max_out * 5, 14.0 * kept * N)
        print(f"nms [{sh['label']}, {kind}]: B={B} N={N} -> {max_out} at "
              f"{thresh}: keep lists {'identical' if same else 'DIFFER'} "
              f"for both entries (max index diff {diff}), {kept} kept; "
              f"nms_sorted {sorted_ms:.4f} ms, nms with its sort "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), no single torch "
              f"call")
        if out is None:
            out = r
        else:
            out.update(ok=out["ok"] and r["ok"], err=max(out["err"], diff))
    return out


def check_im2col(dev, sh):
    from sniper_tpu_torch.ops.deform import (
        deform_im2col,
        deform_im2col_plain,
    )

    B, H, W, C, G, K, d = sh["B"], sh["H"], sh["W"], sh.get("C5", 512), 4, 3, 2
    CG = sh.get("conv_groups", 1)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(B, H, W, C, generator=g).to(dev, torch.bfloat16)
    # +-6 px offsets: many samples leave the map and clamp onto its border
    off = ((torch.rand(B, H, W, G * K * K * 2, generator=g) * 2 - 1) * 6.0)
    off = off.to(dev)
    # with conv groups (ResNeXt's C5) the col is written group-major
    kw = dict(num_groups=G, kernel_size=K, dilation=d, conv_groups=CG)
    a = deform_im2col(x, off, **kw)
    b = deform_im2col_plain(x, off, **kw)
    torch.cuda.synchronize()
    err = (a.float() - b.float()).abs()
    ok = bool((err <= 2.0 ** -8 * b.float().abs()).all())
    exact = bool(torch.equal(a, b))
    del a, b
    ms = time_ms(lambda: deform_im2col(x, off, **kw), 20)
    plain_ms = time_ms(lambda: deform_im2col_plain(x, off, **kw), 2)
    xg, grid = im2col_as_grid_sample(x, off, G, K, d)
    lib_ms = time_ms(lambda: torch.nn.functional.grid_sample(
        xg, grid, mode="bilinear", padding_mode="border",
        align_corners=True), 10)
    KK = K * K
    nbytes = x.numel() * 2 + off.numel() * 4 + B * H * W * KK * C * 2
    r = result(ok, err.max(), ms, plain_ms, nbytes,
               7.0 * B * H * W * KK * C, lib_ms)
    del xg, grid
    layout = (f"col group-major over {CG} conv groups" if CG > 1
               else "col [B,H,W,K*K,C]")
    print(f"deform_im2col [{sh['label']}]: x [{B},{H},{W},{C}] bf16, G={G}, "
          f"dilation {d}, offsets +-6 px, {layout}: max abs err "
          f"{float(err.max()):.3e}, bit-exact {exact}; kernel {ms:.4f} ms "
          f"({nbytes / ms / 1e6:.0f} GB/s effective), plain {plain_ms:.4f} "
          f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
          f"{nbytes / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e9:.0f} GB/s), "
          f"library F.grid_sample (fp32) {lib_ms:.4f} ms"
          + c5_conv(x, off, CG))
    torch.cuda.empty_cache()
    return r


def c5_conv(x, off, CG: int) -> str:
    """With ``CG`` conv groups (ResNeXt's C5): the time of the whole
    deformable conv, bf16, forward (X1, then ``grouped_product`` on the
    group-major col as X1 writes it: the batched product and the output's
    reorder) and forward + backward (the product's gradients, X2 on the
    group-major gcol), and of the product alone; "" for CG = 1."""
    if CG == 1:
        return ""
    from sniper_tpu_torch.ops import deform

    B, H, W, C = x.shape
    kw = dict(num_groups=4, kernel_size=3, dilation=2, conv_groups=CG)
    col = deform.deform_im2col(x, off, **kw)
    w = torch.randn(C, C // CG, 3, 3, device=x.device,
                    dtype=torch.bfloat16) * 0.02
    product_ms = time_ms(lambda: deform.grouped_product(col, w, (B, H, W)),
                         5)
    del col
    with torch.no_grad():
        fwd_ms = time_ms(lambda: deform.deformable_conv(x, off, w, **kw), 5)
    xr = x.detach().requires_grad_()
    offr = off.detach().requires_grad_()
    wr = w.detach().requires_grad_()
    gout = torch.randn(B, H, W, C, device=x.device, dtype=torch.bfloat16)

    def step():
        deform.deformable_conv(xr, offr, wr, **kw).backward(gout)

    both_ms = time_ms(step, 5)
    return (f"; the C5 conv ({CG} conv groups, the col group-major, no "
            f"copy) forward {fwd_ms:.4f} ms, of which the grouped product "
            f"{product_ms:.4f} ms; forward + backward {both_ms:.4f} ms")


def im2col_as_grid_sample(x, off, G, K, d):
    """The im2col as F.grid_sample's inputs (the library yardstick, in
    fp32: the grid shares the input's dtype): x as [B*G, C/G, H, W] and the
    clamped sample points as a [B*G, H, W*K*K, 2] grid, align_corners=True
    and border padding being the JAX package's clamp rule."""
    B, H, W, C = x.shape
    KK = K * K
    half = (K - 1) // 2 * d
    xg = (x.float().reshape(B, H, W, G, C // G).permute(0, 3, 4, 1, 2)
          .reshape(B * G, C // G, H, W).contiguous())
    o = off.float().reshape(B, H, W, G, KK, 2)
    t = torch.arange(KK, device=x.device)
    ty = ((t // K) * d - half).float()
    tx = ((t % K) * d - half).float()
    sy = torch.arange(H, device=x.device).float()[None, :, None, None, None]
    sx = torch.arange(W, device=x.device).float()[None, None, :, None, None]
    gy = (sy + ty + o[..., 0]) * (2.0 / (H - 1)) - 1.0
    gx = (sx + tx + o[..., 1]) * (2.0 / (W - 1)) - 1.0
    grid = torch.stack([gx, gy], dim=-1)  # [B,H,W,G,KK,2]
    grid = grid.permute(0, 3, 1, 2, 4, 5).reshape(B * G, H, W * KK, 2)
    return xg, grid.contiguous()


def random_rois(B, rpi, H, W, g, stride=16):
    """Image-contiguous rois [B*rpi, 5] over a map of H x W cells at
    ``stride``: corners up to 60 px past the canvas, sides 8 to 800 px."""
    R = B * rpi
    rois = torch.zeros(R, 5)
    rois[:, 0] = torch.arange(B).repeat_interleave(rpi).float()
    span = torch.tensor([W * stride + 120.0, H * stride + 120.0])
    xy = torch.rand(R, 2, generator=g) * span - 60
    wh = torch.exp(torch.rand(R, 2, generator=g) * math.log(100.0)) * 8.0
    rois[:, 1:3], rois[:, 3:5] = xy, xy + wh
    return rois


def check_pool(dev, sh):
    from sniper_tpu_torch.ops import deform

    B, rpi, C, H, W = sh["B"], sh["rois"], 256, sh["H"], sh["W"]
    P, S, M = sh.get("P", 7), 4, 4
    st = sh.get("stride", 16)
    g = torch.Generator().manual_seed(3)
    feat = torch.randn(B, H, W, C, generator=g).to(dev)
    R = B * rpi
    rois = random_rois(B, rpi, H, W, g, st).to(dev)
    # the FC's output spread grows with P: 7/P keeps P=14's like P=7's
    off_w = (torch.randn(2 * P * P, P * P * C, generator=g)
             * (0.03 * 7 / P)).to(dev)
    off_b = (torch.randn(2 * P * P, generator=g) * 0.3).to(dev)

    geom, roi_h, roi_w, sub_h, sub_w = deform.pool_geometry(
        rois, P=P, S=S, M=M, spatial_scale=1 / st)
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
                                      rois_per_image=rpi, pooled_size=P,
                                      spatial_scale=1 / st)
    torch.cuda.synchronize()
    ok, worst, parts = True, 0.0, []
    for name, a, b in (("pass A", pass1_k, pass1_p),
                       ("pass B", pooled_k, pooled_p),
                       ("two-pass", full_k, pooled_p.reshape(R, -1))):
        err = float((a - b).abs().max())
        ok &= bool(torch.allclose(a, b, atol=POOL_ATOL, rtol=POOL_RTOL))
        worst = max(worst, err)
        parts.append(f"{name} {err:.3e}")
    ms_a = time_ms(lambda: deform.pool_pass(feat, geom, None, **kw), 10)
    ms_b = time_ms(lambda: deform.pool_pass(feat, geom, pypx, **kw), 10)
    ms = ms_a + ms_b
    plain_ms = (
        time_ms(lambda: deform.pool_pass_plain(feat, geom, None, **kw), 2)
        + time_ms(lambda: deform.pool_pass_plain(feat, geom, pypx, **kw), 2))
    # two passes: each reads the map and the geometry (pass B also the
    # window starts) and writes [R, P*P, C] fp32; each bin averages S*S
    # bilinear samples of four taps (8 fp32 ops per sample and channel)
    r = result(ok, worst, ms, plain_ms,
               2 * (feat.numel() * 4 + R * 16 + R * P * P * C * 4)
               + R * 2 * P * P * 4, 2 * 8.0 * R * P * P * S * S * C)
    print(f"fused_pool [{sh['label']}]: P={P} B={B} rpi={rpi} C={C} map "
          f"{H}x{W} at stride {st}, "
          f"{clamped:.1%} of window starts on the margin clamp; max abs err "
          f"{', '.join(parts)}; kernel pass A {ms_a:.4f} ms + pass B "
          f"{ms_b:.4f} ms = {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}), no single torch call")
    return r


def train_shapes(cfg) -> dict:
    """The training path's shapes: a batch of chips at the config's stride,
    the sampled rois per chip, conv_new_1's 256 channels, the C5 mid width
    (ResNet-101's)."""
    return dict(label="training", B=int(cfg.TRAIN.BATCH_IMAGES),
                H=cfg.TRAIN.CHIP_SIZE // cfg.network.RPN_FEAT_STRIDE,
                W=cfg.TRAIN.CHIP_SIZE // cfg.network.RPN_FEAT_STRIDE,
                stride=int(cfg.network.RPN_FEAT_STRIDE),
                rois=int(cfg.TRAIN.RPN_POST_NMS_TOP_N),
                pre_nms=int(cfg.TRAIN.RPN_PRE_NMS_TOP_N), C=256, C5=512,
                M=int(getattr(cfg.network, "HEAD_MARGIN_BINS", 1)) * 4,
                chip=int(cfg.TRAIN.CHIP_SIZE))


def mask_train_shapes(mcfg) -> dict:
    """The mask branch's pool in training: the first NUM_MASK_ROIS sampled
    rois of each chip at P=14 on the chips' maps."""
    from sniper_tpu_torch.models.detector import NUM_MASK_ROIS

    return dict(train_shapes(mcfg), label="mask training", P=14,
                rois=min(NUM_MASK_ROIS, int(mcfg.TRAIN.RPN_POST_NMS_TOP_N)))


def rel_err(a, b) -> float:
    """max |a - b| / max |b|."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def check_pool_bwd(dev, sh):
    """The transposed pool, both modes, at the training shapes: window
    starts from a zero offset FC (every start on an integer, the kinks) and
    from a random one."""
    from sniper_tpu_torch.ops import deform

    B, rpi, C, H, W, M = sh["B"], sh["rois"], sh["C"], sh["H"], sh["W"], sh["M"]
    P, S = sh.get("P", 7), 4
    R = B * rpi
    g = torch.Generator().manual_seed(5)
    feat = torch.randn(B, H, W, C, generator=g).to(dev)
    rois = torch.zeros(R, 5)
    rois[:, 0] = torch.arange(B).repeat_interleave(rpi).float()
    xy = torch.rand(R, 2, generator=g) * (sh["chip"] + 60) - 30
    wh = torch.exp(torch.rand(R, 2, generator=g) * math.log(60.0)) * 8.0
    rois[:, 1:3], rois[:, 3:5] = xy, xy + wh
    rois = rois.to(dev)
    gout = torch.randn(R, P * P, C, generator=g).to(dev)
    geom, roi_h, roi_w, sub_h, sub_w = deform.pool_geometry(
        rois, P=P, S=S, M=M, spatial_scale=1 / sh.get("stride", 16))
    kw = dict(rois_per_image=rpi, P=P, S=S, M=M)
    ok, worst, parts = True, 0.0, []
    for label, scale in (("zero offsets", 0.0), ("random offsets", 0.3)):
        off = (torch.randn(R, 2 * P * P, generator=g) * scale).to(dev)
        pypx = deform.window_starts(off, roi_h, roi_w, sub_h, sub_w, P=P,
                                    S=S, M=M, trans_std=0.1)
        for mode, bins in (("pass B", pypx), ("pass A", None)):
            dk, pk = deform.pool_pass_bwd(feat, geom, bins, gout, **kw)
            dp, pp = deform.pool_pass_bwd_plain(feat, geom, bins, gout, **kw)
            torch.cuda.synchronize()
            errs = [rel_err(dk, dp)] + ([] if bins is None
                                        else [rel_err(pk, pp)])
            ok &= all(e <= POOL_BWD_REL for e in errs)
            worst = max(worst, float((dk - dp).abs().max()),
                        0.0 if bins is None else float((pk - pp).abs().max()))
            parts.append(f"{label} {mode}: dfeat {errs[0]:.2e}"
                         + ("" if bins is None else f", d(py,px) {errs[1]:.2e}"))
    ms_b = time_ms(lambda: deform.pool_pass_bwd(feat, geom, pypx, gout, **kw),
                   5)
    ms_a = time_ms(lambda: deform.pool_pass_bwd(feat, geom, None, gout, **kw),
                   5)
    ms = ms_b + ms_a
    plain_ms = (
        time_ms(lambda: deform.pool_pass_bwd_plain(feat, geom, pypx, gout,
                                                   **kw), 2)
        + time_ms(lambda: deform.pool_pass_bwd_plain(feat, geom, None, gout,
                                                     **kw), 2))
    # two transposed passes: each reads the map, the geometry and g and
    # writes dfeat (pass B also reads the window starts and writes their
    # gradient); per sample, tap and channel the dfeat scatter is 8 fp32
    # ops and pass B's start gradient 8 more
    r = result(ok, worst, ms, plain_ms,
               2 * (2 * feat.numel() * 4 + R * 16 + gout.numel() * 4)
               + 2 * R * 2 * P * P * 4, (16.0 + 8.0) * R * P * P * S * S * C)
    print(f"fused_pool_bwd [{sh['label']}]: P={P} B={B} rpi={rpi} C={C} map "
          f"{H}x{W}, {deform.pool_bwd_smem_bytes(H, W, P)} B of shared "
          f"memory per block; "
          f"max |err| / max |ref|: {'; '.join(parts)}; kernel pass B "
          f"{ms_b:.4f} ms + pass A {ms_a:.4f} ms = {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}), no single torch call")
    return r


def check_im2col_bwd(dev, sh):
    """The DCN im2col's VJP at the C5 training shapes, bf16, at zero
    offsets (a fresh model's), at +-0.5 px (a trained model's small
    offsets: every corner weighs) and at +-6 px (many samples clamp onto
    the border)."""
    from sniper_tpu_torch.ops import deform

    B, H, W, C, G, K, d = sh["B"], sh["H"], sh["W"], sh["C5"], 4, 3, 2
    CG = sh.get("conv_groups", 1)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(B, H, W, C, generator=g).to(dev, torch.bfloat16)
    # gcol in the forward's layout: group-major over ResNeXt's conv groups
    gcol = torch.randn(deform.col_shape(x.shape, K, CG), generator=g).to(
        dev, torch.bfloat16)
    kw = dict(num_groups=G, kernel_size=K, dilation=d, conv_groups=CG)
    ok, worst, parts, offs = True, 0.0, [], []
    for label, scale in (("zero offsets", 0.0), ("offsets +-0.5 px", 0.5),
                         ("offsets +-6 px", 6.0)):
        off = ((torch.rand(B, H, W, G * K * K * 2, generator=g) * 2 - 1)
               * scale).to(dev)
        offs.append(off)
        gx, goff = deform.deform_im2col_bwd(x, off, gcol, **kw)
        px, poff = deform.deform_im2col_bwd_plain(x, off, gcol, **kw)
        torch.cuda.synchronize()
        e_off = rel_err(goff, poff)
        # gx: fp32 sums in another order, each rounded once to bf16; where
        # the sum cancels to near zero the order's own error (the fp32
        # floor) exceeds a bf16 step of the result
        floor = IM2COL_BWD_REL * float(px.float().abs().max())
        steps = (((gx.float() - px.float()).abs() - floor).clamp_min(0.0)
                 / (px.float().abs() * 2.0 ** -8).clamp_min(1e-30))
        n_steps = float(steps.max())
        ok &= e_off <= IM2COL_BWD_REL and n_steps <= 2.0
        worst = max(worst, float((goff - poff).abs().max()),
                    float((gx.float() - px.float()).abs().max()))
        parts.append(f"{label}: goff {e_off:.2e}, gx within {n_steps:.2f} "
                     "bf16 steps")
    # the time at +-6 px is the kernel's; at zero offsets three of a
    # sample's four corner weights are zero
    ms_zero = time_ms(lambda: deform.deform_im2col_bwd(x, offs[0], gcol,
                                                       **kw), 10)
    ms_small = time_ms(lambda: deform.deform_im2col_bwd(x, offs[1], gcol,
                                                        **kw), 10)
    ms = time_ms(lambda: deform.deform_im2col_bwd(x, off, gcol, **kw), 10)
    plain_ms = time_ms(lambda: deform.deform_im2col_bwd_plain(x, off, gcol,
                                                              **kw), 2)
    xg, grid = im2col_as_grid_sample(x, off, G, K, d)
    KK = K * K
    gg = (gcol.float().reshape(CG, B, H, W, KK, C // CG)
          .permute(1, 2, 3, 4, 0, 5).reshape(B, H, W, KK, G, C // G)
          .permute(0, 4, 5, 1, 2, 3).reshape(B * G, C // G, H, W * KK)
          .contiguous())
    lib_ms = time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
        gg, xg, grid, 0, 1, True, [True, True]), 10)
    # x, offsets and gcol in, gx and goff out; per (pixel, tap, channel)
    # ~20 fp32 ops (four corner weights and scatters, the two sample
    # derivatives and their products with gcol)
    nbytes = 2 * x.numel() * 2 + gcol.numel() * 2 + 2 * off.numel() * 4
    r = result(ok, worst, ms, plain_ms, nbytes, 20.0 * gcol.numel(), lib_ms)
    print(f"deform_im2col_bwd [{sh['label']}]: x [{B},{H},{W},{C}] bf16, G={G}, "
          f"dilation {d}, gcol group-major over {CG} conv group(s); "
          f"{'; '.join(parts)}; kernel {ms:.4f} ms at +-6 px "
          f"({nbytes / ms / 1e6:.0f} GB/s effective), {ms_small:.4f} ms at "
          f"+-0.5 px, {ms_zero:.4f} ms at zero offsets, plain "
          f"{plain_ms:.4f} ms, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}, {nbytes / 1e6:.1f} MB at "
          f"{HBM_BYTES_PER_S / 1e9:.0f} GB/s), library "
          f"grid_sampler_2d_backward (fp32) "
          f"{lib_ms:.4f} ms")
    return r


def patch_as_grid_sample(feat, geom, rpi, E):
    """The patch extraction as F.grid_sample's inputs (the library
    yardstick, fp32): the map as [B, C, H, W], each roi's E x E sample
    points as rows of a [B, rpi*E, E, 2] grid (align_corners=True and border
    padding are the clamp rule), and the in-bounds mask that zeroes the
    cells outside (-0.5, n-0.5)."""
    B, H, W, C = feat.shape
    o = torch.arange(E, device=feat.device, dtype=torch.float32)
    pos_y = geom[:, 0:1] + o * geom[:, 2:3]  # [R, E]
    pos_x = geom[:, 1:2] + o * geom[:, 3:4]
    gy = pos_y * (2.0 / (H - 1)) - 1.0
    gx = pos_x * (2.0 / (W - 1)) - 1.0
    grid = torch.stack([gx[:, None, :].expand(-1, E, E),
                        gy[:, :, None].expand(-1, E, E)], dim=-1)
    grid = grid.reshape(B, rpi * E, E, 2).contiguous()
    inb = ((pos_y > -0.5) & (pos_y < H - 0.5))[:, :, None] & (
        (pos_x > -0.5) & (pos_x < W - 0.5))[:, None, :]
    mask = inb.float().reshape(B, 1, rpi * E, E)
    return feat.float().permute(0, 3, 1, 2).contiguous(), grid, mask


def edge_rois(kind, B, rpi, H, W, g, stride=16):
    """Image-contiguous rois [B*rpi, 5] over a map of H x W cells for one
    of P5's edge cases at full size: "off map" (centres within 400 px of
    the map's border on either side, sides 16 to 800 px: wholly off,
    straddling an edge or a corner), "last row and column" (bottom-right
    corners within 2 cells of the map's last row and column: the i0 = n-2
    clamp), "tiny" (sides of 0.1 to 16 px: sub_w << 1, one x0 for many s),
    "whole map" (60 to 110% of the map on each axis: a column window wider
    than one shared-memory stage at E 64)."""
    R = B * rpi
    hi = torch.tensor([W * stride, H * stride], dtype=torch.float32)
    rois = torch.zeros(R, 5)
    rois[:, 0] = torch.arange(B).repeat_interleave(rpi).float()

    def u():
        return torch.rand(R, 2, generator=g)

    if kind == "off map":
        side = torch.where(u() < 0.5, 0.0, 1.0) * hi
        wh = torch.exp(u() * math.log(50.0)) * 16.0
        xy = side + (u() * 2 - 1) * 400.0 - wh / 2
    elif kind == "last row and column":
        wh = torch.exp(u() * math.log(100.0)) * 8.0
        xy = hi + (u() * 4 - 2) * stride - wh
    elif kind == "tiny":
        wh = torch.exp(u() * math.log(160.0)) * 0.1
        xy = u() * (hi - 16.0)
    elif kind == "whole map":
        wh = (0.6 + 0.5 * u()) * hi
        xy = (hi - wh) * u()
    else:
        raise ValueError(kind)
    rois[:, 1:3], rois[:, 3:5] = xy, xy + wh
    return rois


def patch_source_bytes(geom, E, H, W, C, es):
    """The map bytes P5's taps of ``geom``'s rois need: per roi the rows
    and columns some in-bounds tap reads (y0 and y0+1, x0 and x0+1), their
    product, summed over the rois."""
    o = torch.arange(E, device=geom.device, dtype=torch.float32)

    def used(start, step, n):
        pos = start[:, None] + o * step[:, None]
        inb = ((pos > -0.5) & (pos < n - 0.5)).int()
        i0 = pos.clamp(0, n - 1).floor().clamp(max=n - 2).long()
        hit = torch.zeros(len(start), n, dtype=torch.int32,
                          device=geom.device)
        hit.scatter_add_(1, i0, inb).scatter_add_(1, i0 + 1, inb)
        return (hit > 0).sum(1).double()

    cells = used(geom[:, 0], geom[:, 2], H) * used(geom[:, 1], geom[:, 3], W)
    return float(cells.sum()) * C * es


def check_roi_patch_edges(dev, sh):
    """P5's edge cases at the box head's full size (the scale's map, C 256,
    its rois per image, fp32 and bf16 against the plain version, fp32
    timed): the four kinds of ``edge_rois`` on all rois in one launch (the
    whole-map rois at E 64, the others at E 36), then random rois in a
    64-roi launch [rpi-32, rpi+32) that starts mid-image and crosses into
    the next, and a launch of one roi. Bound: the output and the geometry,
    and the map bytes the taps read (``patch_source_bytes``, at most the
    launch's images' maps), over the memory rate. Returns (ok, worst
    error)."""
    from sniper_tpu_torch.ops import deform

    B, rpi, C, H, W = sh["B"], sh["rois"], 256, sh["H"], sh["W"]
    S, M = 4, 4
    g = torch.Generator().manual_seed(11)
    feat32 = torch.randn(B, H, W, C, generator=g).to(dev)
    cases = [(kind, 7 if kind != "whole map" else 14,
              edge_rois(kind, B, rpi, H, W, g), 0, B * rpi)
             for kind in ("off map", "last row and column", "tiny",
                          "whole map")]
    rand = random_rois(B, rpi, H, W, g)
    cases += [("chunk across images", 7, rand, rpi - 32, rpi + 32),
              ("single roi", 7, rand, rpi + 7, rpi + 8)]
    ok, worst, parts = True, 0.0, []
    for kind, P, rois, r0, r1 in cases:
        E = P * S + 2 * M
        geom, *_ = deform.pool_geometry(rois.to(dev), P=P, S=S, M=M,
                                        spatial_scale=1 / 16)
        kw = dict(rois_per_image=rpi, patch_cells=E, r0=r0, r1=r1)
        errs = []
        for dtype in (torch.float32, torch.bfloat16):
            feat = feat32.to(dtype)
            a = deform.extract_patches(feat, geom, **kw)
            b = deform.extract_patches_plain(feat, geom, **kw)
            torch.cuda.synchronize()
            err = (a.float() - b.float()).abs()
            if dtype == torch.float32:
                good = bool(err.max() <= ROI_PATCH_ATOL)
            else:
                good = bool((err <= 2.0 ** -7 * b.float().abs() + 1e-6).all())
            ok &= good
            errs.append(f"{float(err.max()):.3e} "
                        f"{'PASS' if good else 'FAIL'}")
            worst = max(worst, float(err.max()))
            del a, b, err
        ms = time_ms(lambda: deform.extract_patches(feat32, geom, **kw), 5)
        n = r1 - r0
        images = (r1 - 1) // rpi - r0 // rpi + 1
        src = min(patch_source_bytes(geom[r0:r1], E, H, W, C, 4),
                  images * H * W * C * 4)
        b_ms, _ = bound(n * E * E * C * 4 + n * 16 + src, 9.0 * n * E * E * C)
        parts.append(f"{kind} ({n} rois, E {E}): fp32 / bf16 max abs err "
                     f"{' / '.join(errs)}; {ms:.4f} ms fp32, bound "
                     f"{b_ms:.4f} ms ({b_ms / ms:.0%} of it; "
                     f"{src / 1e6:.1f} MB of the map)")
    print(f"roi_patch edges [{sh['label']}]: map {H}x{W}, C {C}; "
          + "; ".join(parts))
    del feat32
    torch.cuda.empty_cache()
    return ok, worst


def check_roi_patch(dev, sh):
    """P5 at the pool's shapes (``sh["P"]``: 7 for the box head under
    network.POOL_KERNEL pallas, E=36; 14 for the mask pool, E=64; S=4,
    margin 1 bin), fp32 (the main path's dtype) and bf16, on all of the
    scale's rois in one call, and in fp32 as the patch route calls it
    (PATCH_ROI_CHUNK rois per launch); then the patch route of the whole
    pool against the composed-tent pool kernels on the same inputs."""
    from sniper_tpu_torch.ops import deform

    B, rpi, C, H, W = sh["B"], sh["rois"], 256, sh["H"], sh["W"]
    P, S, M = sh["P"], 4, 4
    E = P * S + 2 * M
    R = B * rpi
    g = torch.Generator().manual_seed(10)
    feat32 = torch.randn(B, H, W, C, generator=g).to(dev)
    rois = random_rois(B, rpi, H, W, g).to(dev)
    geom, *_ = deform.pool_geometry(rois, P=P, S=S, M=M, spatial_scale=1 / 16)
    kw = dict(rois_per_image=rpi, patch_cells=E)
    ok, worst, parts, timed = True, 0.0, [], {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        feat = feat32.to(dtype)
        a = deform.extract_patches(feat, geom, **kw)
        b = deform.extract_patches_plain(feat, geom, **kw)
        torch.cuda.synchronize()
        err = (a.float() - b.float()).abs()
        if dtype == torch.float32:
            good = bool(err.max() <= ROI_PATCH_ATOL)
        else:
            good = bool((err <= 2.0 ** -7 * b.float().abs() + 1e-6).all())
        ok &= good
        worst = max(worst, float(err.max()))
        del a, b, err
        torch.cuda.empty_cache()
        ms = time_ms(lambda: deform.extract_patches(feat, geom, **kw), 5)
        plain_ms = time_ms(
            lambda: deform.extract_patches_plain(feat, geom, **kw), 1)
        es = feat.element_size()
        # the map and the geometry in, [R, E, E, C] out; 9 fp32 ops per
        # output element (two row blends and one column blend)
        r = result(good, worst, ms, plain_ms,
                   feat.numel() * es + R * 16 + R * E * E * C * es,
                   9.0 * R * E * E * C)
        timed[name] = r
        parts.append(f"{name}: max abs err {r['err']:.3e} "
                     f"{'PASS' if good else 'FAIL'}, kernel {ms:.4f} ms, "
                     f"plain {plain_ms:.4f} ms, bound {r['bound_ms']:.4f} ms "
                     f"({r['bound_ms'] / ms:.0%} of it; {r['bound_by']}, "
                     f"{R * E * E * C * es / 1e9:.2f} GB written)")
    fmap, grid, inb = patch_as_grid_sample(feat32, geom, rpi, E)

    def library():
        return torch.nn.functional.grid_sample(
            fmap, grid, mode="bilinear", padding_mode="border",
            align_corners=True) * inb

    lib_ms = time_ms(library, 5)
    lib_err = float((library().reshape(B, C, rpi, E, E).permute(0, 2, 3, 4, 1)
                     .reshape(R, E, E, C)
                     - deform.extract_patches(feat32, geom, **kw)).abs().max())
    timed["fp32"]["library_ms"] = lib_ms
    del fmap, grid, inb
    torch.cuda.empty_cache()
    step = deform.PATCH_ROI_CHUNK

    def chunked():
        for r0 in range(0, R, step):
            deform.extract_patches(feat32, geom, r0=r0, r1=min(R, r0 + step),
                                   **kw)

    chunked_ms = time_ms(chunked, 3)

    # the patch route (P5, then torch ops) against the P1/P2 kernels, with
    # an offset FC that moves the windows by ~0.5 to 2 cells
    off_w = (torch.randn(2 * P * P, P * P * C, generator=g)
             * (0.003 * 14 / P)).to(dev)
    off_b = (torch.randn(2 * P * P, generator=g) * 0.3).to(dev)
    with torch.inference_mode():
        a = deform.patch_offset_pool(feat32, rois, off_w, off_b,
                                     rois_per_image=rpi, pooled_size=P)
        b = deform.fused_offset_pool(feat32, rois, off_w, off_b,
                                     rois_per_image=rpi, pooled_size=P)
    torch.cuda.synchronize()
    route_err = float((a - b).abs().max())
    route_ok = bool(torch.allclose(a, b, atol=POOL_ATOL, rtol=POOL_RTOL))
    ok &= route_ok
    route_ms = time_ms(lambda: deform.patch_offset_pool(
        feat32, rois, off_w, off_b, rois_per_image=rpi, pooled_size=P), 3)
    fused_ms = time_ms(lambda: deform.fused_offset_pool(
        feat32, rois, off_w, off_b, rois_per_image=rpi, pooled_size=P), 3)
    print(f"roi_patch [{sh['label']}]: B={B} rpi={rpi} C={C} map {H}x{W}, "
          f"E={E}; {'; '.join(parts)}; library F.grid_sample (bilinear, "
          f"border, align_corners) times the in-bounds mask, fp32, "
          f"{lib_ms:.4f} ms (max abs diff from the kernel {lib_err:.3e}, "
          f"its own coordinate rounding; not a check); fp32 as the patch "
          f"route calls it, {math.ceil(R / step)} launches of {step} rois: "
          f"{chunked_ms:.4f} ms")
    print(f"patch route [{sh['label']}]: patch_offset_pool (roi_patch + "
          f"torch ops) vs fused_offset_pool (fused_pool kernels) at P={P}, "
          f"offset FC nonzero: max abs err {route_err:.3e} (tolerance "
          f"atol={POOL_ATOL} rtol={POOL_RTOL}) "
          f"{'PASS' if route_ok else 'FAIL'}; {route_ms:.3f} ms vs "
          f"{fused_ms:.3f} ms for the whole pool")
    del a, b
    torch.cuda.empty_cache()
    if sh.get("edges"):
        good, err = check_roi_patch_edges(dev, sh)
        ok &= good
        worst = max(worst, err)
    out = dict(timed["fp32"])
    out.update(ok=ok, err=worst)
    return out


POOL_ATOL, POOL_RTOL = 1e-4, 1e-4
ROI_PATCH_ATOL = 1e-5
EPILOGUE_ULPS = 1
POOL_BWD_REL = IM2COL_BWD_REL = 1e-4
TOLERANCES = {
    "nms": "identical keep lists (the IoU is computed in nms_jax's fp32 "
           "order, without FMA contraction)",
    "deform_im2col": "one bf16 rounding step (2^-8 relative): both blend in "
                     "fp32 in the same order and round once",
    "fused_pool": f"atol={POOL_ATOL} rtol={POOL_RTOL}: fp32 sums over up to "
                  "~100 taps in another order",
    "deform_im2col_bwd": f"goff within {IM2COL_BWD_REL} * max|ref| (fp32 "
                         "channel sums in another order); gx within two bf16 "
                         f"steps plus {IM2COL_BWD_REL} * max|ref| (fp32 "
                         "atomics in another order, then one rounding)",
    "fused_pool_bwd": f"dfeat and d(py,px) within {POOL_BWD_REL} * max|ref| "
                      "(fp32 atomics and warp sums in another order)",
    "roi_patch": f"fp32 within {ROI_PATCH_ATOL} absolute (the same taps "
                 "blended in fp32; the plain version's dense products sum "
                 "in another order); bf16 within one rounding step of the "
                 "result (2^-7 relative) plus 1e-6; the patch route of the "
                 f"7x7 and 14x14 pools within atol={POOL_ATOL} "
                 f"rtol={POOL_RTOL} of "
                 "the composed-tent kernels (fp32 sums of the same tents in "
                 "another order)",
    "unit_epilogue": f"within {EPILOGUE_ULPS} bf16 ulp (expected 0: the "
                     "kernel computes torch's channels-last BatchNorm "
                     "formula, rsqrtf and one fused multiply-add, and rounds "
                     "where the unfused chain rounds)",
}


def epilogue_shapes(cfg, acfg) -> list[dict]:
    """The unit epilogue's shapes: R101's and X101's stage 1 (stride 4,
    256 channels) and stage 3 (stride 16, 1024) at scale 0's canvas and
    batch, and R101's stage 3 at AutoFocus's smallest FocusChip tier. R101
    runs its boundary (the sum and bn1) at the stage's width and its inner
    BatchNorms at a quarter of it; X101 its inner BatchNorms and its tail
    at the stage's width."""
    s0 = main_path_shapes(cfg)[0]
    tier = focus_tier_shapes(acfg)[0]
    shapes = []
    for trunk in ("r101", "x101"):
        for stage, C, f, units in ((1, 256, 4, 3), (3, 1024, 1, 23)):
            shapes.append(dict(
                label=f"{trunk} {s0['label']} stage {stage}", trunk=trunk,
                B=s0["B"], C=C, H=s0["H"] * f, W=s0["W"] * f, units=units))
    shapes.append(dict(label=f"r101 {tier['label']} stage 3", trunk="r101",
                       B=tier["B"], C=1024, H=tier["H"], W=tier["W"],
                       units=23))
    return shapes


def ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest gap in bf16 ulps of want's magnitude."""
    g, w = got.float(), want.float()
    ulp = torch.ldexp(torch.ones_like(w),
                      torch.frexp(w.abs().clamp_min(2.0 ** -126))[1] - 8)
    return float(((g - w).abs() / ulp).max())


def seeded_bn(C: int, seed: int, dev):
    """A FrozenBatchNorm of C channels with statistics and affine
    parameters away from the identity."""
    from sniper_tpu_torch.models.norm import FrozenBatchNorm

    g = torch.Generator().manual_seed(seed)
    bn = FrozenBatchNorm(C, dtype=torch.bfloat16)
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(C, generator=g) * 0.3)
        bn.running_var.copy_(torch.rand(C, generator=g) * 1.7 + 0.3)
        bn.weight.copy_(torch.rand(C, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(C, generator=g) * 0.2)
    return bn.to(dev).eval()


def check_unit_epilogue(dev, sh):
    """The unit epilogue's forms against their plain versions at one
    stage's shapes: the largest gap in bf16 ulps, the kernel's and the plain
    version's ms (CUDA events) and the bytes bound, per form; the result
    sums one unit's epilogues (R101: the boundary and two inner BatchNorms;
    X101: two inner BatchNorms and the identity tail)."""
    from sniper_tpu_torch.ops import epilogue as ep

    B, C, H, W = sh["B"], sh["C"], sh["H"], sh["W"]
    g = torch.Generator(device=dev).manual_seed(B * C + H * W)

    def act(c):
        return (torch.randn(B, c, H, W, generator=g, device=dev)
                .to(torch.bfloat16).contiguous(memory_format=torch.channels_last))

    cm = C // 4 if sh["trunk"] == "r101" else C
    bn, bn_sc, bn_mid = seeded_bn(C, 1, dev), seeded_bn(C, 2, dev), \
        seeded_bn(cm, 3, dev)
    h, s, m = act(C), act(C), act(cm)
    n, nm = h.numel(), m.numel()
    if sh["trunk"] == "r101":
        forms = (("sum_bn_relu", lambda: ep.sum_bn_relu(h, s, bn, True),
                  lambda: ep.sum_bn_relu_plain(h, s, bn, True), 8 * n, 1),
                 ("bn_relu (C/4)", lambda: ep.bn_relu(m, bn_mid),
                  lambda: ep.bn_relu_plain(m, bn_mid), 4 * nm, 2))
    else:
        forms = (("bn_relu", lambda: ep.bn_relu(h, bn),
                  lambda: ep.bn_relu_plain(h, bn), 4 * n, 2),
                 ("bn_add_relu", lambda: ep.bn_add_relu(h, bn, s),
                  lambda: ep.bn_add_relu_plain(h, bn, s), 6 * n, 1),
                 ("bn_add_relu (projection)",
                  lambda: ep.bn_add_relu(h, bn, s, bn_sc),
                  lambda: ep.bn_add_relu_plain(h, bn, s, bn_sc), 6 * n, 0))
    worst_ulps, worst_abs = 0.0, 0.0
    ms = plain_ms = nbytes = 0.0
    parts = []
    with torch.inference_mode():
        for name, kern, plain, nb, per_unit in forms:
            got, want = kern(), plain()
            if not isinstance(got, tuple):
                got, want = (got,), (want,)
            torch.cuda.synchronize()
            u = max(ulps(a, b) for a, b in zip(got, want))
            e = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(got, want))
            k_ms, p_ms = time_ms(kern, 10), time_ms(plain, 10)
            b_ms = nb / HBM_BYTES_PER_S * 1e3
            worst_ulps, worst_abs = max(worst_ulps, u), max(worst_abs, e)
            ms += per_unit * k_ms
            plain_ms += per_unit * p_ms
            nbytes += per_unit * nb
            parts.append(f"{name} {u:g} ulp, {k_ms:.4f} ms (plain "
                         f"{p_ms:.4f}), bound {b_ms:.4f} ms "
                         f"({100 * b_ms / k_ms:.1f}%)")
    ok = worst_ulps <= EPILOGUE_ULPS
    print(f"  unit_epilogue {sh['label']} [{B},{C},{H},{W}]: "
          + "; ".join(parts)
          + f"; one unit's {ms:.4f} ms against {nbytes / HBM_BYTES_PER_S * 1e3:.4f}"
          f" bound, {3 * sh['units']} launches per batch in the stage "
          f"({sh['units']} units): {'PASS' if ok else 'FAIL'}")
    return result(ok, worst_abs, ms, plain_ms, nbytes, 0.0)


def kernel_phase(dev, cfg, mcfg, acfg, zcfg) -> tuple[bool, list]:
    """Each kernel against its plain version: the forward kernels at every
    test scale's shapes, at AutoFocus's smallest FocusChip tiers and at the
    training shapes (scale 0 first: its times and bound go into the JSON
    line), the pool also at the mask branch's training and inference
    shapes and at the FocusChip tiers (P=14), the backward kernels at the
    training shapes (the pool's also at P=14), the patch extraction at the
    box head's shapes (P=7) and the mask branch's (P=14) of every test
    scale, and the trunk's unit epilogue at R101's and X101's stage 1 and
    3 shapes of scale 0 and a FocusChip tier. The model zoo (phase 7): the
    im2col and its backward at ResNeXt-101's C5 width (2048 channels, 512
    per deformable group; inference scale 0 and training), NMS, the pool
    and its backward at MobileNetV2's stride-32 maps (``zcfg``: every test
    scale and training)."""
    from sniper_tpu_torch.ops import cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    focus = focus_tier_shapes(acfg)
    both = main_path_shapes(cfg) + focus + [train_shapes(cfg)]
    train = [train_shapes(cfg)]
    mask_train = [mask_train_shapes(mcfg)]
    # the mask branch's inference pool: P=14 on the mask config's maps
    mask_infer = [dict(s, P=14, label=f"mask inference {s['label']}")
                  for s in main_path_shapes(mcfg) + focus]
    x101 = [dict(sh, C5=2048, conv_groups=64, label=f"x101 {sh['label']}")
            for sh in (main_path_shapes(cfg)[0], train_shapes(cfg))]
    mnv2 = [dict(sh, label=f"mobilenetv2 {sh['label']}")
            for sh in main_path_shapes(zcfg) + [train_shapes(zcfg)]]
    # the patch extraction: the box head's 7x7 pool under POOL_KERNEL
    # pallas (phase 11, scale 0 first: its times go into the JSON line),
    # then the mask pool's 14x14 shapes
    box_head = [dict(s, P=7, label=f"box head {s['label']}", edges=not i)
                for i, s in enumerate(main_path_shapes(cfg))]
    mask_patch = [dict(s, P=14, label=f"mask pool {s['label']}")
                  for s in main_path_shapes(mcfg)]
    results: list = []
    ok = True
    for kernel, check, at in (
            (cuda.NMS, check_nms, both + mnv2),
            (cuda.DEFORM_IM2COL, check_im2col, both + x101),
            (cuda.FUSED_POOL, check_pool,
             both + mask_train + mask_infer + mnv2),
            (cuda.DEFORM_IM2COL_BWD, check_im2col_bwd, train + x101[1:]),
            (cuda.POOL_BWD, check_pool_bwd, train + mask_train + mnv2[-1:]),
            (cuda.ROI_PATCH, check_roi_patch, box_head + mask_patch),
            (cuda.UNIT_EPILOGUE, check_unit_epilogue,
             epilogue_shapes(cfg, acfg))):
        print(f"{kernel.name}: tolerance {TOLERANCES[kernel.name]}")
        runs = [check(dev, sh) for sh in at]
        torch.cuda.synchronize()
        good = all(r["ok"] for r in runs)
        print(f"{kernel.name}: {'PASS' if good else 'FAIL'}")
        ok &= good
        results.append(dict(runs[0], kernel=kernel,
                            max_abs_err=max(r["err"] for r in runs)))
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


@contextlib.contextmanager
def plain_versions():
    """Route the detector through the plain torch versions on the card, to
    hold the kernel path against it (restored on exit)."""
    from sniper_tpu_torch.ops import deform, epilogue, nms, proposals

    saved = (deform.deform_im2col, deform.pool_pass, deform.deform_im2col_bwd,
             deform.pool_pass_bwd, deform.extract_patches,
             proposals.nms_sorted, epilogue.bn_relu, epilogue.sum_bn_relu,
             epilogue.bn_add_relu)
    epilogue.bn_relu = epilogue.bn_relu_plain
    epilogue.sum_bn_relu = epilogue.sum_bn_relu_plain
    epilogue.bn_add_relu = epilogue.bn_add_relu_plain
    deform.deform_im2col = deform.deform_im2col_plain
    deform.pool_pass = deform.pool_pass_plain
    deform.deform_im2col_bwd = deform.deform_im2col_bwd_plain
    deform.pool_pass_bwd = deform.pool_pass_bwd_plain
    deform.extract_patches = deform.extract_patches_plain
    proposals.nms_sorted = nms.nms_plain
    try:
        yield
    finally:
        (deform.deform_im2col, deform.pool_pass, deform.deform_im2col_bwd,
         deform.pool_pass_bwd, deform.extract_patches,
         proposals.nms_sorted, epilogue.bn_relu, epilogue.sum_bn_relu,
         epilogue.bn_add_relu) = saved


def in_range_threshold(out, im_info, valid_range, k: int = 20) -> float:
    """A class threshold under the foreground scores of each image's k best
    rois whose boxes lie inside ``valid_range`` (Tester.aggregate's area
    filter, in image px) with a margin of 20% in side, so that the scale's
    regressed boxes keep some detections through the aggregation."""
    scale = torch.as_tensor(im_info, dtype=torch.float32,
                            device=out["rois"].device)[:, 2, None, None]
    rois = out["rois"][..., 1:5].float() / scale
    area = ((rois[..., 2] - rois[..., 0]) * (rois[..., 3] - rois[..., 1]))
    ok = out["roi_valid"].bool()
    lo, hi = valid_range
    if lo > 0:
        ok = ok & (area > (1.2 * lo) ** 2)
    if hi > 0:
        ok = ok & (area <= (hi / 1.2) ** 2)
    fg = out["cls_prob"][..., 1:].amax(-1).float()
    per_image = [fg[i][ok[i]].topk(min(k, int(ok[i].sum()))).values.min()
                 for i in range(len(fg)) if ok[i].any()]
    return float(min(per_image)) * 0.99 if per_image else 0.0


@contextlib.contextmanager
def class_threshold(thresh: float):
    """Run Tester.get_detections with its per-class score threshold at
    ``thresh`` in place of its 1e-3 (restored on exit)."""
    import functools

    from sniper_tpu_torch.infer.tester import Tester

    saved = Tester.get_detections
    Tester.get_detections = functools.partialmethod(saved, cls_thresh=thresh)
    try:
        yield
    finally:
        Tester.get_detections = saved


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
        stats = run_detection(cfg, model, None, roidb, Detections(81),
                              out_dir, dev, image_loader=synth_image)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k.name: k.launches
                for k in (cuda.NMS, cuda.DEFORM_IM2COL, cuda.FUSED_POOL,
                          cuda.UNIT_EPILOGUE)}
    good = (stats["detections"] > 0 and all(launches.values())
            and launches[cuda.UNIT_EPILOGUE.name]
            == EPILOGUES_FORWARD * launches[cuda.NMS.name])
    print(f"e2e (b) run_detection (cv2 canvases, injected image loader, "
          f"counting dataset) over {N_IMAGES} synthetic {IM_W}x{IM_H} "
          f"images: {stats}, launches {launches} (unit epilogues "
          f"{EPILOGUES_FORWARD} a counted forward: the eager calls and the "
          f"captures, not the replays), {wall:.2f} s wall including "
          f"first-call set-up and captures: {'PASS' if good else 'FAIL'}")
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
        replayed, reading = replay_check(fwd, model, batches[0]["data"],
                                         batches[0]["im_info"])
        print(f"e2e (c) scale {s}: canvas {hw[0]}x{hw[1]}, batch {bs}, "
              f"{n} rois/img: median {ms:.2f} ms/batch (min {per_rep[0]:.2f}, "
              f"max {per_rep[-1]:.2f} over {E2E_REPS} passes of "
              f"{len(batches)} batches), {bs * 1e3 / ms:.1f} img/s "
              f"[{card}]; shapes and finiteness "
              f"{'PASS' if shapes_ok else 'FAIL'}; {reading}")
        ok &= shapes_ok and replayed
        ms_per_image += ms / bs
    print(f"e2e (c) three-scale pyramid: {ms_per_image:.2f} ms/img, "
          f"{1e3 / ms_per_image:.1f} img/s (forward only, sum of the "
          f"scales' medians, random weights; a smoke reading) "
          f"[{card}]")
    return ok, launches


# ---------------------------------------------------------------------------
# phase 4: mask-branch inference
# ---------------------------------------------------------------------------

# the mask branch pools through the fused pool kernels too: the patch
# extraction (P5) runs only on the box head's pallas route (phase 11)
INFERENCE_KERNELS = ("nms", "deform_im2col", "fused_pool", "unit_epilogue")
# the unit epilogue's launches: a test forward of R101 or X101 runs one for
# the stem and three for each of its 33 units; a training step of R101 only
# the frozen stem's and stage 1's, which the trunk runs without autograd
EPILOGUES_FORWARD = 1 + 3 * 33
EPILOGUES_STEP = 1 + 3 * 3

TRAINING_KERNELS = ("nms", "deform_im2col", "fused_pool", "deform_im2col_bwd",
                    "fused_pool_bwd")


class MaskCountingDataset(Detections):
    """Also stands in for evaluate_segmentations: checks every aggregated
    mask, then (with ``paste``) pastes and RLE-encodes the masks of image 0
    and decodes the first RLE back."""

    def __init__(self, paste: bool = True):
        super().__init__(81)
        self.paste = paste

    def evaluate_segmentations(self, all_boxes_masks, roidb):
        from sniper_tpu_torch.infer.masks import (
            masks_to_results,
            paste_mask,
            rle_to_binary_mask,
        )

        n = 0
        for j in range(1, self.num_classes):
            for dets, masks in all_boxes_masks[j]:
                if masks.ndim != 3 or len(masks) != len(dets):
                    raise ValueError(f"masks {masks.shape} for dets "
                                     f"{dets.shape}")
                if len(masks) and not (np.isfinite(masks).all()
                                       and masks.min() >= 0
                                       and masks.max() <= 1):
                    raise ValueError("mask probabilities outside [0, 1]")
                n += len(masks)
        if not self.paste:
            return {"masks": n}
        one = [None] + [[all_boxes_masks[j][0]]
                        for j in range(1, self.num_classes)]
        ids = {j: j for j in range(1, self.num_classes)}
        t0 = time.perf_counter()
        results = masks_to_results(one, roidb[:1], ids, self.num_classes)
        paste_s = time.perf_counter() - t0
        h, w = roidb[0]["height"], roidb[0]["width"]
        if not results or any(r["segmentation"]["size"] != [h, w]
                              for r in results):
            raise ValueError("no or misshapen RLEs for image 0")
        j = next(j for j in range(1, self.num_classes)
                 if len(all_boxes_masks[j][0][0]))
        dets, masks = all_boxes_masks[j][0]
        same = np.array_equal(rle_to_binary_mask(results[0]["segmentation"]),
                              paste_mask(masks[0], dets[0, :4], h, w))
        if not same:
            raise ValueError("the first RLE does not decode to its mask")
        pixels = sum(sum(r["segmentation"]["counts"][1::2]) for r in results)
        return {"masks": n, "image0_rles": len(results),
                "image0_mask_pixels": int(pixels),
                "image0_paste_rle_s": round(paste_s, 3)}


def mask_phase(dev, mcfg, card: str) -> tuple[bool, dict]:
    """Returns (ok, {kernel name: launches in run_detection with masks})."""
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

    model = get_model(mcfg)
    init_detector(model, seed=0, offset_std=1e-3)
    model.to(dev).eval()
    S = model.mask_size
    print(f"mask: {MASK_CONFIG}: symbol {mcfg.symbol}, units "
          f"{model.trunk.units}, {mcfg.dataset.NUM_CLASSES} classes, "
          f"post-NMS per scale {list(mcfg.TEST.N_PROPOSAL_PER_SCALE)}, "
          f"batches {list(mcfg.TEST.BATCH_IMAGES)}, trunk dtype "
          f"{model.dtype}, mask pool 14x14 through the fused pool kernels "
          f"(margin {model.head_margin_bins} bin) and mask head in fp32 with "
          f"TF32 "
          f"off; {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M "
          f"params, seeded random weights (seed 0, offsets normal(1e-3))")
    ok = True

    # (a) kernel path against the plain path, on a small input
    g = torch.Generator().manual_seed(11)
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
    merr = float((out_k["mask_prob"] - out_p["mask_prob"]).abs().max())
    good = same_rois and err <= 1e-3 and merr <= 1e-3
    print(f"mask (a) 256x320 input, kernel path vs plain path on the card: "
          f"rois identical {same_rois}, cls_prob max abs err {err:.3e}, "
          f"mask_prob max abs err {merr:.3e}; tolerance 1e-3 (bf16 trunk "
          f"identical in both, fp32 pool sums in another order): "
          f"{'PASS' if good else 'FAIL'}")
    ok &= good

    # (b) the main path: run_detection with masks over synthetic images
    roidb = [{"image": f"im{i}", "width": IM_W, "height": IM_H,
              "flipped": False} for i in range(N_IMAGES)]
    for k in cuda.KERNELS:
        k.launches = 0
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        stats = run_detection(mcfg, model, None, roidb, MaskCountingDataset(),
                              out_dir, dev, image_loader=synth_image)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in cuda.KERNELS}
    # per counted forward (the eager calls and the captures): one NMS call,
    # the box head's two pool passes and the mask branch's two
    batches = launches[cuda.NMS.name]
    good = (stats["bbox"]["detections"] > 0 and stats["segm"]["masks"] > 0
            and all(launches[n] > 0 for n in INFERENCE_KERNELS)
            and launches[cuda.FUSED_POOL.name] == 4 * batches
            and launches[cuda.ROI_PATCH.name] == 0)
    print(f"mask (b) run_detection with masks over {N_IMAGES} synthetic "
          f"{IM_W}x{IM_H} images: {stats}; launches of the six kernels "
          f"{launches} (the three of inference must be > 0, the pool 4 per "
          f"counted forward over {batches} eager calls and captures, the "
          f"patch extraction 0; the pool "
          f"and DCN backward kernels run only in training, phase 5), "
          f"{wall:.2f} s wall including first-call set-up: "
          f"{'PASS' if good else 'FAIL'}")
    ok &= good

    # (c) per-scale forward times at the shipped batch sizes
    init_inference_crops(roidb)
    torch.cuda.reset_peak_memory_stats()
    ms_per_image = 0.0
    for s in range(len(mcfg.TEST.SCALES)):
        bs = mcfg.TEST.BATCH_IMAGES[s]
        n = _scale_post_nms(mcfg, s, model)
        batches = list(TestChipIterator(roidb, mcfg, s, bs,
                                        image_loader=synth_image))
        fwd = make_forward(model, None, dev, mcfg.network.PIXEL_MEANS, n)
        out = fwd(batches[0]["data"], batches[0]["im_info"])
        torch.cuda.synchronize()
        mp = out["mask_prob"]
        shapes_ok = (tuple(mp.shape) == (bs, n, S, S)
                     and bool(torch.isfinite(mp).all())
                     and float(mp.min()) >= 0 and float(mp.max()) <= 1)
        per_rep = []
        for _ in range(MASK_REPS):
            t0 = time.perf_counter()
            for b in batches:
                fwd(b["data"], b["im_info"])
            torch.cuda.synchronize()
            per_rep.append((time.perf_counter() - t0) * 1e3 / len(batches))
        per_rep.sort()
        ms = per_rep[len(per_rep) // 2]
        hw = batches[0]["data"].shape[1:3]
        replayed, reading = replay_check(fwd, model, batches[0]["data"],
                                         batches[0]["im_info"])
        print(f"mask (c) scale {s}: canvas {hw[0]}x{hw[1]}, batch {bs}, "
              f"{n} rois/img: median {ms:.2f} ms/batch (min "
              f"{per_rep[0]:.2f}, max {per_rep[-1]:.2f} over {MASK_REPS} "
              f"passes of {len(batches)} batches), {bs * 1e3 / ms:.1f} img/s "
              f"[{card}]; mask_prob shape, range and finiteness "
              f"{'PASS' if shapes_ok else 'FAIL'}; {reading}")
        ok &= shapes_ok and replayed
        ms_per_image += ms / bs
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"mask (c) three-scale pyramid with masks: {ms_per_image:.2f} "
          f"ms/img, {1e3 / ms_per_image:.1f} img/s, peak memory {peak:.2f} "
          f"GiB (forward only, sum of the scales' medians, random weights; "
          f"a smoke reading) [{card}]")
    ok &= mask_span_reading(model, mcfg, roidb, dev, card)
    del model
    torch.cuda.empty_cache()
    return ok, launches


def mask_span_reading(model, mcfg, roidb, dev, card: str) -> bool:
    """Phase 4 (d): one scale-0 batch traced; the sniper/mask span's device
    and host ms and launches, and the roi counter against B x N."""
    from benchmark.core import spans
    from sniper_tpu_torch.data.test_loader import TestChipIterator
    from sniper_tpu_torch.main_test import _scale_post_nms, make_forward
    from sniper_tpu_torch.models import detector
    from sniper_tpu_torch.utils.profiler import device_trace

    bs = mcfg.TEST.BATCH_IMAGES[0]
    n = _scale_post_nms(mcfg, 0, model)
    batch = next(iter(TestChipIterator(roidb, mcfg, 0, bs,
                                       image_loader=synth_image)))
    fwd = make_forward(model, None, dev, mcfg.network.PIXEL_MEANS, n)
    with tempfile.TemporaryDirectory() as trace_dir:
        with device_trace(trace_dir):
            fwd(batch["data"], batch["im_info"])
        (name,) = os.listdir(trace_dir)
        with open(os.path.join(trace_dir, name)) as f:
            events = json.load(f)["traceEvents"]
    row = spans.table(events, -math.inf, math.inf,
                      lambda _: "all")["spans"].get("mask")
    good = row is not None and detector.MASK_ROIS == bs * n
    reading = ("no sniper/mask span" if row is None else
               f"sniper/mask {row['device_s'] * 1e3:.2f} device ms, "
               f"{row['host_s'] * 1e3:.2f} host ms, {row['launches']} "
               f"launches")
    print(f"mask (d) one scale-0 batch of {bs} under the profiler: "
          f"{reading}; MASK_ROIS {detector.MASK_ROIS} (B x N = {bs * n}) "
          f"[{card}]: {'PASS' if good else 'FAIL'}")
    return good


# ---------------------------------------------------------------------------
# phase 5: training, the flagship recipe
# ---------------------------------------------------------------------------

TRAIN_SIZES = ((480, 640), (640, 480), (600, 800), (375, 500), (768, 1024),
               (512, 512), (800, 600), (427, 640))


def synth_train_image(name: str) -> np.ndarray:
    """A deterministic BGR image for roidb entry 't<i>:<h>x<w>' (module
    level: the loader process unpickles it)."""
    i, hw = name.split(":")
    h, w = (int(v) for v in hw.split("x"))
    rng = np.random.RandomState(2000 + int(i.removeprefix("t")))
    im = rng.randint(40, 200, (h, w, 3), np.uint8)
    for _ in range(8):
        x, y = rng.randint(0, w - 40), rng.randint(0, h - 40)
        im[y:y + rng.randint(10, 200), x:x + rng.randint(10, 200)] = (
            rng.randint(0, 255, 3, np.uint8))
    return im


def ellipse_polygon(box, n: int) -> list:
    """A flat [x0, y0, x1, y1, ...] polygon of n vertices: the ellipse
    inscribed in box (x1, y1, x2, y2)."""
    x1, y1, x2, y2 = (float(v) for v in box[:4])
    t = np.arange(n) * (2 * np.pi / n)
    return np.stack([(x1 + x2) / 2 + (x2 - x1) / 2 * np.cos(t),
                     (y1 + y2) / 2 + (y2 - y1) / 2 * np.sin(t)],
                    1).reshape(-1).tolist()


class SynthTrainDataset:
    """Stands in for a dataset reader: N_TRAIN_IMAGES images of mixed sizes
    with GT boxes small, medium and large, so that every training scale's
    valid range holds some (the chip generator sees them all)."""

    name = "synth_train"
    num_classes = 81

    def gt_roidb(self):
        rng = np.random.RandomState(7)
        roidb = []
        for i in range(N_TRAIN_IMAGES):
            h, w = TRAIN_SIZES[i % len(TRAIN_SIZES)]
            side = np.concatenate([
                rng.uniform(12, 40, 3), rng.uniform(50, 140, 3),
                rng.uniform(160, 0.8 * min(h, w), 2)])
            asp = rng.uniform(0.6, 1.6, side.size)
            bw, bh = side * np.sqrt(asp), side / np.sqrt(asp)
            bw, bh = np.minimum(bw, w - 2), np.minimum(bh, h - 2)
            x1, y1 = rng.uniform(0, w - bw - 1), rng.uniform(0, h - bh - 1)
            cls = rng.randint(1, self.num_classes, side.size)
            ov = np.zeros((side.size, self.num_classes), np.float32)
            ov[np.arange(side.size), cls] = 1.0
            roidb.append({
                "image": f"t{i}:{h}x{w}", "width": w, "height": h,
                "boxes": np.stack([x1, y1, x1 + bw, y1 + bh], 1)
                .astype(np.float32),
                "gt_classes": cls.astype(np.int32), "gt_overlaps": ov,
                "max_overlaps": np.ones(side.size, np.float32),
                "max_classes": cls, "flipped": False,
            })
        return roidb


class SynthMaskDataset(SynthTrainDataset):
    """The same images and boxes with each GT's polygon, as a COCO reader
    with load_mask gives them: an ellipse of 16 to 32 vertices inscribed in
    the box. Its name is the box set's, so that the mask run reads the
    proposals extracted in (r3)."""

    def gt_roidb(self):
        roidb = super().gt_roidb()
        rng = np.random.RandomState(8)
        for r in roidb:
            r["gt_masks"] = [[ellipse_polygon(b, rng.randint(16, 33))]
                             for b in r["boxes"]]
        return roidb


def train_cfg(cfg):
    """The yml's training settings at full width, with this run's cuts: one
    epoch, and the synthetic image set's name."""
    import copy

    cfg = copy.deepcopy(cfg)
    cfg.TRAIN.begin_epoch, cfg.TRAIN.end_epoch = 0, 1
    cfg.dataset.image_set = SynthTrainDataset.name
    return cfg


def recipe_cfgs(cfg, tmp: str):
    """(phase 1 and 2's config, phase 3's), as the README's commands set
    them: phase 1 ``TRAIN.ONLY_PROPOSAL True TRAIN.USE_NEG_CHIPS False``;
    phase 2 also ``TEST.EXTRACT_PROPOSALS True``, ``TEST.TEST_EPOCH`` the
    epoch phase 1 wrote and ``dataset.test_image_set`` the training set;
    phase 3 the yml's, reading the proposals phase 2 wrote."""
    import copy

    cfg.output_path = os.path.join(tmp, "output")
    cfg.proposal_path = os.path.join(tmp, "proposals")
    rpn = copy.deepcopy(cfg)
    rpn.TRAIN.ONLY_PROPOSAL, rpn.TRAIN.USE_NEG_CHIPS = True, False
    rpn.TEST.EXTRACT_PROPOSALS = True
    rpn.TEST.TEST_EPOCH = rpn.TRAIN.end_epoch
    rpn.dataset.test_image_set = SynthTrainDataset.name
    rpn.TEST.PROPOSAL_SAVE_PATH = cfg.proposal_path
    return rpn, cfg


# leaves whose gradients the one-step checks compare, kernel path against
# plain path: the head, and trunk leaves that the backward kernels feed
HEAD_LEAVES = ("rcnn.offset.weight", "rcnn.offset.bias",
               "rcnn.fc_new_1.weight", "rcnn.cls_score.weight")
RPN_LEAVES = ("rpn.rpn_conv_3x3.weight", "rpn.rpn_cls_score.weight",
              "rpn.rpn_bbox_pred.weight")
MASK_LEAVES = ("mask_offset.weight", "mask_offset.bias",
               "mask.mask_conv_3x3_1.weight", "mask.mask_deconv.weight",
               "mask.mask_out.weight")
AF_LEAVES = ("autofocus.conv_new_2.weight", "autofocus.conv_new_3.weight",
             "autofocus.conv_new_out.weight", "autofocus.conv_new_out.bias")
TRUNK_LEAVES = ("trunk.stage4_unit3.offset.weight",
                "trunk.stage4_unit1.conv2_weight",
                "trunk.stage3_unit23.conv1.weight",
                "trunk.stage2_unit1.bn1.weight")
# the model zoo's trunks: ResNeXt-101's names above (its C5 conv2_weight is
# the grouped deformable one) and its grouped plain 3x3 and shortcut BN;
# MobileNetV2's depthwise, expand and last convs
ZOO_TRUNK_LEAVES = {
    "resnet": TRUNK_LEAVES,
    "resnext": TRUNK_LEAVES + ("trunk.stage2_unit1.conv2_weight",
                               "trunk.stage3_unit1.sc_bn.weight"),
    "mobilenetv2": ("trunk.last_conv.conv2d.weight",
                    "trunk.seq5_block2.depthwise.conv2d.weight",
                    "trunk.seq3_block0.exp.batchnorm.weight",
                    "trunk.seq1_block1.linear.conv2d.weight"),
}
# fixed bounds for an fp32 trunk with TF32 off, where the two paths differ
# only in the order of fp32 sums (the pool's taps, the backward kernels'
# atomics): the trunk's forward is identical in both, so no ReLU or
# rounding decision flips and the error stays at fp32 rounding
STEP_LOSS_REL, HEAD_GRAD_REL, TRUNK_GRAD_REL = 1e-5, 1e-4, 1e-4
# with the mask branch, the mask head's ReLUs take the pool's output with
# the init's zero biases, so activations sit around zero and rounding flips
# a few of them; so are the model zoo's (ResNeXt-101's head offset FC's
# gradient moved by 8.6e-4 between the paths on the card, where R101's
# stays within 1e-4; MobileNetV2's 52 BatchNorms train in an
# ill-conditioned chain): each bound is then the larger of the fixed one
# and NOISE_MULT times the plain path's own spread under NOISE_ULPS of
# noise on every pool pass (the largest of NOISE_DRAWS seeded draws)
NOISE_ULPS, NOISE_MULT, NOISE_DRAWS = 4, 4.0, 2


@contextlib.contextmanager
def pool_noise(ulps: int, seed: int):
    """Inside plain_versions: multiply every pool pass's output by
    1 + ulps * 2^-23 * u, u uniform in [-1, 1) from a seeded generator on the
    card, the size of the rounding that the kernels' other order of fp32
    sums makes (restored on exit)."""
    from sniper_tpu_torch.ops import deform

    inner = deform.pool_pass
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def noisy(feat, geom, pypx, **kw):
        out = inner(feat, geom, pypx, **kw)
        u = torch.rand(out.shape, generator=gen, device=out.device) * 2 - 1
        return out * (1 + ulps * 2.0 ** -23 * u)

    deform.pool_pass = noisy
    try:
        yield
    finally:
        deform.pool_pass = inner


def step_batch(cfg, model, B: int, S: int, *, with_mask=False,
               with_af=False, seed: int = 9):
    """A seeded training batch of B chips of SxS (fp32 pixels, 5 GT boxes
    each, sparse RPN targets; GT masks rasterized from an ellipse in each
    GT box with ``with_mask``, FocusPixel labels with ``with_af``) and the
    sampler's fg and bg priorities for ``model``, on the host."""
    G = 6
    g = torch.Generator().manual_seed(seed)
    A, fh = cfg.network.NUM_ANCHORS, S // cfg.network.RPN_FEAT_STRIDE
    gt = torch.full((B, G, 5), -1.0)
    xy = torch.rand(B, G - 1, 2, generator=g) * 150
    wh = 20 + torch.rand(B, G - 1, 2, generator=g) * 90
    gt[:, :G - 1, :2], gt[:, :G - 1, 2:4] = xy, xy + wh
    gt[:, :G - 1, 4] = torch.randint(1, 81, (B, G - 1), generator=g).float()
    pids = torch.stack([torch.randperm(A * fh * fh, generator=g)[:256]
                        for _ in range(B)])
    batch = {
        "data": torch.randn(B, S, S, 3, generator=g) * 40,
        "im_info": torch.tensor([[S, S, 1.0]] * B),
        "gt_boxes": gt, "valid_ranges": torch.tensor([[0.0, 1e5]] * B),
        "rpn_pids": pids.int(),
        "rpn_label_vals": (torch.rand(B, 256, generator=g) < 0.3).float(),
        "fg_pids": pids[:, :32].int(),
        "fg_targets": torch.randn(B, 32, 4, generator=g) * 0.2,
    }
    if with_mask:
        from sniper_tpu_torch.data.mask_utils import rasterize_gt_masks

        batch["gt_masks"] = torch.from_numpy(np.stack([rasterize_gt_masks(
            [[ellipse_polygon(b, 24)] if b[4] >= 0 else [] for b in rows],
            rows[:, :4], grid=112, max_n_gts=G) for rows in gt.numpy()]))
    if with_af:
        batch["scale_label"] = (torch.randint(0, 3, (B, fh * fh),
                                              generator=g) - 1).float()
    n_cand = model.train_kw["post_nms"] + G
    pri = (torch.rand(B, n_cand, generator=g),
           torch.rand(B, n_cand, generator=g))
    return batch, pri


def ohem_rois(cfg) -> int:
    """The OHEM rois per chip the CLI trains with (0: OHEM off)."""
    return int(cfg.TRAIN.BATCH_ROIS_OHEM) if cfg.TRAIN.ENABLE_OHEM else 0


def train_step_check(dev, cfg, tag: str) -> bool:
    """One training forward and backward on 2 chips of 256x256 at full
    width, once through the kernels and once through their plain versions
    on the card, from the same weights, batch and sampler priorities: the
    detector of ``cfg`` (RPN-only under TRAIN.ONLY_PROPOSAL, where only the
    DCN im2col and its backward differ between the paths; with the mask
    branch under TRAIN.WITH_MASK, the batch's GT masks rasterized from an
    ellipse in each GT box, and the bounds widened to NOISE_MULT times the
    plain path's spread under pool_noise, read in the same run, as for the
    model zoo's trunks; with the
    FocusPixel head under TRAIN.AUTO_FOCUS, seeded FocusPixel labels in the
    batch, focus_loss among the losses and the head's leaves among the
    gradients; under TRAIN.ENABLE_OHEM the losses of the hardest
    BATCH_ROIS_OHEM rois per chip). The trunk leaves are ZOO_TRUNK_LEAVES
    of the model's trunk.
    The trunk runs in fp32 here, so that a fixed bound holds: in bf16 one
    rounding step
    apart early in the backward decorrelates every later bf16 rounding of
    the trunk's gradients (phase 2 holds each kernel against its plain
    version in bf16, and the recipe's runs train in bf16)."""
    import copy

    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.losses import total_loss
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.train.optimizer import is_fixed

    cfg = copy.deepcopy(cfg)
    cfg.TRAIN.bf16 = False
    rpn_only = bool(cfg.TRAIN.ONLY_PROPOSAL)
    with_mask = bool(cfg.TRAIN.WITH_MASK) and not rpn_only
    with_af = bool(cfg.TRAIN.AUTO_FOCUS) and not rpn_only
    model = init_detector(get_model(cfg), seed=0).to(dev).train()
    for name, p in model.named_parameters():
        p.requires_grad_(not is_fixed(name, cfg.network.FIXED_PARAMS))
    B, S = 2, 256
    batch, pri = step_batch(cfg, model, B, S, with_mask=with_mask,
                            with_af=with_af)
    batch = {k: v.to(dev) for k, v in batch.items()}
    pri = tuple(p.to(dev) for p in pri)
    params = dict(model.named_parameters())
    heads = (RPN_LEAVES if rpn_only else
             HEAD_LEAVES + (MASK_LEAVES if with_mask else ())
             + (AF_LEAVES if with_af else ()))
    trunk = ZOO_TRUNK_LEAVES[model.trunk_type]
    if not rpn_only:
        trunk = ("conv_new_1.weight",) + trunk
    noisy_bounds = with_mask or model.trunk_type != "resnet"

    def one_step():
        model.zero_grad(set_to_none=True)
        out = model(batch["data"], batch["im_info"], batch["gt_boxes"],
                    batch["valid_ranges"], gt_masks=batch.get("gt_masks"),
                    train=True, priorities=pri)
        _, m = total_loss(out, batch, B, cfg.TRAIN.RPN_BATCH_SIZE,
                          rpn_only=rpn_only, ohem_rois=ohem_rois(cfg))
        m["loss"].backward()
        torch.cuda.synchronize()
        return ({k: float(v.detach()) for k, v in m.items()},
                {k: params[k].grad.float().clone() for k in heads + trunk})

    # TF32 off (phase 2 turns it off for the run; a check called without
    # phase 2 must too): in TF32 two plain-path runs' trunk gradients part
    # by far more than the fixed bounds
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    noisy = []
    try:
        mk, gk = one_step()
        with plain_versions():
            mp, gp = one_step()
            for seed in range(NOISE_DRAWS) if noisy_bounds else ():
                with pool_noise(NOISE_ULPS, seed):
                    noisy.append(one_step())
    finally:
        torch.backends.cudnn.deterministic = False
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved

    def loss_rel(m):
        return max(abs(m[k] - mp[k]) / max(abs(mp[k]), 1e-12) for k in m)

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def widen(base, spread):
        return max(base, NOISE_MULT * spread) if noisy_bounds else base

    ok = all(math.isfinite(v) for v in mk.values())
    loss_err = loss_rel(mk)
    loss_spread = max((loss_rel(m) for m, _ in noisy), default=0.0)
    loss_tol = widen(STEP_LOSS_REL, loss_spread)
    ok &= loss_err <= loss_tol
    parts = []
    for names, base in ((heads, HEAD_GRAD_REL), (trunk, TRUNK_GRAD_REL)):
        for k in names:
            e = rel(gk[k], gp[k])
            spread = max((rel(g[k], gp[k]) for _, g in noisy), default=0.0)
            tol = widen(base, spread)
            ok &= e <= tol and float(gp[k].norm()) > 0
            parts.append(f"{k} {e:.2e}" + (
                f" (plain path's noise spread {spread:.2e}, tolerance "
                f"{tol:.2e})" if noisy_bounds else ""))
    noise = (f"; the plain path against itself with {NOISE_ULPS}-ulp noise "
             f"on every pool pass ({NOISE_DRAWS} draws) spreads its losses "
             f"by {loss_spread:.2e}, and each tolerance is the larger of the "
             f"fixed one and {NOISE_MULT:g} times that leaf's spread"
             if noisy_bounds else "")
    print(f"{tag} 2 chips of {S}x{S}, fp32 trunk, one forward and "
          f"backward, kernel path vs plain path on the card: losses {mk}; "
          f"max relative loss error {loss_err:.2e} (tolerance "
          f"{loss_tol:.2e}); gradients, relative L2 error, tolerance "
          f"{HEAD_GRAD_REL} ({'RPN' if rpn_only else 'heads'}) and "
          f"{TRUNK_GRAD_REL} (trunk leaves){noise}: {'; '.join(parts)}: "
          f"{'PASS' if ok else 'FAIL'}")
    del model
    torch.cuda.empty_cache()
    return ok


GRAPH_STEPS = 5  # replayed steps after the eager warm-up, in (g)


def graph_steps(dev, cfg, card: str) -> bool:
    """(g) The training step's CUDA graph (train/trainer.py) at the yml's
    batch and chip size at full width: trainer.GRAPH_WARMUP eager steps,
    then GRAPH_STEPS replayed ones, on one batch resident on the card, the
    card drained before each step. Per step: eager or replayed, its host
    ms inside the step's call, its device ms (CUDA events around the call)
    and its loss; then the replay share. Passes when exactly the steps
    after the warm-up replayed, every loss is finite, and a replayed
    step's host ms (the median, the capturing step aside) is below an
    eager step's."""
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.train import trainer
    from sniper_tpu_torch.train.optimizer import make_optimizer

    model = init_detector(get_model(cfg), seed=0).to(dev)
    opt, sched, _ = make_optimizer(cfg, 1000, model)
    B, S = cfg.TRAIN.BATCH_IMAGES, cfg.TRAIN.CHIP_SIZE
    step = trainer.make_train_step(
        model, opt, sched, B, rpn_batch_size=cfg.TRAIN.RPN_BATCH_SIZE,
        pixel_means=cfg.network.PIXEL_MEANS)
    batch, pri = step_batch(cfg, model, B, S)
    batch = {k: v.to(dev) for k, v in batch.items()}
    pri = tuple(p.to(dev) for p in pri)
    rows = []
    for k in range(trainer.GRAPH_WARMUP + GRAPH_STEPS):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        t0 = time.perf_counter()
        m = step(batch, pri)
        host = (time.perf_counter() - t0) * 1e3
        ev[1].record()
        torch.cuda.synchronize()
        rows.append((step.eager_reason is None, host,
                     ev[0].elapsed_time(ev[1]), float(m["loss"])))
        print(f"train (g) step {k + 1}: "
              f"{'replayed' if rows[-1][0] else 'eager'}"
              f"{', its capture' if k == trainer.GRAPH_WARMUP else ''}"
              f", host {host:.2f} ms, device {rows[-1][2]:.2f} ms, loss "
              f"{rows[-1][3]:.5f}")
    flags = [r[0] for r in rows]
    eager = sorted(r[1] for r in rows if not r[0])
    replayed = sorted(r[1] for r in rows[trainer.GRAPH_WARMUP + 1:])
    dev_e = sorted(r[2] for r in rows if not r[0])
    dev_r = sorted(r[2] for r in rows[trainer.GRAPH_WARMUP + 1:])
    ok = (flags == [False] * trainer.GRAPH_WARMUP + [True] * GRAPH_STEPS
          and all(math.isfinite(r[3]) for r in rows)
          and replayed[len(replayed) // 2] < eager[len(eager) // 2])
    print(f"train (g) {B} chips of {S}x{S}, the card drained before each "
          f"step: replay share {sum(flags)} of {len(flags)} steps; median "
          f"host ms in the step's call eager {eager[len(eager) // 2]:.2f}, "
          f"replayed {replayed[len(replayed) // 2]:.2f} (the capturing "
          f"step {rows[trainer.GRAPH_WARMUP][1]:.1f}); median device ms "
          f"(events around the call) eager {dev_e[len(dev_e) // 2]:.2f}, "
          f"replayed {dev_r[len(dev_r) // 2]:.2f} [{card}]; host clock and "
          f"events, a smoke reading: {'PASS' if ok else 'FAIL'}")
    del model, step
    torch.cuda.empty_cache()
    return ok


def synthetic_backbone(model, path: str) -> dict:
    """An ImageNet-style R101 backbone as an MXNet .params file: seeded
    arrays under the trunk's MXNet names and layouts (convs N(0, 1/fan_in),
    BatchNorm near identity), no offset or detection-layer names, plus the
    1000-way classifier the reference's backbones carry. Returns the
    arrays."""
    from sniper_tpu_torch.train.pretrained import (
        mapping_rows,
        save_mxnet_params,
    )

    rng = np.random.RandomState(101)
    state = model.state_dict()
    flat = {}
    for key, mx in mapping_rows(model):
        if not key.startswith("trunk.") or "_offset_" in mx:
            continue
        shape = tuple(state[key].shape)
        if mx.endswith("_weight"):
            a = rng.randn(*shape) / math.sqrt(np.prod(shape[1:]))
        elif mx.endswith("_moving_var"):
            a = rng.uniform(0.8, 1.2, shape)
        elif mx.endswith("_gamma"):
            a = 1.0 + 0.05 * rng.randn(*shape)
        else:  # beta, moving_mean
            a = 0.05 * rng.randn(*shape)
        flat[f"{'aux' if '_moving_' in mx else 'arg'}:{mx}"] = a.astype(
            np.float32)
    flat["arg:fc1_weight"] = (rng.randn(1000, 2048) * 0.01).astype(np.float32)
    flat["arg:fc1_bias"] = np.zeros(1000, np.float32)
    save_mxnet_params(path, flat)
    return {k[4:]: v for k, v in flat.items()}


def pretrained_import(cfg, tmp: str) -> tuple[bool, str]:
    """(r1) Write the synthetic backbone, import it into the RPN-only R101
    with load_pretrained, and hold every loaded tensor against the file.
    Returns (ok, the network.pretrained prefix)."""
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.train.pretrained import load_pretrained

    prefix = os.path.join(tmp, "resnet_mx_101")
    path = f"{prefix}-0000.params"
    model = init_detector(get_model(cfg), seed=0)
    flat = synthetic_backbone(model, path)
    cfg.network.pretrained = prefix
    t0 = time.perf_counter()
    report = load_pretrained(cfg, model, lambda m: print(f"recipe (r1) {m}"))
    secs = time.perf_counter() - t0
    state = model.state_dict()
    equal = all(np.array_equal(state[key].numpy(), flat[mx])
                for key, mx in report.loaded)
    trunk = sum(1 for k in state if k.startswith("trunk."))
    classifier = ["fc1_bias", "fc1_weight"]  # in the file, not in the model
    ok = (equal and not report.mismatched
          and len(report.loaded) == len(flat) - len(classifier)
          and report.unmapped_keys == classifier)
    kept = sorted(k for k, _ in report.missing)
    print(f"recipe (r1) pretrained import of a synthetic ImageNet-style R101 "
          f"backbone ({os.path.getsize(path) / 2**20:.1f} MB MXNet .params, "
          f"seeded, no weights downloaded) into the RPN-only detector: "
          f"{len(report.loaded)} tensors loaded (of {trunk} trunk tensors), "
          f"{len(kept)} kept at init ({kept[:4]} ...), "
          f"{len(report.unmapped_keys)} unused {report.unmapped_keys}, "
          f"{secs:.2f} s; every loaded tensor equal to the file's "
          f"{equal}; FIXED_PARAMS {list(cfg.network.FIXED_PARAMS)} verified: "
          f"{'PASS' if ok else 'FAIL'}")
    return ok, prefix


def loader_ms_per_batch(roidb, cfg, n=8) -> float:
    """The chip loader's own time per batch (in a spawned process under
    TRAIN.LOADER_PROCESS): a fresh loader's epoch re-roll aside, n batches
    assembled on the host, no device."""
    import copy

    from sniper_tpu_torch.main_train import make_loader

    loader = make_loader(copy.deepcopy(roidb), cfg, 1,
                         image_loader=synth_train_image)
    try:
        loader.reset()
        it = iter(loader)
        next(it)
        t0 = time.perf_counter()
        for _ in range(n):
            next(it)
        ms = (time.perf_counter() - t0) * 1e3 / n
        it.close()
    finally:
        loader.close()
    return ms


@contextlib.contextmanager
def traced_steps(traces: list, overhead: list, replayed: list):
    """Trace every training step (train/trainer.TrainStep) taken inside the
    block on its own: append its hand-kernel launches in its trace
    (cuda.traced_call; a CUDA graph's replay runs no kernel wrapper, so
    only a trace sees its launches) to ``traces`` and whether it replayed
    (``eager_reason`` None) to ``replayed``, and add to overhead[0] the
    seconds the trace took outside the step."""
    from sniper_tpu_torch.ops import cuda
    from sniper_tpu_torch.train import trainer

    inner = trainer.TrainStep.__call__

    def call(self, batch, priorities=None):
        t0, inside = time.perf_counter(), []

        def timed():
            t = time.perf_counter()
            out = inner(self, batch, priorities)
            torch.cuda.synchronize()
            inside.append(time.perf_counter() - t)
            return out

        metrics, launches = cuda.traced_call(timed)
        traces.append(launches)
        replayed.append(self.eager_reason is None)
        overhead[0] += time.perf_counter() - t0 - inside[0]
        return metrics

    trainer.TrainStep.__call__ = call
    try:
        yield
    finally:
        trainer.TrainStep.__call__ = inner


def timed_training(dev, cfg, model, loader, card: str, tag: str, *,
                   out_dir=None, every_step=(), idle=(), per_step=None,
                   varying=(), positive_first=(), timed_steps=TIMED_STEPS,
                   eager=None, after_step=None):
    """run_training for WARMUP_STEPS + ``timed_steps`` steps with the launch
    counters zeroed just before and read after every step, and every step
    traced on its own (traced_steps). The counters count the host's
    launches: the eager steps' and the capture's of the step's CUDA graph
    (train/trainer.py), not the replays'. Passes when the losses are
    finite; the replayed steps' traces hold the eager steps' hand-kernel
    launches (the most of each over the steps: cuda.most_launches), and
    those are the kernels the host launched; every kernel of ``every_step``
    launched at every step, every other training kernel in the timed steps
    unless it is in ``idle``, whose kernels must not launch at all, and
    each kernel of ``per_step`` exactly that many times in every step whose
    wrappers ran; each metric of ``varying`` not the same at every step,
    each of ``positive_first`` above 0 at the first step, and every step
    after the trainer.GRAPH_WARMUP eager ones replayed the step's CUDA
    graph, or, where ``eager`` names the condition that keeps the run
    eager, no step did and the last step's reason starts with it.
    ``after_step()`` runs after every step, the card synchronised. Returns
    (ok, the host's launches over the whole run, median ms per step)."""
    from sniper_tpu_torch.main_train import run_training
    from sniper_tpu_torch.ops import cuda
    from sniper_tpu_torch.train import trainer

    n_steps = WARMUP_STEPS + timed_steps
    times, snaps, losses, replayed, traces = [], [], [], [], []
    t_last, overhead = [0.0], [0.0]

    def hook(step, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append((now - t_last[0] - overhead[0]) * 1e3)
        t_last[0], overhead[0] = now, 0.0
        snaps.append({k.name: k.launches for k in cuda.KERNELS})
        if after_step is not None:
            after_step()
        m = {k: float(v) for k, v in metrics.items()}
        losses.append(m)
        print(f"{tag} step {step}: " + ", ".join(
            f"{k} {m[k]:.5f}" for k in sorted(m)))

    for k in cuda.KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t_last[0] = time.perf_counter()
    with traced_steps(traces, overhead, replayed):
        res = run_training(cfg, model, loader, dev, out_dir=out_dir,
                           log=lambda m: print(f"{tag} {m}"),
                           max_steps=n_steps, step_hook=hook)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in cuda.KERNELS}
    timed = times[WARMUP_STEPS:]
    calls = [{n: c - (snaps[i - 1][n] if i else 0) for n, c in s.items()}
             for i, s in enumerate(snaps)]
    # the steps whose kernel wrappers ran: the eager ones, then the capture
    first = replayed.index(1) if any(replayed) else len(calls)
    hosted = calls[:first + 1]
    most = cuda.most_launches(traces[:first])
    graph = cuda.most_launches(traces[first:]) if any(replayed) else None
    same = len(traces) == n_steps and graph in (None, most)
    short = sum(t != most for t in traces)  # the profiler lost records
    named = {n for n in most if most[n]} == {n for c in hosted for n in c
                                            if c[n]}
    each_step = all(c[n] > 0 and (graph is None or graph[n] > 0)
                    for c in hosted for n in every_step)
    never = all(launches[n] == 0 and not any(t[n] for t in traces)
                for n in idle)
    over_timed = {n: sum(t[n] for t in traces[WARMUP_STEPS:])
                  for n in launches}
    finite = all(math.isfinite(v) for m in losses for v in m.values())
    exact = all(c[n] == v for c in hosted
                for n, v in (per_step or {}).items())
    varies = all(len({m[k] for m in losses}) > 1 for k in varying)
    positive = all(losses[0][k] > 0 for k in positive_first)
    reason = res["eager_reason"]
    warm = trainer.GRAPH_WARMUP
    engaged = (replayed == [0] * warm + [1] * (n_steps - warm)
               if eager is None else
               not any(replayed) and reason.startswith(eager))
    good = (res["step"] == n_steps and len(timed) == timed_steps and finite
            and same and named and each_step and never
            and all(over_timed[n] for n in TRAINING_KERNELS
                    if n not in idle) and exact and varies and positive
            and engaged)
    srt = sorted(timed)
    med = srt[len(srt) // 2]
    bs = cfg.TRAIN.BATCH_IMAGES
    print(f"{tag} run_training, {n_steps} steps ({WARMUP_STEPS} warm-up, "
          f"{timed_steps} timed): median {med:.1f} ms per step (min "
          f"{srt[0]:.1f}, max {srt[-1]:.1f}), {bs * 1e3 / med:.1f} chips/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"[{card}]; host clock around steps that end in a synchronize "
          f"(each step traced, the traces taken off), synthetic images: a "
          f"smoke reading, not a benchmark. Hand-kernel launches in the "
          f"eager steps' traces (the most of each) {most}, in the replayed "
          f"steps' {graph}, as expected {same} ({short} of {len(traces)} "
          f"traces short of the eager most); host launches (the kernels' "
          f"counters: the eager steps and the capture) over the whole run "
          f"{launches}, the kernels the traces hold {named}; "
          f"{list(every_step)} every step {each_step}; {list(idle)} never "
          f"launched {never}"
          + (f"; per step exactly {per_step}: {exact}" if per_step else "")
          + (f"; {list(varying)} not constant: {varies}" if varying else "")
          + (f"; {list(positive_first)} above 0 at the first step: "
             f"{positive}" if positive_first else "")
          + f"; steps replayed as a CUDA graph {sum(replayed)} of {n_steps}"
          + (f" (eager: {reason})" if reason else "")
          + f", as expected {engaged}"
          + f"; losses finite {finite}: {'PASS' if good else 'FAIL'}")
    return good, launches, med


def rpn_training(dev, rcfg, roidb, card: str) -> tuple[bool, dict]:
    """(r2) The one-step check of the RPN-only detector, then run_training
    with TRAIN.ONLY_PROPOSAL from the imported backbone, its checkpoint
    written where restore_inference_state looks: the DCN im2col and its
    backward launch at every step, the pool, its backward and the NMS
    never (no R-CNN head, no proposals). Returns (ok, launches)."""
    from sniper_tpu_torch.config import config_name
    from sniper_tpu_torch.main_train import make_loader
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.ops import cuda
    from sniper_tpu_torch.train.pretrained import load_pretrained

    ok = train_step_check(dev, rcfg, "recipe (r2)")
    model = init_detector(get_model(rcfg), seed=0)
    load_pretrained(rcfg, model, lambda m: print(f"recipe (r2) {m}"))
    out_dir = os.path.join(rcfg.output_path, config_name(CONFIG),
                           rcfg.dataset.image_set)
    modules = [n for n, _ in model.named_children()]
    print(f"recipe (r2) {CONFIG} with TRAIN.ONLY_PROPOSAL True, "
          f"TRAIN.USE_NEG_CHIPS False: units {model.trunk.units}, "
          f"{rcfg.network.NUM_ANCHORS} anchors, BATCH_IMAGES "
          f"{rcfg.TRAIN.BATCH_IMAGES}, chips {rcfg.TRAIN.CHIP_SIZE}, trunk "
          f"dtype {model.dtype}, modules {modules}, from the imported "
          f"backbone")
    loader = make_loader(roidb, rcfg, 0, image_loader=synth_train_image)
    good, launches, _ = timed_training(
        dev, rcfg, model, loader, card, "recipe (r2)", out_dir=out_dir,
        every_step=(cuda.DEFORM_IM2COL.name, cuda.DEFORM_IM2COL_BWD.name),
        idle=(cuda.FUSED_POOL.name, cuda.POOL_BWD.name, cuda.NMS.name))
    loader.close()
    ckpt = os.path.join(out_dir, "checkpoints", "epoch_0001.pt")
    good &= os.path.exists(ckpt)
    print(f"recipe (r2) checkpoint {ckpt} written {os.path.exists(ckpt)}")
    del model
    torch.cuda.empty_cache()
    return ok and good, launches


EXTRACT_ATOL = 1e-4  # px and score: the paths are expected to agree exactly


def proposal_extraction(dev, rcfg, ds, card: str) -> tuple[bool, dict]:
    """(r3) main_test's TEST.EXTRACT_PROPOSALS path over the training images
    at the yml's three TEST.SCALES: the RPN-only detector restored from
    (r2)'s checkpoint by restore_inference_state, the kernel path against
    the plain path on one small batch, then run_proposal_extraction with
    the counters zeroed just before and read after. Returns (ok,
    launches)."""
    import pickle

    from sniper_tpu_torch.config import config_name
    from sniper_tpu_torch.main_test import run_proposal_extraction
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.ops import cuda
    from sniper_tpu_torch.train.checkpoint import restore_inference_state

    model = get_model(rcfg)
    source = restore_inference_state(rcfg, model, config_name(CONFIG),
                                     lambda m: print(f"recipe (r3) {m}"))
    model.to(dev).eval()
    ok = source == "checkpoint"

    g = torch.Generator().manual_seed(12)
    data = (torch.randn(2, 256, 320, 3, generator=g) * 50).to(dev)
    info = torch.tensor([[256.0, 320.0, 1.0], [240.0, 300.0, 1.0]],
                        device=dev)
    with torch.inference_mode():
        torch.backends.cudnn.deterministic = True
        out_k = model(data, info)
        with plain_versions():
            out_p = model(data, info)
        torch.backends.cudnn.deterministic = False
    n_k = out_k["roi_valid"].sum(1).tolist()
    n_p = out_p["roi_valid"].sum(1).tolist()
    rerr = float((out_k["rois"] - out_p["rois"]).abs().max())
    serr = float((out_k["roi_scores"] - out_p["roi_scores"]).abs().max())
    good = n_k == n_p and rerr <= EXTRACT_ATOL and serr <= EXTRACT_ATOL
    print(f"recipe (r3) 2 images of 256x320, RPN-only kernel path vs plain "
          f"path on the card: valid rois {n_k} vs {n_p}, rois max abs err "
          f"{rerr:.3e} px, scores max abs err {serr:.3e}; tolerance "
          f"{EXTRACT_ATOL} (expected 0: X1 is bit-exact and the NMS keep "
          f"lists identical): {'PASS' if good else 'FAIL'}")
    ok &= good

    roidb = ds.gt_roidb()
    for k in cuda.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    path = run_proposal_extraction(rcfg, model, None, roidb, ds, dev,
                                   image_loader=synth_train_image)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in cuda.KERNELS}
    with open(path, "rb") as f:
        boxes = pickle.load(f)["boxes"]
    counts = sorted(len(b) for b in boxes)
    finite = all(np.isfinite(b).all() and b.shape[1] == 5 for b in boxes)
    good = (len(boxes) == len(roidb) and counts[0] > 0 and finite
            and launches[cuda.NMS.name] > 0
            and launches[cuda.DEFORM_IM2COL.name] > 0
            and launches[cuda.FUSED_POOL.name] == 0)
    print(f"recipe (r3) run_proposal_extraction over {len(roidb)} synthetic "
          f"training images at scales {[tuple(s) for s in rcfg.TEST.SCALES]},"
          f" batches {list(rcfg.TEST.BATCH_IMAGES)}, "
          f"{model.post_nms_top_n} post-NMS rois per image and scale: "
          f"{path}; proposals per image min {counts[0]}, median "
          f"{counts[len(counts) // 2]}, finite [N,5] {finite}; "
          f"{wall * 1e3 / len(roidb):.1f} ms per image over the three "
          f"scales (host clock, image synthesis and first-call set-up "
          f"included) [{card}]; launches {launches} (NMS and im2col > 0, "
          f"pool 0): {'PASS' if good else 'FAIL'}")
    del model
    torch.cuda.empty_cache()
    return ok and good, launches


def recipe_training(dev, cfg, ds, card: str) -> tuple[bool, dict, dict]:
    """(r4) The recipe's phase 3: run_training of the full detector from the
    imported backbone, negative chips mined from (r3)'s proposals, twice
    with the same steps: the thread loader, then the loader process.
    Returns (ok, launches of the thread-loader run, of the process run)."""
    import copy

    from sniper_tpu_torch.main_train import build_roidb, make_loader
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.ops import cuda
    from sniper_tpu_torch.train.pretrained import load_pretrained

    roidb = build_roidb(cfg, lambda m: print(f"recipe (r4) {m}"),
                        datasets=[ds])
    bs = cfg.TRAIN.BATCH_IMAGES
    cfgs = {}
    for process in (False, True):
        cfgs[process] = copy.deepcopy(cfg)
        cfgs[process].TRAIN.LOADER_PROCESS = process
    # the loaders alone, in turns: threads, process, process, threads
    loader_ms = {False: [], True: []}
    for process in (False, True, True, False):
        loader_ms[process].append(loader_ms_per_batch(roidb, cfgs[process]))
    ok = True
    runs = {}
    for process in (False, True):
        run_cfg = cfgs[process]
        tag = f"recipe (r4, {'loader process' if process else 'threads'})"
        model = init_detector(get_model(run_cfg), seed=0)
        load_pretrained(run_cfg, model, lambda m: print(f"{tag} {m}"))
        run_roidb = copy.deepcopy(roidb)
        loader = make_loader(run_roidb, run_cfg, 0,
                             image_loader=synth_train_image)
        try:
            good, launches, med = timed_training(
                dev, run_cfg, model, loader, card, tag,
                every_step=(cuda.POOL_BWD.name, cuda.DEFORM_IM2COL_BWD.name))
        finally:
            loader.close()
        if not process:  # the thread loader's roidb holds the epoch's roll
            mined = sum(len(r.get("neg_chips", [])) for r in run_roidb)
            sampled = sum(len(r["crops"]) for r in run_roidb)
            good &= mined > 0
            print(f"{tag} negative chips mined from the extracted "
                  f"proposals: {mined} (at most 2 per image sampled into "
                  f"the epoch's {sampled} chips): "
                  f"{'PASS' if mined > 0 else 'FAIL'}")
        ok &= good
        runs[process] = (launches, med)
        del model
        torch.cuda.empty_cache()
    (l_t, med_t), (l_p, med_p) = runs[False], runs[True]

    def ms(v):
        return " and ".join(f"{x:.1f}" for x in v)

    print(f"recipe (r4) {CONFIG} at BATCH_IMAGES {bs}, "
          f"{cfg.TRAIN.CHIP_SIZE}x{cfg.TRAIN.CHIP_SIZE} chips, NUM_THREAD "
          f"{cfg.TRAIN.NUM_THREAD}: thread loader median {med_t:.1f} ms per "
          f"step (loader alone {ms(loader_ms[False])} ms per batch); loader "
          f"process median {med_p:.1f} ms per step (loader alone "
          f"{ms(loader_ms[True])} ms per batch; the loaders alone timed in "
          f"turns threads, process, process, threads over 8 batches each) "
          f"[{card}]; one call, host clock: a smoke reading")
    return ok, l_t, l_p


def mask_training(dev, mcfg, tmp: str, prefix: str,
                  card: str) -> tuple[bool, dict]:
    """The mask yml's training from the recipe's pieces: (m1) the one-step
    check with the mask branch; (m2) run_training from (r1)'s backbone with
    negative chips mined from (r3)'s proposals over the synthetic images
    with polygons (flipped with them), the thread loader, its checkpoint
    written; (m3) main_test's restore of that checkpoint and run_detection
    with masks on two images. Returns (ok, (m2)'s launches)."""
    import copy

    from sniper_tpu_torch.config import config_name
    from sniper_tpu_torch.data.test_loader import (
        TestChipIterator,
        init_inference_crops,
    )
    from sniper_tpu_torch.main_test import (
        _scale_post_nms,
        make_forward,
        run_detection,
    )
    from sniper_tpu_torch.main_train import build_roidb, make_loader
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.ops import cuda
    from sniper_tpu_torch.train.checkpoint import restore_inference_state
    from sniper_tpu_torch.train.pretrained import load_pretrained

    mcfg = train_cfg(mcfg)
    mcfg.output_path = os.path.join(tmp, "output")
    mcfg.proposal_path = os.path.join(tmp, "proposals")
    mcfg.network.pretrained = prefix
    ok1 = train_step_check(dev, mcfg, "mask (m1)")

    def log(m):
        print(f"mask (m2) {m}")

    roidb = build_roidb(mcfg, log, datasets=[SynthMaskDataset()])
    polys = sum(len(r["gt_masks"]) for r in roidb)
    loader_ms = loader_ms_per_batch(roidb, mcfg)
    model = init_detector(get_model(mcfg), seed=0)
    load_pretrained(mcfg, model, log)
    model.to(dev)
    params = dict(model.named_parameters())
    before = {k: params[k].detach().clone() for k in MASK_LEAVES}
    grad_norms: dict = {k: [] for k in MASK_LEAVES}

    def read_grads():  # a tensor hook would keep the step eager
        for k in MASK_LEAVES:
            grad_norms[k].append(params[k].grad.detach().norm())

    out_dir = os.path.join(mcfg.output_path, config_name(MASK_CONFIG),
                           mcfg.dataset.image_set)
    print(f"mask (m2) {MASK_CONFIG}: units {model.trunk.units}, "
          f"{mcfg.dataset.NUM_CLASSES} classes, BATCH_IMAGES "
          f"{mcfg.TRAIN.BATCH_IMAGES}, chips {mcfg.TRAIN.CHIP_SIZE}, "
          f"{model.num_rois} sampled rois and {model.num_mask_rois} mask rois "
          f"per chip, trunk dtype {model.dtype}, mask head fp32, from the "
          f"imported backbone; {len(roidb)} images with {polys} polygons "
          f"(flips included); the loader alone {loader_ms:.1f} ms per batch "
          f"(8 batches, gt_masks [{mcfg.TRAIN.BATCH_IMAGES}, "
          f"{mcfg.TRAIN.MAX_GT_BOXES}, 112, 112] uint8)")
    run_roidb = copy.deepcopy(roidb)
    loader = make_loader(run_roidb, mcfg, 0, image_loader=synth_train_image)
    per_step = {cuda.DEFORM_IM2COL.name: 3, cuda.DEFORM_IM2COL_BWD.name: 3,
                cuda.NMS.name: 1, cuda.FUSED_POOL.name: 4,
                cuda.POOL_BWD.name: 4, cuda.ROI_PATCH.name: 0,
                cuda.UNIT_EPILOGUE.name: EPILOGUES_STEP}
    try:
        ok2, launches, _ = timed_training(
            dev, mcfg, model, loader, card, "mask (m2)", out_dir=out_dir,
            every_step=(cuda.POOL_BWD.name, cuda.DEFORM_IM2COL_BWD.name),
            idle=(cuda.ROI_PATCH.name,), per_step=per_step,
            varying=("mask_loss",), after_step=read_grads)
    finally:
        loader.close()
    mined = sum(len(r.get("neg_chips", [])) for r in run_roidb)
    ckpt = os.path.join(out_dir, "checkpoints", "epoch_0001.pt")
    ok2 &= mined > 0 and os.path.exists(ckpt)
    # the mask branch trains: its leaves get a gradient at every step,
    # finite, and nonzero over the run
    grads_ok, moved = True, []
    for k in MASK_LEAVES:
        norms = [float(n) for n in grad_norms[k]]
        grads_ok &= (len(norms) == WARMUP_STEPS + TIMED_STEPS
                     and all(math.isfinite(n) for n in norms)
                     and max(norms) > 0)
        move = float((params[k].detach() - before[k]).norm())
        moved.append(f"{k} gradient norm {min(norms, default=0):.3e} to "
                     f"{max(norms, default=0):.3e} over "
                     f"{len(norms)} steps, moved {move:.3e}")
    ok2 &= grads_ok
    print(f"mask (m2) negative chips mined from (r3)'s proposals: {mined}; "
          f"checkpoint {ckpt} written {os.path.exists(ckpt)}; the mask "
          f"layers: {'; '.join(moved)}; every step's gradient finite and "
          f"some nonzero {grads_ok}: {'PASS' if ok2 else 'FAIL'}")
    del model
    torch.cuda.empty_cache()

    tcfg = copy.deepcopy(mcfg)
    tcfg.TEST.TEST_EPOCH = mcfg.TRAIN.end_epoch
    model = get_model(tcfg)
    source = restore_inference_state(tcfg, model, config_name(MASK_CONFIG),
                                     lambda m: print(f"mask (m3) {m}"))
    model.to(dev).eval()
    roidb = [{"image": f"im{i}", "width": IM_W, "height": IM_H,
              "flipped": False} for i in range(2)]
    # a few steps on synthetic images leave the foreground scores below the
    # Tester's default threshold (1e-3): the restored model's scale-0
    # forward sets it under the scores of the rois inside scale 0's valid
    # range, so that run_detection keeps detections and their masks
    init_inference_crops(roidb)
    n = _scale_post_nms(tcfg, 0, model)
    batch = next(iter(TestChipIterator(roidb, tcfg, 0, 2,
                                       image_loader=synth_image)))
    out = make_forward(model, None, dev, tcfg.network.PIXEL_MEANS, n)(
        batch["data"], batch["im_info"])
    mp = out["mask_prob"]
    fwd_ok = (tuple(mp.shape) == (2, n, model.mask_size, model.mask_size)
              and bool(torch.isfinite(mp).all()) and float(mp.min()) >= 0
              and float(mp.max()) <= 1)
    fg = out["cls_prob"][..., 1:].float()
    thresh = in_range_threshold(out, batch["im_info"],
                                tcfg.TEST.VALID_RANGES[0])
    with tempfile.TemporaryDirectory() as det_dir, class_threshold(thresh):
        stats = run_detection(tcfg, model, None, roidb,
                              MaskCountingDataset(paste=False), det_dir, dev,
                              image_loader=synth_image)
    n_det = stats["bbox"]["detections"]
    ok3 = (source == "checkpoint" and fwd_ok and n_det > 0
           and stats["segm"]["masks"] == n_det)
    print(f"mask (m3) main_test's restore ({source}) of (m2)'s checkpoint; "
          f"the restored model's scale-0 forward: mask_prob "
          f"{list(mp.shape)} in [{float(mp.min()):.4f}, "
          f"{float(mp.max()):.4f}], finite {bool(torch.isfinite(mp).all())}, "
          f"largest foreground score {float(fg.max()):.3e}; run_detection "
          f"with masks on 2 synthetic {IM_W}x{IM_H} images at class "
          f"threshold {thresh:.3e}: {stats} (every kept mask finite and in "
          f"[0, 1], one per detection, some kept): "
          f"{'PASS' if ok3 else 'FAIL'}")
    del model
    torch.cuda.empty_cache()
    print(f"mask training: (m1) {'PASS' if ok1 else 'FAIL'}, (m2) "
          f"{'PASS' if ok2 else 'FAIL'}, (m3) {'PASS' if ok3 else 'FAIL'}")
    return ok1 and ok2 and ok3, launches


# ---------------------------------------------------------------------------
# phase 6: AutoFocus
# ---------------------------------------------------------------------------

AF_REPS = 4  # timed run_detection passes per mode in AutoFocus (c)
AF_DENSITIES = (0.05, 0.2)


@contextlib.contextmanager
def scale_clock():
    """Time each scale's Tester.get_detections (it returns after its last
    batch's outputs reached the host), its batches assembled on the host
    before the clock starts, then the forward alone over the same batches.
    Yields the list of (ms, forward-only ms, batches, detections the scale
    hands to the aggregation), one per call (restored on exit)."""
    from sniper_tpu_torch.infer.tester import Tester

    real = Tester.get_detections
    calls = []

    def timed(self, batches, *args, **kw):
        batches = list(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(self, iter(batches), *args, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for b in batches:
            self.forward_fn(b["data"], b["im_info"])
        torch.cuda.synchronize()
        kept = sum(len(d) for cls in out[0][1:] for im in cls for d in im)
        calls.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3,
                      len(batches), kept))
        return out

    Tester.get_detections = timed
    try:
        yield calls
    finally:
        Tester.get_detections = real


def af_images(n: int) -> tuple[list, callable]:
    """(roidb, image loader) of n of phase 3's synthetic images, made once
    (the loader hands back the cached array: no decode in the timings)."""
    cache = {f"im{i}": synth_image(f"im{i}") for i in range(n)}
    roidb = [{"image": f"im{i}", "width": IM_W, "height": IM_H,
              "flipped": False} for i in range(n)]
    return roidb, cache.__getitem__


def af_pipeline(dev, cfg, model, density, card: str, tag: str) -> bool:
    """AutoFocus (c): one warm-up and AF_REPS timed passes of run_detection
    over N_IMAGES images (sniper_tpu_torch/bench_autofocus.run_pipeline),
    with planted maps at ``density`` (None: the full pyramid,
    TEST.AUTO_FOCUS off). Prints per-scale ms per batch, img/s, percent of
    pixels, add_chips' host ms per image and peak memory."""
    from sniper_tpu_torch.bench_autofocus import run_pipeline

    roidb, loader = af_images(N_IMAGES)
    n_scales = len(cfg.TEST.SCALES)
    walls, per_scale, af, dets = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    for rep in range(AF_REPS + 1):
        with scale_clock() as clock:
            wall, chips, stats = run_pipeline(cfg, model, dev, roidb, loader,
                                              density)
        if rep == 0:
            continue  # warm-up: cuDNN's first calls at each canvas
        # less the forward-only sweeps that scale_clock adds
        walls.append(wall - sum(c[1] for c in clock) / 1e3)
        per_scale.append(clock)
        af.append(chips)
        dets.append(stats["detections"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    parts, fwd_ms = [], 0.0
    for s in range(n_scales):
        nb = max(per_scale[0][s][2], 1)
        ms = sorted(c[s][0] / nb for c in per_scale)
        fw = sorted(c[s][1] / nb for c in per_scale)
        fwd_ms += fw[len(fw) // 2] * nb
        parts.append(f"scale {s} {nb} batches of {cfg.TEST.BATCH_IMAGES[s]}"
                     f", {per_scale[0][s][3] / N_IMAGES:.0f} detections "
                     f"per image into the aggregation"
                     f": median {ms[len(ms) // 2]:.2f} ms/batch (min "
                     f"{ms[0]:.2f}, max {ms[-1]:.2f}), the forward alone "
                     f"{fw[len(fw) // 2]:.2f} (min {fw[0]:.2f}, max "
                     f"{fw[-1]:.2f})")
    # run_detection's time outside its scales' get_detections: add_chips
    # and the aggregation (soft-NMS over every kept detection)
    outside = sorted(w * 1e3 - sum(c[0] for c in clock)
                     for w, clock in zip(walls, per_scale))
    walls.sort()
    med = walls[len(walls) // 2]
    pct = "; ".join(
        f"scale {c['scale']} -> {c['scale'] + 1}: {c['pct']:.1f}% of pixels, "
        f"{sum(c['chips'])} FocusChips"
        for c in af[0]) if af[0] else "100% (every scale on full images)"
    host = (sorted(sum(c["host_ms"] for c in a) / N_IMAGES for a in af)
            if af[0] else [0.0])
    ok = (all(d == dets[0] for d in dets) and dets[0] > 0
          and len(af[0]) == (n_scales - 1 if density is not None else 0))
    mode = (f"planted maps at density {density}" if density is not None
            else "full pyramid (TEST.AUTO_FOCUS off)")
    print(f"{tag} {mode}: {'; '.join(parts)}; run_detection median "
          f"{med * 1e3:.1f} ms (min {walls[0] * 1e3:.1f}, max "
          f"{walls[-1] * 1e3:.1f}) over {AF_REPS} passes, "
          f"{N_IMAGES / med:.1f} img/s, of which outside the scales "
          f"(add_chips, aggregation's soft-NMS) median "
          f"{outside[len(outside) // 2]:.1f} ms; the forward alone "
          f"{fwd_ms:.1f} ms over the scales' batches, "
          f"{N_IMAGES * 1e3 / fwd_ms:.1f} img/s; {pct}; add_chips "
          f"host {host[len(host) // 2]:.2f} ms per image; peak memory "
          f"{peak:.2f} GiB; {dets[0]} detections in every pass "
          f"[{card}]; host clock, synthetic images, random weights: a "
          f"smoke reading: {'PASS' if ok else 'FAIL'}")
    return ok


def autofocus_inference(dev, acfg, amcfg, card: str) -> tuple[bool, dict]:
    """AutoFocus inference of configs/sniper_res101_e2e_autofocus.yml at
    full width and depth with seeded random weights: (a) the kernel path
    against the plain path on one FocusChip batch of scale 1's smallest
    tier; (b) run_detection with the head's own maps, counters zeroed just
    before and read just after; (c) run_detection with planted maps at
    AF_DENSITIES and the full pyramid; (d) the mask config's masked
    inference over two images with planted maps, pasted and RLE-encoded.
    Returns (ok, (b)'s launches)."""
    import copy

    from sniper_tpu_torch.bench_autofocus import focus_chips
    from sniper_tpu_torch.data.test_loader import (
        canvas_for_scale,
        tier_canvases,
    )
    from sniper_tpu_torch.main_test import run_detection
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.ops import cuda

    model = get_model(acfg)
    init_detector(model, seed=0, offset_std=1e-3)
    model.to(dev).eval()
    print(f"autofocus: {AF_CONFIG}: units {model.trunk.units}, "
          f"{acfg.dataset.NUM_CLASSES} classes, scales coarse to fine "
          f"{[tuple(s) for s in acfg.TEST.SCALES]}, batches "
          f"{list(acfg.TEST.BATCH_IMAGES)}, {model.post_nms_top_n} rois per "
          f"image at every scale, CHIP_HYPERPARAMS "
          f"{[list(h) for h in acfg.TEST.CHIP_HYPERPARAMS]}, DO_PRUNING "
          f"{list(acfg.TEST.DO_PRUNING)}, trunk dtype {model.dtype}; "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, "
          f"seeded random weights (seed 0, offsets normal(1e-3))")
    ok = True

    # (a) one FocusChip batch of scale 1's smallest tier
    th, tw = tier_canvases(canvas_for_scale(acfg.TEST.SCALES[1])[0])[0]
    g = torch.Generator().manual_seed(13)
    bs = int(acfg.TEST.BATCH_IMAGES[1])
    data = (torch.randn(bs, th, tw, 3, generator=g) * 50).to(dev)
    info = torch.tensor([[th - 16.0 * (i % 3), tw - 24.0 * (i % 2), 1.0]
                         for i in range(bs)], device=dev)
    with torch.inference_mode():
        torch.backends.cudnn.deterministic = True
        out_k = model(data, info)
        with plain_versions():
            out_p = model(data, info)
        torch.backends.cudnn.deterministic = False
    torch.cuda.synchronize()
    same_rois = torch.equal(out_k["rois"], out_p["rois"])
    errs = {k: float((out_k[k] - out_p[k]).abs().max())
            for k in ("focus_prob", "cls_prob", "bbox_pred")}
    fp = out_k["focus_prob"]
    good = (same_rois and all(e <= 1e-3 for e in errs.values())
            and tuple(fp.shape) == (bs, th // 16, tw // 16)
            and bool(torch.isfinite(fp).all()))
    print(f"autofocus (a) a FocusChip batch of {bs} on scale 1's {th}x{tw} "
          f"tier, kernel path vs plain path on the card: rois identical "
          f"{same_rois}, max abs err {errs}; focus_prob {list(fp.shape)} in "
          f"[{float(fp.min()):.4f}, {float(fp.max()):.4f}]; tolerance 1e-3 "
          f"(phase 3 (a)'s): {'PASS' if good else 'FAIL'}")
    ok &= good

    # the head's cost at the finest scale, whose map nothing reads: the
    # device time of head + softmax on that scale's feat, and the host copy
    # of its map (detect_outputs copies every scale's)
    fs = main_path_shapes(acfg)[-1]
    feat = torch.randn(fs["B"], model.autofocus.conv_new_2.in_channels,
                       fs["H"], fs["W"], device=dev, dtype=model.dtype,
                       generator=torch.Generator(dev).manual_seed(14))

    def focus_prob():
        return torch.softmax(model.autofocus(feat), dim=-1)[..., 1]

    with torch.inference_mode():
        head_ms = time_ms(focus_prob, 20)
        prob = focus_prob()
        copies = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prob.cpu()
            copies.append((time.perf_counter() - t0) * 1e3)
    del feat, prob
    print(f"autofocus head at the finest scale ({fs['label']}: batch "
          f"{fs['B']}, {fs['H']}x{fs['W']} map, {model.dtype}): "
          f"{head_ms:.3f} ms of device time per batch (CUDA events, mean of "
          f"20), host copy of its map median {np.median(copies):.3f} ms "
          f"(host clock, 20 copies) [{card}]")

    # (b) run_detection with the head's own maps
    roidb, loader = af_images(N_IMAGES)
    for k in cuda.KERNELS:
        k.launches = 0
    with focus_chips() as chips, tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        stats = run_detection(acfg, model, None, roidb, Detections(81),
                              out_dir, dev, image_loader=loader)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in cuda.KERNELS}
    batches = launches[cuda.NMS.name]
    good = (stats["detections"] > 0 and len(chips) == 2
            and all(launches[n] > 0 for n in INFERENCE_KERNELS)
            and launches[cuda.FUSED_POOL.name] == 2 * batches
            and launches[cuda.DEFORM_IM2COL.name] == 3 * batches
            and launches[cuda.ROI_PATCH.name] == 0)
    print(f"autofocus (b) run_detection with the head's own maps over "
          f"{N_IMAGES} synthetic {IM_W}x{IM_H} images: {stats}; FocusChips "
          + "; ".join(f"after scale {c['scale']}: {sum(c['chips'])} "
                      f"({c['pct']:.1f}% of the next scale's pixels)"
                      for c in chips)
          + f"; launches {launches} over {batches} counted forwards (the "
          f"eager calls and the captures; NMS 1, im2col 3, pool 2 each; P5 "
          f"0), {wall:.2f} s wall including first-call set-up and captures: "
          f"{'PASS' if good else 'FAIL'}")
    ok &= good

    # (c) planted maps against the full pyramid, same scales and batches
    for density in AF_DENSITIES + (None,):
        ok &= af_pipeline(dev, acfg, model, density, card, "autofocus (c)")
    del model
    torch.cuda.empty_cache()

    # (d) the mask config, two images, planted maps
    mmodel = get_model(amcfg)
    init_detector(mmodel, seed=0, offset_std=1e-3)
    mmodel.to(dev).eval()
    roidb, loader = af_images(2)
    with focus_chips(AF_DENSITIES[1]) as chips, \
            tempfile.TemporaryDirectory() as out_dir:
        stats = run_detection(copy.deepcopy(amcfg), mmodel, None, roidb,
                              MaskCountingDataset(), out_dir, dev,
                              image_loader=loader)
    good = (stats["bbox"]["detections"] > 0
            and stats["segm"]["masks"] == stats["bbox"]["detections"]
            and len(chips) == 2)
    print(f"autofocus (d) {AF_MASK_CONFIG}: run_detection with masks over 2 "
          f"synthetic images, maps planted at density {AF_DENSITIES[1]}: "
          f"FocusChips {[sum(c['chips']) for c in chips]}; {stats} (every "
          f"mask finite and in [0, 1], one per detection, image 0's pasted "
          f"and RLE-encoded): {'PASS' if good else 'FAIL'}")
    ok &= good
    del mmodel
    torch.cuda.empty_cache()
    return ok, launches


def autofocus_training(dev, acfg, tmp: str, prefix: str,
                       card: str) -> tuple[bool, dict]:
    """The AutoFocus yml's training from the recipe's pieces: (t1) the
    one-step check with the FocusPixel head; (t2) run_training from (r1)'s
    backbone with negative chips mined from (r3)'s proposals, the thread
    loader, each step's launches checked, focus_loss moving and the head's
    gradients finite and nonzero, its checkpoint written; (t3) main_test's
    restore of that checkpoint and run_detection over two images. Returns
    (ok, (t2)'s launches)."""
    import copy

    from sniper_tpu_torch.bench_autofocus import focus_chips
    from sniper_tpu_torch.config import config_name
    from sniper_tpu_torch.data.test_loader import (
        TestChipIterator,
        init_inference_crops,
    )
    from sniper_tpu_torch.main_test import (
        _scale_post_nms,
        make_forward,
        run_detection,
    )
    from sniper_tpu_torch.main_train import build_roidb, make_loader
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.ops import cuda
    from sniper_tpu_torch.train.checkpoint import restore_inference_state
    from sniper_tpu_torch.train.pretrained import load_pretrained

    acfg = train_cfg(acfg)
    acfg.output_path = os.path.join(tmp, "output")
    acfg.proposal_path = os.path.join(tmp, "proposals")
    acfg.network.pretrained = prefix
    ok1 = train_step_check(dev, acfg, "autofocus (t1)")

    def log(m):
        print(f"autofocus (t2) {m}")

    roidb = build_roidb(acfg, log, datasets=[SynthTrainDataset()])
    loader_ms = loader_ms_per_batch(roidb, acfg)
    model = init_detector(get_model(acfg), seed=0)
    load_pretrained(acfg, model, log)
    model.to(dev)
    params = dict(model.named_parameters())
    grad_norms: dict = {k: [] for k in AF_LEAVES}

    def read_grads():  # a tensor hook would keep the step eager
        for k in AF_LEAVES:
            grad_norms[k].append(params[k].grad.detach().norm())

    out_dir = os.path.join(acfg.output_path, config_name(AF_CONFIG),
                           acfg.dataset.image_set)
    print(f"autofocus (t2) {AF_CONFIG}: units {model.trunk.units}, "
          f"BATCH_IMAGES {acfg.TRAIN.BATCH_IMAGES}, chips "
          f"{acfg.TRAIN.CHIP_SIZE}, FocusPixel labels at AUTO_FOCUS_"
          f"SMALL_THRESH {acfg.TRAIN.AUTO_FOCUS_SMALL_THRESH}, DC_LOW "
          f"{acfg.TRAIN.AUTO_FOCUS_DC_LOW}, DC_HIGH "
          f"{acfg.TRAIN.AUTO_FOCUS_DC_HIGH}, trunk dtype {model.dtype}, "
          f"from the imported backbone; the loader alone {loader_ms:.1f} ms "
          f"per batch (8 batches, scale_label [{acfg.TRAIN.BATCH_IMAGES}, "
          f"{(acfg.TRAIN.CHIP_SIZE // 16) ** 2}] float32)")
    run_roidb = copy.deepcopy(roidb)
    loader = make_loader(run_roidb, acfg, 0, image_loader=synth_train_image)
    per_step = {cuda.DEFORM_IM2COL.name: 3, cuda.DEFORM_IM2COL_BWD.name: 3,
                cuda.NMS.name: 1, cuda.FUSED_POOL.name: 2,
                cuda.POOL_BWD.name: 2, cuda.ROI_PATCH.name: 0,
                cuda.UNIT_EPILOGUE.name: EPILOGUES_STEP}
    try:
        ok2, launches, _ = timed_training(
            dev, acfg, model, loader, card, "autofocus (t2)",
            out_dir=out_dir,
            every_step=(cuda.POOL_BWD.name, cuda.DEFORM_IM2COL_BWD.name),
            idle=(cuda.ROI_PATCH.name,), per_step=per_step,
            varying=("focus_loss",), after_step=read_grads)
    finally:
        loader.close()
    mined = sum(len(r.get("neg_chips", [])) for r in run_roidb)
    ckpt = os.path.join(out_dir, "checkpoints", "epoch_0001.pt")
    ok2 &= mined > 0 and os.path.exists(ckpt)
    grads_ok, parts = True, []
    for k in AF_LEAVES:
        norms = [float(n) for n in grad_norms[k]]
        grads_ok &= (len(norms) == WARMUP_STEPS + TIMED_STEPS
                     and all(math.isfinite(n) and n > 0 for n in norms))
        parts.append(f"{k} {min(norms, default=0):.3e} to "
                     f"{max(norms, default=0):.3e}")
    ok2 &= grads_ok
    print(f"autofocus (t2) negative chips mined from (r3)'s proposals: "
          f"{mined}; checkpoint written {os.path.exists(ckpt)}; the "
          f"FocusPixel head's gradient norms over {len(grad_norms[AF_LEAVES[0]])}"
          f" steps: {'; '.join(parts)}; every step's finite and nonzero "
          f"{grads_ok}: {'PASS' if ok2 else 'FAIL'}")
    del model
    torch.cuda.empty_cache()

    tcfg = copy.deepcopy(acfg)
    tcfg.TEST.TEST_EPOCH = acfg.TRAIN.end_epoch
    model = get_model(tcfg)
    source = restore_inference_state(tcfg, model, config_name(AF_CONFIG),
                                     lambda m: print(f"autofocus (t3) {m}"))
    model.to(dev).eval()
    roidb, loader = af_images(2)
    # as (m3): a class threshold under the restored model's scores
    init_inference_crops(roidb)
    batch = next(iter(TestChipIterator(roidb, tcfg, 0, 2,
                                       image_loader=loader)))
    out = make_forward(model, None, dev, tcfg.network.PIXEL_MEANS,
                       _scale_post_nms(tcfg, 0, model))(
        batch["data"], batch["im_info"])
    fp = out["focus_prob"]
    # scale 0 keeps only boxes of 75 px and more, and the finer scales prune
    # the boxes at their FocusChips' borders: the threshold comes from the
    # rois inside scale 0's valid range
    thresh = in_range_threshold(out, batch["im_info"],
                                tcfg.TEST.VALID_RANGES[0])
    with tempfile.TemporaryDirectory() as det_dir, class_threshold(thresh), \
            focus_chips() as chips:
        stats = run_detection(tcfg, model, None, roidb, Detections(81),
                              det_dir, dev, image_loader=loader)
    ok3 = (source == "checkpoint" and stats["detections"] > 0
           and len(chips) == 2 and bool(torch.isfinite(fp).all()))
    pct = ", ".join(f"{c['pct']:.1f}%" for c in chips)
    print(f"autofocus (t3) main_test's restore ({source}) of (t2)'s "
          f"checkpoint; its scale-0 focus_prob in [{float(fp.min()):.4f}, "
          f"{float(fp.max()):.4f}]; run_detection coarse to fine on 2 "
          f"synthetic images at class threshold {thresh:.3e}: FocusChips "
          f"{[sum(c['chips']) for c in chips]} ({pct} of the pixels), "
          f"{stats}: {'PASS' if ok3 else 'FAIL'}")
    del model
    torch.cuda.empty_cache()
    print(f"autofocus training: (t1) {'PASS' if ok1 else 'FAIL'}, (t2) "
          f"{'PASS' if ok2 else 'FAIL'}, (t3) {'PASS' if ok3 else 'FAIL'}")
    return ok1 and ok2 and ok3, launches


# ---------------------------------------------------------------------------
# phase 7: the model zoo
# ---------------------------------------------------------------------------

ZOO_CONFIG = "configs/sniper_mobilenetv2_e2e.yml"
X101_SYMBOL = "resnext_mx_101"  # on CONFIG, as `--set symbol resnext_mx_101`
ZOO_REPS = 5  # timed passes over each scale's batches in (z1) and (z3)
ZOO_TIMED_STEPS = 10  # after WARMUP_STEPS, in (z2) and (z4)


def zoo_cfgs(root: str) -> dict:
    """The zoo's two configurations as the CLIs load them: the flagship yml
    with the X101 symbol (neither the reference nor this repository ships
    an X101 yml), and MobileNetV2's yml."""
    from sniper_tpu_torch.config import load_config

    return {"x101": load_config(os.path.join(root, CONFIG),
                                ["symbol", X101_SYMBOL]),
            "mobilenetv2": load_config(os.path.join(root, ZOO_CONFIG))}


def zoo_inference(dev, zcfg, tag: str, card: str,
                  per_batch: dict) -> tuple[bool, dict]:
    """(z1)/(z3): the model at full width and depth with seeded random
    weights: (a) the kernel path against the plain path on a small input,
    phase 3 (a)'s bounds; (b) run_detection over phase 3's synthetic
    images, counters zeroed just before and read just after, each kernel
    launched ``per_batch`` times per counted forward (the eager calls and
    the captures: one NMS call each), at most one a batch; (c) per-scale
    ms per batch (median and min-max over ZOO_REPS host-clocked passes),
    img/s, peak memory, the trunk's share of the forward's device time
    (CUDA events on one batch) and ``replay_check``. Returns (ok, (b)'s
    launches)."""
    from sniper_tpu_torch.data.test_loader import (
        TestChipIterator,
        init_inference_crops,
    )
    from sniper_tpu_torch.infer.tester import device_normalize
    from sniper_tpu_torch.main_test import (
        _scale_post_nms,
        make_forward,
        run_detection,
    )
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.ops import cuda

    model = init_detector(get_model(zcfg), seed=0, offset_std=1e-3)
    model.to(dev).eval()
    print(f"{tag}: symbol {zcfg.symbol}, trunk {model.trunk_type}, stride "
          f"{model.feat_stride}, head fc {model.rcnn.fc_new_2.weight.shape[0]}"
          f", {zcfg.dataset.NUM_CLASSES} classes, scales "
          f"{[tuple(s) for s in zcfg.TEST.SCALES]}, batches "
          f"{list(zcfg.TEST.BATCH_IMAGES)}, post-NMS per scale "
          f"{list(zcfg.TEST.N_PROPOSAL_PER_SCALE)}, trunk dtype {model.dtype};"
          f" {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, "
          f"seeded random weights (seed 0, offsets normal(1e-3))")
    ok = True

    # (a) kernel path against the plain path, on a small input
    g = torch.Generator().manual_seed(13)
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
    print(f"{tag} (a) 256x320 input, kernel path vs plain path on the card: "
          f"rois identical {same_rois}, cls_prob max abs err {err:.3e}, "
          f"bbox_pred max abs err {berr:.3e}; tolerance 1e-3 (phase 3 "
          f"(a)'s): {'PASS' if good else 'FAIL'}")
    ok &= good

    # (b) run_detection over the synthetic images
    roidb = [{"image": f"im{i}", "width": IM_W, "height": IM_H,
              "flipped": False} for i in range(N_IMAGES)]
    for k in cuda.KERNELS:
        k.launches = 0
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        stats = run_detection(zcfg, model, None, roidb, Detections(81),
                              out_dir, dev, image_loader=synth_image)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in cuda.KERNELS}

    # (c) per-scale forward times at the shipped batch sizes
    init_inference_crops(roidb)
    torch.cuda.reset_peak_memory_stats()
    ms_per_image, n_batches = 0.0, 0
    for s in range(len(zcfg.TEST.SCALES)):
        bs = zcfg.TEST.BATCH_IMAGES[s]
        n = _scale_post_nms(zcfg, s, model)
        batches = list(TestChipIterator(roidb, zcfg, s, bs,
                                        image_loader=synth_image))
        n_batches += len(batches)
        fwd = make_forward(model, None, dev, zcfg.network.PIXEL_MEANS, n)
        out = fwd(batches[0]["data"], batches[0]["im_info"])
        torch.cuda.synchronize()
        shapes_ok = (tuple(out["rois"].shape) == (bs, n, 5)
                     and tuple(out["cls_prob"].shape) == (bs, n, 81)
                     and all(bool(torch.isfinite(out[k]).all())
                             for k in ("rois", "cls_prob", "bbox_pred")))
        per_rep = []
        for _ in range(ZOO_REPS):
            t0 = time.perf_counter()
            for b in batches:
                fwd(b["data"], b["im_info"])
            torch.cuda.synchronize()
            per_rep.append((time.perf_counter() - t0) * 1e3 / len(batches))
        per_rep.sort()
        ms = per_rep[len(per_rep) // 2]
        # the trunk's share of the forward's device time, on batch 0
        info0 = torch.as_tensor(batches[0]["im_info"],
                                dtype=torch.float32).to(dev)
        x0 = device_normalize(torch.as_tensor(batches[0]["data"]).to(dev),
                              info0, zcfg.network.PIXEL_MEANS)
        with torch.inference_mode():
            trunk_ms = time_ms(lambda: model.trunk(x0.permute(0, 3, 1, 2)),
                               3)
            fwd_ms = time_ms(lambda: model(x0, info0, post_nms_top_n=n), 3)
        hw = batches[0]["data"].shape[1:3]
        replayed, reading = replay_check(fwd, model, batches[0]["data"],
                                         batches[0]["im_info"])
        print(f"{tag} (c) scale {s}: canvas {hw[0]}x{hw[1]}, batch {bs}, {n} "
              f"rois/img: median {ms:.2f} ms/batch (min {per_rep[0]:.2f}, max "
              f"{per_rep[-1]:.2f} over {ZOO_REPS} passes of {len(batches)} "
              f"batches), {bs * 1e3 / ms:.1f} img/s [{card}]; device time of "
              f"one batch's forward {fwd_ms:.2f} ms, its trunk {trunk_ms:.2f} "
              f"ms ({100 * trunk_ms / fwd_ms:.1f}%); shapes and finiteness "
              f"{'PASS' if shapes_ok else 'FAIL'}; {reading}")
        ok &= shapes_ok and replayed
        ms_per_image += ms / bs
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{tag} (c) three-scale pyramid: {ms_per_image:.2f} ms/img, "
          f"{1e3 / ms_per_image:.1f} img/s, peak memory {peak:.2f} GiB "
          f"(forward only, sum of the scales' medians, random weights; a "
          f"smoke reading) [{card}]")
    counted = launches[cuda.NMS.name]
    exact = (0 < counted <= n_batches
             and all(launches[k] == c * counted for k, c in per_batch.items()))
    good = stats["detections"] > 0 and exact
    print(f"{tag} (b) run_detection over {N_IMAGES} synthetic {IM_W}x{IM_H} "
          f"images: {stats}, launches {launches} over {counted} counted "
          f"forwards (the eager calls and the captures) of {n_batches} "
          f"batches, per counted forward exactly {per_batch}: {exact}; "
          f"{wall:.2f} s wall including first-call set-up and captures: "
          f"{'PASS' if good else 'FAIL'}")
    ok &= good
    del model
    torch.cuda.empty_cache()
    return ok, launches


def x101_backbone(cfg, model, tmp: str, tag: str) -> bool:
    """(z2) A synthetic ImageNet-style X101 backbone written as an MXNet
    .params file from mapping_rows, imported by load_pretrained. Under the
    yml's FIXED_PARAMS the import raises, as the JAX package's does: no
    import row reaches stage 1's ``sc_bn`` (ROADMAP.md Queue 3); so it
    imports with ``stage1`` out of FIXED_PARAMS (the training keeps the
    yml's), every loaded tensor held against the file."""
    import copy

    from sniper_tpu_torch.train.pretrained import (
        MXParamsError,
        load_pretrained,
    )

    prefix = os.path.join(tmp, X101_SYMBOL)
    path = f"{prefix}-0000.params"
    flat = synthetic_backbone(model, path)
    cfg.network.pretrained = prefix
    try:
        load_pretrained(cfg, model, lambda m: None)
        raised = ""
    except MXParamsError as e:
        raised = str(e)
    relaxed = copy.deepcopy(cfg)
    relaxed.network.FIXED_PARAMS = [p for p in cfg.network.FIXED_PARAMS
                                    if p != "stage1"]
    report = load_pretrained(relaxed, model, lambda m: print(f"{tag} {m}"))
    state = model.state_dict()
    equal = all(np.array_equal(state[key].numpy(), flat[mx])
                for key, mx in report.loaded)
    classifier = ["fc1_bias", "fc1_weight"]
    ok = ("sc_bn" in raised and equal and not report.mismatched
          and len(report.loaded) == len(flat) - len(classifier)
          and report.unmapped_keys == classifier)
    print(f"{tag} synthetic X101 backbone ({os.path.getsize(path) / 2**20:.1f}"
          f" MB MXNet .params, seeded, from mapping_rows): under the yml's "
          f"FIXED_PARAMS {list(cfg.network.FIXED_PARAMS)} load_pretrained "
          f"raises on stage 1's unmapped sc_bn, as the JAX import does: "
          f"{'sc_bn' in raised}; under {relaxed.network.FIXED_PARAMS}: "
          f"{len(report.loaded)} tensors loaded, every one equal to the "
          f"file's {equal}, {len(report.missing)} kept at init, unused "
          f"{report.unmapped_keys}: {'PASS' if ok else 'FAIL'}")
    return ok


def zoo_training(dev, zcfg, cfg_file: str, tag: str, tmp: str, card: str,
                 per_step: dict) -> tuple[bool, dict]:
    """(z2)/(z4): the one-step check of phase 5 (a) on the model; for X101
    the synthetic backbone's import (x101_backbone), for MobileNetV2 none
    (network.pretrained empty: the JAX import maps no MobileNetV2 trunk
    weight); run_training at the yml's BATCH_IMAGES and chip size over
    phase 5's synthetic roidb without negative chips (no proposals are
    extracted for these models here), WARMUP_STEPS + ZOO_TIMED_STEPS steps,
    each step's launches exactly ``per_step``; MobileNetV2's first_conv
    bit for bit unmoved (FIXED_PARAMS) while its BatchNorm's running
    statistics move; then main_test's restore of the checkpoint and
    run_detection on two images. Returns (ok, run_training's launches)."""
    import copy

    from sniper_tpu_torch.config import config_name
    from sniper_tpu_torch.data.test_loader import (
        TestChipIterator,
        init_inference_crops,
    )
    from sniper_tpu_torch.main_test import (
        _scale_post_nms,
        make_forward,
        run_detection,
    )
    from sniper_tpu_torch.main_train import build_roidb, make_loader
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.ops import cuda
    from sniper_tpu_torch.train.checkpoint import restore_inference_state

    cfg = train_cfg(zcfg)
    cfg.TRAIN.USE_NEG_CHIPS = False
    cfg.output_path = os.path.join(tmp, "output")
    cfg.network.pretrained = ""
    ok1 = train_step_check(dev, cfg, f"{tag} (one step)")
    model = init_detector(get_model(cfg), seed=0)
    mnv2 = model.trunk_type == "mobilenetv2"
    ok_import = True if mnv2 else x101_backbone(cfg, model, tmp, tag)
    model.to(dev)
    stem = {k: v.detach().clone()
            for k, v in (model.trunk.first_conv.state_dict().items()
                         if mnv2 else ())}
    roidb = build_roidb(cfg, lambda m: print(f"{tag} {m}"),
                        datasets=[SynthTrainDataset()])
    out_dir = os.path.join(cfg.output_path, config_name(cfg_file),
                           cfg.dataset.image_set)
    print(f"{tag} {cfg_file} (symbol {cfg.symbol}): trunk {model.trunk_type}"
          f", BATCH_IMAGES {cfg.TRAIN.BATCH_IMAGES}, chips "
          f"{cfg.TRAIN.CHIP_SIZE}, FIXED_PARAMS "
          f"{list(cfg.network.FIXED_PARAMS)}, trunk dtype {model.dtype}, "
          f"{'seeded init' if mnv2 else 'the imported backbone'}")
    loader = make_loader(copy.deepcopy(roidb), cfg, 0,
                         image_loader=synth_train_image)
    idle = tuple(k for k, c in per_step.items() if c == 0)
    try:
        ok2, launches, _ = timed_training(
            dev, cfg, model, loader, card, tag, out_dir=out_dir,
            every_step=tuple(k for k, c in per_step.items() if c),
            idle=idle, per_step=per_step, timed_steps=ZOO_TIMED_STEPS)
    finally:
        loader.close()
    ckpt = os.path.join(out_dir, "checkpoints", "epoch_0001.pt")
    ok2 &= os.path.exists(ckpt)
    if mnv2:
        after = model.trunk.first_conv.state_dict()
        fixed = all(torch.equal(after[k], v) for k, v in stem.items()
                    if "running" not in k)
        moved = all(not torch.equal(after[k], v) for k, v in stem.items()
                    if "running" in k)
        ok2 &= fixed and moved
        print(f"{tag} trunk.first_conv (FIXED_PARAMS): parameters bit for "
              f"bit unmoved {fixed}, BatchNorm running statistics moved "
              f"{moved}")
    del model
    torch.cuda.empty_cache()

    tcfg = copy.deepcopy(cfg)
    tcfg.TEST.TEST_EPOCH = cfg.TRAIN.end_epoch
    model = get_model(tcfg)
    source = restore_inference_state(tcfg, model, config_name(cfg_file),
                                     lambda m: print(f"{tag} {m}"))
    model.to(dev).eval()
    roidb = [{"image": f"im{i}", "width": IM_W, "height": IM_H,
              "flipped": False} for i in range(2)]
    # as (m3): a class threshold under the restored model's scores
    init_inference_crops(roidb)
    batch = next(iter(TestChipIterator(roidb, tcfg, 0, 2,
                                       image_loader=synth_image)))
    out = make_forward(model, None, dev, tcfg.network.PIXEL_MEANS,
                       _scale_post_nms(tcfg, 0, model))(
        batch["data"], batch["im_info"])
    thresh = in_range_threshold(out, batch["im_info"],
                                tcfg.TEST.VALID_RANGES[0])
    with tempfile.TemporaryDirectory() as det_dir, class_threshold(thresh):
        stats = run_detection(tcfg, model, None, roidb, Detections(81),
                              det_dir, dev, image_loader=synth_image)
    ok3 = source == "checkpoint" and stats["detections"] > 0
    print(f"{tag} main_test's restore ({source}) of the checkpoint; "
          f"run_detection on 2 synthetic {IM_W}x{IM_H} images at class "
          f"threshold {thresh:.3e}: {stats}: {'PASS' if ok3 else 'FAIL'}")
    del model
    torch.cuda.empty_cache()
    print(f"{tag}: one-step check {'PASS' if ok1 else 'FAIL'}, backbone "
          f"{'PASS' if ok_import else 'FAIL'}, run_training "
          f"{'PASS' if ok2 else 'FAIL'}, restore and detection "
          f"{'PASS' if ok3 else 'FAIL'}")
    return ok1 and ok_import and ok2 and ok3, launches


def zoo_phase(dev, zcfgs: dict, card: str) -> tuple[bool, dict]:
    """(z1) X101 inference, (z2) X101 training, (z3) MobileNetV2 inference,
    (z4) MobileNetV2 training. Returns (ok, {path: launches})."""
    from sniper_tpu_torch.ops import cuda

    t0 = time.perf_counter()
    x1, x2, p4 = (cuda.DEFORM_IM2COL.name, cuda.DEFORM_IM2COL_BWD.name,
                  cuda.NMS.name)
    pool, pool_bwd, patch = (cuda.FUSED_POOL.name, cuda.POOL_BWD.name,
                             cuda.ROI_PATCH.name)
    epi = cuda.UNIT_EPILOGUE.name
    ok, paths = True, {}
    for name, cfg_file, dcn in (("x101", CONFIG, 3),
                                ("mobilenetv2", ZOO_CONFIG, 0)):
        zcfg = zcfgs[name]
        z = "(z1)" if dcn else "(z3)"
        good, paths[f"{name} inference"] = zoo_inference(
            dev, zcfg, f"zoo {z} {name}", card,
            {x1: dcn, p4: 1, pool: 2, x2: 0, pool_bwd: 0, patch: 0,
             epi: EPILOGUES_FORWARD if dcn else 0})
        ok &= good
        z = "(z2)" if dcn else "(z4)"
        with tempfile.TemporaryDirectory() as tmp:
            good, paths[f"{name} training"] = zoo_training(
                dev, zcfg, cfg_file, f"zoo {z} {name}", tmp, card,
                {x1: dcn, x2: dcn, p4: 1, pool: 2, pool_bwd: 2, patch: 0,
                 epi: 0})  # X101 trains its trunk with autograd throughout
        ok &= good
    print(f"zoo: (z1)-(z4) {'PASS' if ok else 'FAIL'} in "
          f"{time.perf_counter() - t0:.1f} s")
    return ok, paths


# ---------------------------------------------------------------------------
# phase 8: data parallelism
# ---------------------------------------------------------------------------

DP_CHIPS, DP_SIZE = 16, 512  # (d1)'s global batch: 8 chips per rank
DP_TIMED_STEPS = 6  # after WARMUP_STEPS, in each run of (d2)
DP_LOSSES = ("loss", "rpn_cls_loss", "rpn_bbox_loss", "rcnn_cls_loss",
             "rcnn_bbox_loss")
DP_LEAVES = ("conv_new_1.weight",) + HEAD_LEAVES + RPN_LEAVES + TRUNK_LEAVES
# one training step's launches of the flagship detector
STEP_LAUNCHES = {"deform_im2col": 3, "deform_im2col_bwd": 3, "nms": 1,
                 "fused_pool": 2, "fused_pool_bwd": 2, "roi_patch": 0,
                 "unit_epilogue": EPILOGUES_STEP}


@contextlib.contextmanager
def bn_noise(ulps: int, seed: int):
    """Multiply every training-mode BatchNorm's output by
    1 + ulps * 2^-23 * u, u uniform in [-1, 1) from a seeded generator on
    the card: the size of the rounding by which the global batch's
    statistics, all-reduced from the ranks' sums, differ from one process's
    (restored on exit). The random trunk amplifies that rounding far above
    pool_noise's spread, so (d1) bounds the sound step with both;
    scripts/dp_step_controls.py holds the sound step and each planted
    fault against either bound."""
    from sniper_tpu_torch.models import norm

    inner = norm.TrainBatchNorm.forward
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def noisy(self, x):
        y = inner(self, x)
        if not self.training:
            return y
        u = torch.rand(y.shape, generator=gen, device=y.device) * 2 - 1
        return y * (1 + ulps * 2.0 ** -23 * u).to(y.dtype)

    norm.TrainBatchNorm.forward = noisy
    try:
        yield
    finally:
        norm.TrainBatchNorm.forward = inner


# (d1)'s rank 1 keeps DP_RANK1_ANCHORS of each chip's sampled anchors, so
# that the ranks' RPN valid counts differ (8 x 256 against 8 x 64) and a
# loss normalized by a rank's own count is not the global one
DP_RANK1_ANCHORS = 64
# planted faults of (d1), for scripts/dp_step_controls.py: "local"
# BatchNorm in place of "sync"; each rank's own valid count ("count"); the
# world-size scale of the loss dropped ("scale"); both, which makes the
# step the mean of the ranks' own mean losses ("rank means")
DP_FAULTS = ("local", "count", "scale", "rank means")


def dp_batch(cfg, model):
    """(d1)'s 16 chips: step_batch's, with rank 1's chips (8-15) sampling
    DP_RANK1_ANCHORS anchors each (the rest padded -1)."""
    batch, pri = step_batch(cfg, model, DP_CHIPS, DP_SIZE)
    batch["rpn_pids"][DP_CHIPS // 2:, DP_RANK1_ANCHORS:] = -1
    return batch, pri


def bn_stats(model) -> dict:
    """Every training BatchNorm's running mean and variance, each kind
    concatenated over the layers (fp32, on the host)."""
    from sniper_tpu_torch.models.norm import TrainBatchNorm

    bns = [m for m in model.modules() if isinstance(m, TrainBatchNorm)]
    return {k: torch.cat([getattr(m, k).detach().float().cpu()
                          for m in bns])
            for k in ("running_mean", "running_var")}


def plant_fault(fault, cfg):
    """Put one of DP_FAULTS into this process's port (and ``cfg``)."""
    from sniper_tpu_torch.models import losses
    from sniper_tpu_torch.train import trainer

    if fault == "local":
        cfg.network.BN_MODE = "local"
    if fault in ("count", "rank means"):
        losses.global_count = trainer.global_count = lambda c: c
    if fault in ("scale", "rank means"):
        trainer.world_size = lambda: 1
    if fault is not None and fault not in DP_FAULTS:
        raise ValueError(f"unknown fault {fault!r}")


def dp_rank(rank, device, cfg, out_dir, fault=None):
    """(d1) one of two gloo ranks on the same card: the detector of ``cfg``
    from init_detector's seed 0, this rank's 8 of dp_batch's 16 chips and
    their rows of its priorities, one make_train_step step through DDP and
    the kernels, with the launch counters zeroed just before (``fault``,
    one of DP_FAULTS, planted first); saves the global metrics
    (reduce_metrics), the DP_LEAVES' gradients and values after the step,
    the BatchNorms' running statistics' update (bn_stats after less
    before), the launches and the rank's peak memory to
    <out_dir>/rank<rank>.pt."""
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.ops import cuda
    from sniper_tpu_torch.parallel.mesh import data_parallel
    from sniper_tpu_torch.train.optimizer import make_optimizer
    from sniper_tpu_torch.train.trainer import make_train_step, reduce_metrics

    plant_fault(fault, cfg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    model = init_detector(get_model(cfg), seed=0).to(device)
    batch, pri = dp_batch(cfg, model)
    b = DP_CHIPS // 2
    rows = slice(rank * b, (rank + 1) * b)
    batch = {k: v[rows].to(device) for k, v in batch.items()}
    pri = tuple(p[rows].to(device) for p in pri)
    opt, sched, _ = make_optimizer(cfg, 100, model)
    step = make_train_step(data_parallel(model, device), opt, sched,
                           DP_CHIPS, rpn_batch_size=cfg.TRAIN.RPN_BATCH_SIZE)
    before = bn_stats(model)
    torch.cuda.reset_peak_memory_stats(device)
    for k in cuda.KERNELS:
        k.launches = 0
    m = step(batch, priorities=pri)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in cuda.KERNELS}
    params = dict(model.named_parameters())
    torch.save({
        "metrics": {k: float(v) for k, v in reduce_metrics([m])[0].items()},
        "grads": {k: params[k].grad.float().cpu() for k in DP_LEAVES},
        "params": {k: params[k].detach().float().cpu() for k in DP_LEAVES},
        "stats": {k: v - before[k] for k, v in bn_stats(model).items()},
        "launches": launches,
        "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30},
        os.path.join(out_dir, f"rank{rank}.pt"))


def dp_ranks(dev, cfg, tmp: str, fault=None) -> tuple[list, float]:
    """(d1)'s two ranks (dp_rank) on ``dev``, fp32 trunk. Returns their
    saved results and the seconds the launch took."""
    import copy

    from sniper_tpu_torch.parallel import distributed

    cfg = copy.deepcopy(cfg)
    cfg.TRAIN.bf16 = False
    t0 = time.perf_counter()
    store = f"file://{tmp}/d1_store_{(fault or 'sound').replace(' ', '_')}"
    distributed.launch(dp_rank, [dev, dev], store, args=(cfg, tmp, fault),
                       timeout_s=600)
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)]
    return ranks, time.perf_counter() - t0


def dp_reference(dev, cfg, noise_bn: bool) -> dict:
    """The one-process step on (d1)'s 16 joined chips through the kernels,
    fp32 trunk: the DP_LOSSES, the DP_LEAVES' gradients and the BatchNorms'
    running statistics' update, then the same under NOISE_ULPS of noise on
    every pool pass (train_step_check's pool_noise) and, with
    ``noise_bn``, on every training BatchNorm's output (bn_noise), one run
    per seed of NOISE_DRAWS. Returns {"clean": ..., "noisy": [...],
    "peak_gib": the clean step's peak memory}."""
    import copy

    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.losses import total_loss
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.train.optimizer import is_fixed

    cfg = copy.deepcopy(cfg)
    cfg.TRAIN.bf16 = False
    model = init_detector(get_model(cfg), seed=0).to(dev).train()
    for name, p in model.named_parameters():
        p.requires_grad_(not is_fixed(name, cfg.network.FIXED_PARAMS))
    batch, pri = dp_batch(cfg, model)
    batch = {k: v.to(dev) for k, v in batch.items()}
    pri = tuple(p.to(dev) for p in pri)
    params = dict(model.named_parameters())
    init = copy.deepcopy({k: v for k, v in model.state_dict().items()
                          if "running_" in k})

    def one_step():
        model.load_state_dict(init, strict=False)
        before = bn_stats(model)
        model.zero_grad(set_to_none=True)
        out = model(batch["data"], batch["im_info"], batch["gt_boxes"],
                    batch["valid_ranges"], train=True, priorities=pri)
        _, m = total_loss(out, batch, DP_CHIPS, cfg.TRAIN.RPN_BATCH_SIZE)
        m["loss"].backward()
        torch.cuda.synchronize()
        return {"metrics": {k: float(m[k].detach()) for k in DP_LOSSES},
                "grads": {k: params[k].grad.float().cpu() for k in DP_LEAVES},
                "stats": {k: v - before[k]
                          for k, v in bn_stats(model).items()}}

    # TF32 off, as in dp_rank: a TF32 rounding of the convs' inputs turns
    # a few fp32 ulps into ~1e-3, which the random trunk amplifies
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        ref = {"clean": one_step(),
               "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
               "noisy": []}
        for seed in range(NOISE_DRAWS):
            with contextlib.ExitStack() as stack:
                stack.enter_context(pool_noise(NOISE_ULPS, seed))
                if noise_bn:
                    stack.enter_context(bn_noise(NOISE_ULPS, seed))
                ref["noisy"].append(one_step())
    finally:
        torch.backends.cudnn.deterministic = False
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    del model
    torch.cuda.empty_cache()
    return ref


def dp_compare(rank0: dict, ref: dict) -> tuple[bool, dict]:
    """A rank's step (dp_rank's file) against the one-process step
    (dp_reference): each reading, its noise spread (the largest of the
    noisy runs' distances from the clean one) and its tolerance, the larger
    of the fixed bound (STEP_LOSS_REL for the losses and the running
    statistics' update, HEAD_GRAD_REL or TRUNK_GRAD_REL for a gradient) and
    NOISE_MULT times the spread. Returns (all within, {name: (reading,
    spread, tolerance)})."""
    clean, noisy = ref["clean"], ref["noisy"]

    def loss_rel(m):
        return max(abs(m[k] - clean["metrics"][k])
                   / max(abs(clean["metrics"][k]), 1e-12) for k in DP_LOSSES)

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    rows = {"losses": (loss_rel(rank0["metrics"]),
                       max(loss_rel(n["metrics"]) for n in noisy),
                       STEP_LOSS_REL)}
    for k in DP_LEAVES:
        base = TRUNK_GRAD_REL if k.startswith(("trunk", "conv_new")) \
            else HEAD_GRAD_REL
        rows[k] = (rel(rank0["grads"][k], clean["grads"][k]),
                   max(rel(n["grads"][k], clean["grads"][k]) for n in noisy),
                   base)
    for k in ("running_mean", "running_var"):
        rows[f"BatchNorm {k} update"] = (
            rel(rank0["stats"][k], clean["stats"][k]),
            max(rel(n["stats"][k], clean["stats"][k]) for n in noisy),
            STEP_LOSS_REL)
    rows = {k: (e, spread, max(base, NOISE_MULT * spread))
            for k, (e, spread, base) in rows.items()}
    ok = all(math.isfinite(rank0["metrics"][k]) for k in DP_LOSSES)
    ok &= all(e <= tol for e, _, tol in rows.values())
    ok &= all(float(clean["grads"][k].norm()) > 0 for k in DP_LEAVES)
    return ok, rows


def dp_step_check(dev, cfg, tmp: str) -> tuple[bool, dict]:
    """(d1) one 2-rank step (dp_ranks: gloo, since NCCL refuses two ranks on
    one card; sync BatchNorm) against the one-process step on the 16
    joined chips with the same priorities (dp_reference), both through the
    kernels with an fp32 trunk (dp_compare's bounds, the noise on the pool
    passes and the training BatchNorms); the two ranks' gradients, updated
    leaves and running statistics identical; each rank's launches one
    step's. Returns (ok, the ranks' launches summed)."""
    ranks, t_ranks = dp_ranks(dev, cfg, tmp)
    ref = dp_reference(dev, cfg, noise_bn=True)
    r0, r1 = ranks
    ok, rows = dp_compare(r0, ref)
    parts = [f"{k} {e:.2e} (spread {spread:.2e}, tolerance {tol:.2e})"
             for k, (e, spread, tol) in rows.items()]
    same = all(torch.equal(r0[c][k], r1[c][k])
               for c in ("grads", "params", "stats") for k in r0[c])
    # an fp32 trunk: no unit epilogue engages
    want = dict(STEP_LAUNCHES, unit_epilogue=0)
    each = all(r["launches"] == want for r in ranks)
    ok &= same and each
    launches = {k: r0["launches"][k] + r1["launches"][k]
                for k in r0["launches"]}
    print(f"dp (d1) {DP_CHIPS} chips of {DP_SIZE}x{DP_SIZE}, fp32 trunk, "
          f"sync BatchNorm: one step on 2 gloo ranks of {DP_CHIPS // 2} "
          f"chips on the one card (DDP, {t_ranks:.1f} s with the ranks' "
          f"start-up; rank 1's chips sample {DP_RANK1_ANCHORS} anchors "
          f"each, rank 0's 256) against one process on the {DP_CHIPS} "
          f"joined chips, the same sampler priorities, both through the "
          f"kernels. Losses: ranks "
          f"{ {k: r0['metrics'][k] for k in DP_LOSSES} }, one process "
          f"{ref['clean']['metrics']}. Relative errors against one process "
          f"(losses: the largest; gradients after DDP's all-reduce and the "
          f"training BatchNorms' running-statistics update: L2), each "
          f"beside the one-process step's own spread under {NOISE_ULPS}-ulp "
          f"noise on every pool pass and training BatchNorm ({NOISE_DRAWS} "
          f"draws) and its tolerance, the larger of {STEP_LOSS_REL} (losses, "
          f"statistics), {HEAD_GRAD_REL} (heads) or {TRUNK_GRAD_REL} (trunk) "
          f"and {NOISE_MULT:g} x the spread: {'; '.join(parts)}. The two "
          f"ranks' gradients, updated leaves and statistics identical: "
          f"{same}. Peak memory per rank {r0['peak_gib']:.2f} / "
          f"{r1['peak_gib']:.2f} GiB, one process {ref['peak_gib']:.2f} GiB. "
          f"Launches per rank {r0['launches']} / {r1['launches']}, one "
          f"step's {want}: {each}: {'PASS' if ok else 'FAIL'}")
    return ok, launches


def dp_training(dev, cfg, tmp: str, card: str) -> tuple[bool, dict]:
    """(d2) main_train.run_training of the flagship recipe (bf16, 16 chips
    of 512x512 over SynthTrainDataset, no negative chips) for WARMUP_STEPS +
    DP_TIMED_STEPS steps, in one process and as the one rank of an NCCL
    group (DDP, the collectives of the metrics and the step count), in
    turns (one process, NCCL, NCCL, one process), every step's launches
    exactly one step's. Returns (ok, the first NCCL run's launches)."""
    import copy

    from sniper_tpu_torch.main_train import build_roidb, make_loader
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.parallel import distributed

    cfg = copy.deepcopy(cfg)
    cfg.TRAIN.USE_NEG_CHIPS = False
    roidb = build_roidb(cfg, lambda m: None, datasets=[SynthTrainDataset()])
    ok, meds, launches = True, {"one process": [], "NCCL": []}, None
    for i, run in enumerate(("one process", "NCCL", "NCCL", "one process")):
        model = init_detector(get_model(cfg), seed=0)
        loader = make_loader(copy.deepcopy(roidb), cfg, 0,
                             image_loader=synth_train_image)
        if run == "NCCL":
            distributed.init_group(f"file://{tmp}/d2_store{i}", 1, 0, dev,
                                   backend="nccl")
        try:
            good, got, med = timed_training(
                dev, cfg, model, loader, card, f"dp (d2) {run}",
                per_step=STEP_LAUNCHES, timed_steps=DP_TIMED_STEPS,
                eager="a process group" if run == "NCCL" else None)
            good &= distributed.is_distributed() == (run == "NCCL")
        finally:
            loader.close()
            if run == "NCCL":
                torch.distributed.destroy_process_group()
        ok &= good
        meds[run].append(med)
        if run == "NCCL" and launches is None:
            launches = got
        del model
        torch.cuda.empty_cache()
    print(f"dp (d2) run_training medians, ms per step of "
          f"{cfg.TRAIN.BATCH_IMAGES} chips, in turns: one process "
          f"{meds['one process'][0]:.1f} / {meds['one process'][1]:.1f}, "
          f"the one rank of an NCCL group (DDP) {meds['NCCL'][0]:.1f} / "
          f"{meds['NCCL'][1]:.1f} [{card}]; host clock, a smoke reading: "
          f"{'PASS' if ok else 'FAIL'}")
    return ok, launches


def dp_inference(dev, cfg) -> tuple[bool, dict]:
    """(d3) main_test.make_forward over two replicas on the one card, fp32
    trunk, 4 uint8 canvases of 256x320, each replica 2 of them: every
    output identical, bit for bit, to one replica's on the same two halves
    (the rois' batch index of the second half moved by 2), the batch-index
    column the image's index in the whole batch, the replicas' launches two
    batches'; then a batch of 3 raises ValueError. The one replica's
    forward over all 4 canvases is printed beside: cuDNN picks its
    algorithms per batch size, so it rounds otherwise, and a random RPN's
    proposals can move with that rounding. Returns (ok, the two replicas'
    launches)."""
    import copy

    from sniper_tpu_torch.main_test import make_forward
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.ops import cuda

    cfg = copy.deepcopy(cfg)
    cfg.TRAIN.bf16 = False
    model = init_detector(get_model(cfg), seed=0, offset_std=1e-3)
    g = torch.Generator().manual_seed(5)
    data = (torch.rand(4, 256, 320, 3, generator=g) * 255).to(torch.uint8)
    im_info = torch.tensor([[256.0, 320.0, 1.0]] * 4)
    means = cfg.network.PIXEL_MEANS
    torch.backends.cudnn.deterministic = True
    try:
        one_fwd = make_forward(model, None, dev, means)
        full = one_fwd(data, im_info)
        halves = [one_fwd(data[:2], im_info[:2]),
                  one_fwd(data[2:], im_info[2:])]
        two_fwd = make_forward(model, None, [dev, dev], means)
        for k in cuda.KERNELS:
            k.launches = 0
        two = two_fwd(data, im_info)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in cuda.KERNELS}
    finally:
        torch.backends.cudnn.deterministic = False
    shifted = halves[1]["rois"].clone()  # not an inference tensor
    shifted[..., 0] += 2
    halves[1] = dict(halves[1], rois=shifted)
    one = {k: torch.cat([h[k] for h in halves]) for k in halves[0]}
    identical = {k: torch.equal(one[k], two[k]) for k in one}
    want = {"deform_im2col": 6, "nms": 2, "fused_pool": 4,
            "deform_im2col_bwd": 0, "fused_pool_bwd": 0, "roi_patch": 0,
            "unit_epilogue": 0}  # an fp32 trunk: no unit epilogue engages
    idx = two["rois"][..., 0]
    global_idx = torch.equal(idx, torch.arange(4.0, device=idx.device)
                             [:, None].expand_as(idx))
    same_rois = int((full["rois"] == one["rois"]).all(-1).sum())
    errs = {k: f"{float((full[k] - one[k]).abs().amax()):.3g}"
            for k in ("roi_scores", "cls_prob", "bbox_pred")}
    try:
        two_fwd(data[:3], im_info[:3])
        refused = False
    except ValueError as e:
        refused = "not divisible" in str(e)
    ok = all(identical.values()) and global_idx and refused \
        and launches == want
    print(f"dp (d3) make_forward over 2 replicas on {dev}, fp32 trunk, 4 "
          f"canvases of 256x320: identical to one replica on the same two "
          f"halves {identical}, batch-index column global {global_idx}, "
          f"launches {launches} (two batches of 2: {want}), a batch of 3 "
          f"raises ValueError {refused}: {'PASS' if ok else 'FAIL'}. "
          f"Beside it, one replica on all 4 canvases against the same "
          f"replica on 2 + 2 (cuDNN's per-batch-size algorithms): "
          f"{same_rois} of {full['rois'].shape[0] * full['rois'].shape[1]} "
          f"rois identical, max abs differences {errs}")
    del model, one_fwd, two_fwd
    torch.cuda.empty_cache()
    return ok, launches


def dp_phase(dev, cfg, card: str) -> tuple[bool, dict]:
    """(d1) the 2-rank step, (d2) run_training in an NCCL group, (d3)
    inference over two replicas. Returns (ok, {path: launches})."""
    t0 = time.perf_counter()
    tcfg = train_cfg(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        ok1, l1 = dp_step_check(dev, tcfg, tmp)
        ok2, l2 = dp_training(dev, tcfg, tmp, card)
    ok3, l3 = dp_inference(dev, cfg)
    ok = ok1 and ok2 and ok3
    print(f"dp: (d1) {'PASS' if ok1 else 'FAIL'}, (d2) "
          f"{'PASS' if ok2 else 'FAIL'}, (d3) {'PASS' if ok3 else 'FAIL'} "
          f"in {time.perf_counter() - t0:.1f} s")
    return ok, {"dp training step (2 gloo ranks)": l1,
                "dp training (NCCL, world 1)": l2,
                "dp inference (2 replicas)": l3}


# ---------------------------------------------------------------------------
# phase 9: the remaining options
# ---------------------------------------------------------------------------

OPT_TIMED_STEPS = 5  # after WARMUP_STEPS, in (o1) and (o2)
VIS_STEPS, VIS_FREQ = 6, 2  # (o3): dumps after steps 2, 4 and 6
# one box-detector test forward's launches (a prediction dump, a demo scale)
FORWARD_LAUNCHES = {"deform_im2col": 3, "deform_im2col_bwd": 0, "nms": 1,
                    "fused_pool": 2, "fused_pool_bwd": 0, "roi_patch": 0,
                    "unit_epilogue": EPILOGUES_FORWARD}
# the JAX dumper's payload (sniper_tpu/train/vis_dump.py)
DUMP_KEYS = {"step", "batch_seq", "dets", "rois", "cls_prob", "bbox_pred"}
# the csrc kernels of a box test forward, by their __global__ names
TRACE_KERNELS = ("deform_im2col_kernel", "nms_mask_kernel",
                 "nms_scan_kernel", "pool_pass_kernel")


def launch_counts() -> dict:
    from sniper_tpu_torch.ops import cuda

    return {k.name: k.launches for k in cuda.KERNELS}


def options_cfg(cfg, tmp: str, prefix: str):
    """The yml's training settings of train_cfg, reading (r1)'s backbone
    and (r3)'s proposals, the run's output under ``tmp``."""
    cfg = train_cfg(cfg)
    cfg.output_path = os.path.join(tmp, "output")
    cfg.proposal_path = os.path.join(tmp, "proposals")
    cfg.network.pretrained = prefix
    return cfg


def options_model(cfg, log):
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.train.pretrained import load_pretrained

    model = init_detector(get_model(cfg), seed=0)
    load_pretrained(cfg, model, log)
    return model


def ohem_training(dev, cfg, tmp: str, prefix: str,
                  card: str) -> tuple[bool, dict]:
    """(o1) The flagship yml with TRAIN.ENABLE_OHEM: the one-step check of
    5 (a), then run_training from (r1)'s backbone with (r3)'s negative
    chips, every step's launches exact, and the rois each chip kept, read
    after every step (every one at least BATCH_ROIS_OHEM: the random RPN's
    saturated proposals give each chip more valid rois than that). Returns
    (ok, launches)."""
    from sniper_tpu_torch.main_train import build_roidb, make_loader
    from sniper_tpu_torch.models import losses

    ocfg = options_cfg(cfg, tmp, prefix)
    ocfg.TRAIN.ENABLE_OHEM = True
    k = ohem_rois(ocfg)
    ok1 = train_step_check(dev, ocfg, "options (o1)")

    def log(m):
        print(f"options (o1) {m}")

    roidb = build_roidb(ocfg, log, datasets=[SynthTrainDataset()])
    model = options_model(ocfg, log)
    kept: list = []  # each step's rois kept per chip
    last: list = []  # the last ohem_select's count, on the card
    inner = losses.ohem_select

    def counting(*args):
        labels, weights = inner(*args)
        # a replay runs no Python: it rewrites the count its capture made
        last[:] = [(labels >= 0).sum(1)]
        return labels, weights

    print(f"options (o1) {CONFIG} with TRAIN.ENABLE_OHEM True: "
          f"BATCH_ROIS_OHEM {k} of {model.num_rois} sampled rois per chip, "
          f"BATCH_IMAGES {ocfg.TRAIN.BATCH_IMAGES}, chips "
          f"{ocfg.TRAIN.CHIP_SIZE}, trunk dtype {model.dtype}")
    loader = make_loader(roidb, ocfg, 0, image_loader=synth_train_image)
    losses.ohem_select = counting
    try:
        ok2, launches, _ = timed_training(
            dev, ocfg, model, loader, card, "options (o1)",
            per_step=STEP_LAUNCHES, timed_steps=OPT_TIMED_STEPS,
            after_step=lambda: kept.append(last[0].clone()))
    finally:
        losses.ohem_select = inner
        loader.close()
    counts = sorted(int(c) for t in kept for c in t.tolist())
    good = (len(kept) == WARMUP_STEPS + OPT_TIMED_STEPS and counts
            and counts[0] >= k)
    print(f"options (o1) rois kept per chip over {len(counts)} chips: min "
          f"{counts[0] if counts else None}, median "
          f"{counts[len(counts) // 2] if counts else None}, max "
          f"{counts[-1] if counts else None} (at least {k}; ties at the "
          f"threshold all kept): {'PASS' if good else 'FAIL'}")
    del model
    torch.cuda.empty_cache()
    return ok1 and ok2 and good, launches


def mask_af_training(dev, amcfg, tmp: str, prefix: str,
                     card: str) -> tuple[bool, dict]:
    """(o2) configs/sniper_res101_e2e_mask_autofocus.yml's training: mask
    branch and FocusPixel head together from (r1)'s backbone with (r3)'s
    negative chips over the images with polygons, every step's launches
    exact (the pool 4, its backward 4), all six losses finite, mask_loss
    and focus_loss above 0 at the first step and moving. Returns (ok,
    launches)."""
    from sniper_tpu_torch.main_train import build_roidb, make_loader

    mcfg = options_cfg(amcfg, tmp, prefix)

    def log(m):
        print(f"options (o2) {m}")

    roidb = build_roidb(mcfg, log, datasets=[SynthMaskDataset()])
    model = options_model(mcfg, log)
    print(f"options (o2) {AF_MASK_CONFIG}: with_mask {model.with_mask}, "
          f"autofocus {model.with_autofocus}, {model.num_rois} sampled and "
          f"{model.num_mask_rois} mask rois per chip, BATCH_IMAGES "
          f"{mcfg.TRAIN.BATCH_IMAGES}, chips {mcfg.TRAIN.CHIP_SIZE}, trunk "
          f"dtype {model.dtype}")
    per_step = dict(STEP_LAUNCHES, fused_pool=4, fused_pool_bwd=4)
    loader = make_loader(roidb, mcfg, 0, image_loader=synth_train_image)
    try:
        ok, launches, _ = timed_training(
            dev, mcfg, model, loader, card, "options (o2)",
            per_step=per_step, varying=("mask_loss", "focus_loss"),
            positive_first=("mask_loss", "focus_loss"),
            timed_steps=OPT_TIMED_STEPS)
    finally:
        loader.close()
    del model
    torch.cuda.empty_cache()
    return ok, launches


def visualize_training(dev, cfg, tmp: str, prefix: str,
                       card: str) -> tuple[bool, dict]:
    """(o3) The flagship yml's run_training with TRAIN.VISUALIZE at
    visualization_freq VIS_FREQ over VIS_STEPS steps: the loader's chip
    renderings and the prediction dumps (pkl with the JAX payload's keys,
    jpg) read back; each dump's launches exactly one test forward's, and
    the run's host launches the eager steps' and the capture's plus the
    dumps'. Returns (ok, launches)."""
    import glob
    import pickle

    import cv2

    from sniper_tpu_torch.main_train import build_roidb, make_loader
    from sniper_tpu_torch.train import trainer, vis_dump

    vcfg = options_cfg(cfg, tmp, prefix)
    vcfg.TRAIN.VISUALIZE = True
    vcfg.TRAIN.visualization_freq = VIS_FREQ
    vcfg.TRAIN.visualization_path = os.path.join(tmp, "visualization")

    def log(m):
        print(f"options (o3) {m}")

    roidb = build_roidb(vcfg, log, datasets=[SynthTrainDataset()])
    model = options_model(vcfg, log)
    dumps: list = []
    inner = vis_dump.PredictionDumper.maybe_dump

    def timed_dump(self, host_batch, step, batch_seq=None):
        if step % self.freq:
            return inner(self, host_batch, step, batch_seq)
        torch.cuda.synchronize()
        before = launch_counts()
        t0 = time.perf_counter()
        path = inner(self, host_batch, step, batch_seq)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = launch_counts()
        dumps.append((step, path, ms,
                      {n: after[n] - before[n] for n in after}))
        return path

    loader = make_loader(roidb, vcfg, 0, image_loader=synth_train_image)
    vis_dump.PredictionDumper.maybe_dump = timed_dump
    try:
        ok, launches, _ = timed_training(
            dev, vcfg, model, loader, card, "options (o3)",
            timed_steps=VIS_STEPS - WARMUP_STEPS)
    finally:
        vis_dump.PredictionDumper.maybe_dump = inner
        loader.close()
    steps = [d[0] for d in dumps]
    each = all(d[3] == FORWARD_LAUNCHES for d in dumps)
    # the host launches the eager steps' and the capture's kernels, and
    # timed_training holds each replay's trace to theirs
    hosted = min(VIS_STEPS, trainer.GRAPH_WARMUP + 1)
    total = all(launches[n] == hosted * STEP_LAUNCHES[n]
                + len(dumps) * FORWARD_LAUNCHES[n] for n in launches)
    payloads_ok = True
    for _, path, _, _ in dumps:
        with open(path, "rb") as f:
            payload = pickle.load(f)
        payloads_ok &= (set(payload) == DUMP_KEYS
                        and len(payload["dets"]) == model.num_classes
                        and cv2.imread(path[:-4] + ".jpg") is not None)
    chips = sorted(glob.glob(os.path.join(vcfg.TRAIN.visualization_path,
                                          "chip_e1_s*.jpg")))
    chips_ok = bool(chips) and all(
        cv2.imread(c) is not None and cv2.imread(c).shape ==
        (vcfg.TRAIN.CHIP_SIZE, vcfg.TRAIN.CHIP_SIZE, 3) for c in chips)
    good = (steps == list(range(VIS_FREQ, VIS_STEPS + 1, VIS_FREQ)) and each
            and total and payloads_ok and chips_ok)
    ms = [round(d[2], 1) for d in dumps]
    print(f"options (o3) prediction dumps after steps {steps}: {ms} ms each "
          f"(host clock, synchronized, pkl and jpg written) [{card}]; "
          f"launches per dump {[d[3] for d in dumps]}, each one test "
          f"forward's {FORWARD_LAUNCHES}: {each}; the run's host launches "
          f"{hosted} steps' (the eager ones and the capture) plus "
          f"{len(dumps)} dumps': {total}; payloads "
          f"with the keys {sorted(DUMP_KEYS)} and their jpg read back "
          f"{payloads_ok}; {len(chips)} chip renderings "
          f"({os.path.basename(chips[0]) if chips else None} ...) read back "
          f"{chips_ok}: {'PASS' if good else 'FAIL'}")
    del model
    torch.cuda.empty_cache()
    return ok and good, launches


def demo_phase(dev, cfg, tmp: str, card: str) -> tuple[bool, dict]:
    """(o4) demo.detect on a synthetic 640x480 JPEG with the seeded weights
    saved as a training checkpoint and restored as the CLI restores them:
    per scale one batch-1 test forward's launches, the rendered image
    written, seconds per image; one detect under utils/profiler's
    device_trace, whose Chrome trace names the csrc kernels; and one pass
    of scale 0 through Tester.get_detections(per_chip_nms=True), equal to
    the NumPy soft-NMS of each chip's per-class detections of the same
    forward outputs without it. Returns (ok, the first detect's
    launches)."""
    import copy
    import glob

    import cv2

    from sniper_tpu_torch.config import config_name
    from sniper_tpu_torch.data.test_loader import (
        TestChipIterator,
        init_inference_crops,
    )
    from sniper_tpu_torch.demo import detect, render
    from sniper_tpu_torch.infer.tester import Tester
    from sniper_tpu_torch.main_test import make_forward
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.ops import cuda
    from sniper_tpu_torch.ops.nms import NMSWrapper
    from sniper_tpu_torch.train.checkpoint import (
        restore_inference_state,
        save_checkpoint,
    )
    from sniper_tpu_torch.utils.profiler import device_trace

    dcfg = copy.deepcopy(cfg)
    dcfg.output_path = os.path.join(tmp, "demo_output")
    name = config_name(CONFIG)
    seeded = init_detector(get_model(dcfg), seed=0)
    save_checkpoint(os.path.join(dcfg.output_path, name,
                                 str(dcfg.dataset.image_set), "checkpoints"),
                    int(dcfg.TEST.TEST_EPOCH), seeded)
    model = get_model(dcfg)
    source = restore_inference_state(dcfg, model, name,
                                     lambda m: print(f"options (o4) {m}"))
    state = seeded.state_dict()
    same = all(torch.equal(v, state[k]) for k, v in
               model.state_dict().items())
    del seeded
    model.to(dev).eval()
    im_path = os.path.join(tmp, "demo.jpg")
    cv2.imwrite(im_path, synth_image("im0"))
    n_scales = len(dcfg.TEST.SCALES)

    for k in cuda.KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    final = detect(dcfg, model, None, im_path, dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = launch_counts()
    want = {n: c * n_scales for n, c in FORWARD_LAUNCHES.items()}
    out = render(dcfg, cv2.imread(im_path), final,
                 os.path.join(tmp, "demo_out.jpg"))
    drawn = cv2.imread(out)
    n_det = sum(len(d) for d in final)
    good = (source == "checkpoint" and same and launches == want
            and len(final) == dcfg.dataset.NUM_CLASSES and n_det > 0
            and all(d.ndim == 2 and d.shape[1] == 5 and np.isfinite(d).all()
                    for d in final)
            and drawn is not None and drawn.shape == (IM_H, IM_W, 3))
    secs = []
    for _ in range(2):
        t0 = time.perf_counter()
        detect(dcfg, model, None, im_path, dev)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    print(f"options (o4) demo.detect on a synthetic {IM_W}x{IM_H} JPEG, "
          f"{n_scales} scales at batch 1, weights restored ({source}) from "
          f"the seeded model's checkpoint, equal to it {same}: {n_det} "
          f"detections, the image written {out}; {first_s:.3f} s for the "
          f"first image, then {', '.join(f'{v:.3f}' for v in secs)} s per "
          f"image (host clock, soft-NMS of a random detector's boxes on the "
          f"host included), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]; "
          f"launches {launches}, {n_scales} test forwards' {want}: "
          f"{'PASS' if good else 'FAIL'}")

    trace_dir = os.path.join(tmp, "trace")
    with device_trace(trace_dir) as prof:
        detect(dcfg, model, None, im_path, dev)
    files = glob.glob(os.path.join(trace_dir, "trace_*.json"))
    text = open(files[0]).read() if len(files) == 1 else ""
    named = {k: k in text for k in TRACE_KERNELS}
    device_ms = sum(e.device_time_total for e in prof.key_averages()
                    if not getattr(e, "is_user_annotation", False)) / 1e3
    trace_ok = len(files) == 1 and all(named.values())
    print(f"options (o4) detect under utils/profiler.device_trace: "
          f"{files[0] if files else None}, {len(text) / 2**20:.2f} MiB, the "
          f"csrc kernels named {named}, {device_ms:.1f} ms of device time "
          f"summed over its operators: {'PASS' if trace_ok else 'FAIL'}")

    roidb = [{"image": im_path, "width": IM_W, "height": IM_H,
              "flipped": False}]
    init_inference_crops(roidb)
    batch = next(iter(TestChipIterator(roidb, dcfg, 0, 1)))
    fwd_out = make_forward(model, None, dev, dcfg.network.PIXEL_MEANS)(
        batch["data"], batch["im_info"])
    ncls = dcfg.dataset.NUM_CLASSES
    plain, _, _ = Tester(lambda d, i: fwd_out, dcfg, ncls).get_detections(
        [batch], roidb)
    nmsd, _, _ = Tester(lambda d, i: fwd_out, dcfg, ncls).get_detections(
        [batch], roidb, per_chip_nms=True)
    wrapper = NMSWrapper(dcfg.TEST.NMS, dcfg.TEST.NMS_SIGMA)
    nms_ok, rows = True, [0, 0]
    for j in range(1, ncls):
        d = plain[j][0][0]
        ref = wrapper(d) if len(d) else d
        nms_ok &= np.array_equal(nmsd[j][0][0], ref)
        rows[0] += len(d)
        rows[1] += len(ref)
    print(f"options (o4) Tester.get_detections(per_chip_nms=True) at scale "
          f"0: {rows[1]} of {rows[0]} per-class rows kept, equal class by "
          f"class to the NumPy soft-NMS (TEST.NMS_SIGMA "
          f"{dcfg.TEST.NMS_SIGMA}) of the same forward's detections without "
          f"the flag: {'PASS' if nms_ok else 'FAIL'}")
    del model
    torch.cuda.empty_cache()
    return good and trace_ok and nms_ok, launches


def options_phase(dev, cfg, amcfg, tmp: str, prefix: str,
                  card: str) -> tuple[bool, dict]:
    """(o1) OHEM, (o2) mask and AutoFocus training together, (o3)
    TRAIN.VISUALIZE, (o4) the demo, the profiler and the per-chip NMS,
    each under a utils/profiler StageTimer stage. Returns (ok, {path:
    launches})."""
    from sniper_tpu_torch.utils.profiler import StageTimer

    timer = StageTimer()
    t0 = time.perf_counter()
    with timer.stage("(o1) OHEM training"):
        ok1, l1 = ohem_training(dev, cfg, tmp, prefix, card)
    with timer.stage("(o2) mask and AutoFocus training"):
        ok2, l2 = mask_af_training(dev, amcfg, tmp, prefix, card)
    with timer.stage("(o3) TRAIN.VISUALIZE training"):
        ok3, l3 = visualize_training(dev, cfg, tmp, prefix, card)
    with timer.stage("(o4) demo, trace and per-chip NMS"):
        ok4, l4 = demo_phase(dev, cfg, tmp, card)
    print("options StageTimer (host clock, set-up included):\n"
          + timer.report())
    print(f"options: (o1) {'PASS' if ok1 else 'FAIL'}, (o2) "
          f"{'PASS' if ok2 else 'FAIL'}, (o3) {'PASS' if ok3 else 'FAIL'}, "
          f"(o4) {'PASS' if ok4 else 'FAIL'} in "
          f"{time.perf_counter() - t0:.1f} s")
    return ok1 and ok2 and ok3 and ok4, {
        "ohem training": l1, "mask and autofocus training": l2,
        "visualize training (dumps included)": l3,
        "demo (3 scales at batch 1)": l4}


# ---------------------------------------------------------------------------
# phase 10: the bench
# ---------------------------------------------------------------------------

# the bench's FLOP counts at full width, tests/test_torch_bench.py's closed
# form: R101 per batch at the three test scales, and per training step
BENCH_FLOPS = (5663558615040, 3817093398528, 842816651264)
BENCH_STEP_FLOPS = 6723094642688
BENCH_KERNELS = ("nms", "deform_im2col", "fused_pool", "deform_im2col_bwd",
                 "fused_pool_bwd", "unit_epilogue")


def bench_phase(dev) -> tuple[bool, dict, dict]:
    """sniper_tpu_torch.bench's r101 run once (``bench.main``: the pyramid,
    the training step, the fed pipeline, AutoFocus), the counters zeroed
    just before and read just after. Holds that its line has every key of
    bench.py's, each MFU lies in (0, 1], the FLOP counts are BENCH_FLOPS
    and BENCH_STEP_FLOPS, and every kernel of the main path launched (the
    patch extraction not). Returns (ok, launches, the line)."""
    from sniper_tpu_torch import bench
    from sniper_tpu_torch.ops import cuda

    info = bench.card()
    peak = bench.resolve_peak(info["device"])
    for k in cuda.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    result, detail = bench.main("r101", device=dev, peak=peak)
    seconds = time.perf_counter() - t0
    launches = {k.name: k.launches for k in cuda.KERNELS}
    line = {**result, **info}
    missing = sorted(set(bench.R101_KEYS) - set(result))
    mfus = {"train_mfu": result["train_mfu"],
            "pipeline_mfu": detail["pipeline_mfu"],
            **{f"scale {s} mfu": sc["mfu"]
               for s, sc in enumerate(detail["per_scale"])}}
    flops = tuple(sc["flops"] for sc in detail["per_scale"])
    ok = (not missing and all(0 < m <= 1 for m in mfus.values())
          and flops == BENCH_FLOPS
          and result["train_step_tflops"] == BENCH_STEP_FLOPS / 1e12
          and all(launches[n] > 0 for n in BENCH_KERNELS)
          and launches[cuda.ROI_PATCH.name] == 0)
    print(f"bench: python -m sniper_tpu_torch.bench's r101 sections in "
          f"{seconds:.1f} s; per scale {detail['per_scale']}; round ms "
          f"{[round(r, 2) for r in detail['round_ms']]}; MFU {mfus} against "
          f"{peak:.4g} FLOP/s; FLOP counts per batch {flops} (want "
          f"{BENCH_FLOPS}), per step {result['train_step_tflops']} T (want "
          f"{BENCH_STEP_FLOPS / 1e12}); missing keys {missing}; launches "
          f"{launches}: {'PASS' if ok else 'FAIL'}")
    return ok, launches, line


# ---------------------------------------------------------------------------
# phase 11: box inference under network.POOL_KERNEL pallas
# ---------------------------------------------------------------------------

PALLAS_ATOL = 1e-3  # cls_prob and bbox_pred, pallas route vs fused route
PALLAS_REPS = 3  # timed passes of each scale's batches per route in (c)


class LaunchesPerCall:
    """The kernels' launches in each forward of ``model``, read from the
    counters before and after the call (forward hooks): ``calls`` holds
    ((B, rois per image), {kernel name: launches}) per call."""

    def __init__(self, model):
        from sniper_tpu_torch.ops import cuda

        self.kernels = cuda.KERNELS
        self.calls: list = []
        self.before: dict = {}
        self.hooks = (model.register_forward_pre_hook(self.pre),
                      model.register_forward_hook(self.post))

    def counts(self) -> dict:
        return {k.name: k.launches for k in self.kernels}

    def pre(self, module, args):
        self.before = self.counts()

    def post(self, module, args, out):
        now = self.counts()
        self.calls.append((tuple(out["rois"].shape[:2]),
                           {n: now[n] - self.before[n] for n in now}))

    def remove(self):
        for h in self.hooks:
            h.remove()


def pallas_launches(B: int, rpi: int) -> dict:
    """One box-inference batch's launches under POOL_KERNEL pallas: the
    patch extraction once per PATCH_ROI_CHUNK rois, the im2col of C5's three
    deformable convs, NMS once, the trunk's unit epilogues, no fused pool
    and no backward."""
    from sniper_tpu_torch.ops import deform

    return {"roi_patch": math.ceil(B * rpi / deform.PATCH_ROI_CHUNK),
            "deform_im2col": 3, "nms": 1, "fused_pool": 0,
            "deform_im2col_bwd": 0, "fused_pool_bwd": 0,
            "unit_epilogue": EPILOGUES_FORWARD}


def patch_route_kernels(fn) -> dict:
    """Device ms by kernel name of one call of ``fn`` (torch.profiler)."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] += e.time_range.elapsed_us() / 1e3
    return by_kernel


def pallas_phase(dev, card: str) -> tuple[bool, dict]:
    """R101 box inference of configs/sniper_res101_e2e.yml with ``--set
    network.POOL_KERNEL pallas``: the R-CNN head's pool on the patch route
    (P5, then torch ops). Phase 3's seeded weights, images and shapes. (a)
    one batch per scale against the same weights on the fused route (P1/P2)
    through make_forward: rois bit for bit, cls_prob and bbox_pred within
    PALLAS_ATOL, each batch's launches exactly ``pallas_launches``; (b)
    run_detection with the counters zeroed just before and read just
    after, every batch's launches exact; (c) per scale, ms per batch of
    the whole forward on each route (host clock, median of PALLAS_REPS
    passes, in turns) and of the pool alone on batch 0's roi map and rois
    (CUDA events) beside the pallas pool's device busy time and P5's share
    of it (torch.profiler), with scale 0's pool by kernel, and the pallas
    route's peak memory. Returns (ok, (b)'s launches)."""
    from sniper_tpu_torch.config import load_config
    from sniper_tpu_torch.data.test_loader import (
        TestChipIterator,
        init_inference_crops,
    )
    from sniper_tpu_torch.infer.tester import device_normalize
    from sniper_tpu_torch.main_test import (
        _scale_post_nms,
        make_forward,
        run_detection,
    )
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.ops import cuda, deform

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, CONFIG))
    pcfg = load_config(os.path.join(root, CONFIG),
                       overrides=["network.POOL_KERNEL", "pallas"])
    model = init_detector(get_model(pcfg), seed=0, offset_std=1e-3)
    fused = get_model(cfg)
    fused.load_state_dict(model.state_dict())
    model.to(dev).eval()
    fused.to(dev).eval()
    means = pcfg.network.PIXEL_MEANS
    print(f"pallas: {CONFIG} --set network.POOL_KERNEL pallas: the head's "
          f"inference pool on route {model.pool_kernel!r} against "
          f"{fused.pool_kernel!r} on the same weights (phase 3's: seed 0, "
          f"offsets normal(1e-3)); PATCH_ROI_CHUNK "
          f"{deform.PATCH_ROI_CHUNK}, patch and pool in fp32 on both routes "
          f"(the JAX pallas branch extracts in bf16 on an accelerator); "
          f"tolerance {PALLAS_ATOL} absolute on cls_prob and bbox_pred, "
          f"rois bit for bit (the pool comes after the RPN and NMS)")
    rec = LaunchesPerCall(model)
    ok = True

    def exact(calls) -> bool:
        return bool(calls) and all(c == pallas_launches(*shape)
                                   for shape, c in calls)

    # (a) one batch per scale, pallas route against fused route
    roidb = [{"image": f"im{i}", "width": IM_W, "height": IM_H,
              "flipped": False} for i in range(N_IMAGES)]
    init_inference_crops(roidb)
    scales = []
    for s in range(len(pcfg.TEST.SCALES)):
        bs = pcfg.TEST.BATCH_IMAGES[s]
        n = _scale_post_nms(pcfg, s, model)
        batches = list(TestChipIterator(roidb, pcfg, s, bs,
                                        image_loader=synth_image))
        fwd_p = make_forward(model, None, dev, means, n)
        fwd_f = make_forward(fused, None, dev, means, n)
        b0 = batches[0]
        rec.calls = []
        torch.backends.cudnn.deterministic = True
        out_f = fwd_f(b0["data"], b0["im_info"])
        out_p = fwd_p(b0["data"], b0["im_info"])
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = False
        same = torch.equal(out_p["rois"], out_f["rois"])
        err = float((out_p["cls_prob"] - out_f["cls_prob"]).abs().max())
        berr = float((out_p["bbox_pred"] - out_f["bbox_pred"]).abs().max())
        finite = all(bool(torch.isfinite(out_p[k]).all())
                     for k in ("rois", "cls_prob", "bbox_pred"))
        good = (same and err <= PALLAS_ATOL and berr <= PALLAS_ATOL
                and finite and exact(rec.calls)
                and tuple(out_p["cls_prob"].shape) == (bs, n, 81))
        print(f"pallas (a) scale {s}: batch {bs}, {n} rois/img: rois "
              f"identical {same}, cls_prob max abs err {err:.3e}, bbox_pred "
              f"max abs err {berr:.3e} (tolerance {PALLAS_ATOL}), finite "
              f"{finite}; launches {rec.calls[-1][1] if rec.calls else None}"
              f" (want {pallas_launches(bs, n)}): "
              f"{'PASS' if good else 'FAIL'}")
        ok &= good
        scales.append((s, bs, n, batches, fwd_p, fwd_f, out_p))

    # (b) the main path: run_detection under POOL_KERNEL pallas
    roidb = [{"image": f"im{i}", "width": IM_W, "height": IM_H,
              "flipped": False} for i in range(N_IMAGES)]
    for k in cuda.KERNELS:
        k.launches = 0
    rec.calls = []
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        stats = run_detection(pcfg, model, None, roidb, Detections(81),
                              out_dir, dev, image_loader=synth_image)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in cuda.KERNELS}
    per_batch = [(shape, c["roi_patch"]) for shape, c in rec.calls]
    good = stats["detections"] > 0 and exact(rec.calls)
    print(f"pallas (b) run_detection over {N_IMAGES} synthetic {IM_W}x{IM_H} "
          f"images: {stats}, launches {launches}; per batch ((B, rois/img), "
          f"roi_patch launches) {per_batch}, every batch exactly "
          f"pallas_launches: {exact(rec.calls)}; {wall:.2f} s wall "
          f"including first-call set-up: {'PASS' if good else 'FAIL'}")
    ok &= good
    rec.remove()

    # (c) per-scale times of the two routes, in turns
    head = model.rcnn
    for s, bs, n, batches, fwd_p, fwd_f, out_p in scales:
        reps = {"fused": [], "pallas": []}
        for r in range(PALLAS_REPS):
            order = (("fused", fwd_f), ("pallas", fwd_p))
            for name, fwd in order if r % 2 == 0 else order[::-1]:
                t0 = time.perf_counter()
                for b in batches:
                    fwd(b["data"], b["im_info"])
                torch.cuda.synchronize()
                reps[name].append((time.perf_counter() - t0) * 1e3
                                  / len(batches))
        med = {k: sorted(v)[len(v) // 2] for k, v in reps.items()}
        b0 = batches[0]
        info0 = torch.as_tensor(b0["im_info"], dtype=torch.float32).to(dev)
        x0 = device_normalize(torch.as_tensor(b0["data"]).to(dev), info0,
                              means)
        kw = dict(rois_per_image=n, pooled_size=head.pooled_size,
                  spatial_scale=head.spatial_scale, trans_std=head.trans_std,
                  margin_bins=head.margin_bins)
        with torch.inference_mode():
            fmap = model._roi_feat_map(model._shared(x0)[0])
            rois = out_p["rois"].reshape(-1, 5)
            pool_ms = {name: time_ms(lambda pool=pool: pool(
                fmap, rois, head.offset.weight, head.offset.bias, **kw), 3)
                for name, pool in (("pallas", deform.patch_offset_pool),
                                   ("fused", deform.fused_offset_pool))}
            torch.cuda.reset_peak_memory_stats()
            fwd_p(b0["data"], b0["im_info"])
            torch.cuda.synchronize()
            by_kernel = patch_route_kernels(
                lambda: deform.patch_offset_pool(
                    fmap, rois, head.offset.weight, head.offset.bias, **kw))
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy = sum(by_kernel.values())
        p5 = sum(ms for name, ms in by_kernel.items()
                 if "roi_patch" in name)
        print(f"pallas (c) scale {s}: batch {bs}, {n} rois/img, map "
              f"{tuple(fmap.shape[1:3])}: forward median {med['pallas']:.2f}"
              f" ms/batch on the pallas route vs {med['fused']:.2f} on the "
              f"fused route ({PALLAS_REPS} passes of {len(batches)} batches "
              f"each, in turns; host clock); the pool alone "
              f"{pool_ms['pallas']:.3f} ms vs {pool_ms['fused']:.3f} ms "
              f"(CUDA events, batch 0's roi map and rois), the pallas pool's "
              f"device busy {busy:.3f} ms of it, P5 {p5:.3f} ms "
              f"(torch.profiler, one call); pallas forward peak memory "
              f"{peak:.2f} GiB [{card}]")
        if s == 0:
            print(f"pallas (c) scale 0: the patch-route pool's device time "
                  f"by kernel (torch.profiler, one call): busy {busy:.3f} ms;"
                  + "".join(f" {ms:.3f} ms ({ms / busy:.0%}) {name[:70]};"
                            for name, ms in by_kernel.most_common(6)))
        del fmap, rois, x0
    del model, fused, scales
    torch.cuda.empty_cache()
    return ok, launches


def dir_mib(path: str) -> float:
    """The size of the files under ``path``, in MiB."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files) / 2**20


def train_phase(dev, cfg, mcfg, acfg, tmp: str,
                card: str) -> tuple[bool, dict, str]:
    """(a) the full detector's one-step check, then the recipe (r1)-(r4),
    then the mask yml's training (m1)-(m3) and the AutoFocus yml's
    (t1)-(t3) from (r1)'s backbone and (r3)'s proposals, all under ``tmp``,
    which keeps the backbone and the proposals for phase 9. Returns (ok,
    {path: launches}, the backbone's network.pretrained prefix)."""
    from sniper_tpu_torch.main_train import build_roidb

    cfg = train_cfg(cfg)
    ok = train_step_check(dev, cfg, "train (a)")
    ok &= graph_steps(dev, cfg, card)
    ds = SynthTrainDataset()
    rcfg, cfg = recipe_cfgs(cfg, tmp)
    ok_r1, prefix = pretrained_import(rcfg, tmp)
    cfg.network.pretrained = prefix
    rpn_roidb = build_roidb(rcfg, lambda m: print(f"recipe (r2) {m}"),
                            datasets=[ds])
    ok_r2, l_rpn = rpn_training(dev, rcfg, rpn_roidb, card)
    ok_r3, l_ext = proposal_extraction(dev, rcfg, ds, card)
    # a run's checkpoint (model and optimizer) is read only by the phase
    # right after it: drop it there, so that the temporary directory
    # holds one at a time beside the backbone and the proposals
    sizes = [dir_mib(tmp)]
    shutil.rmtree(cfg.output_path, ignore_errors=True)
    ok_r4, l_rec, l_proc = recipe_training(dev, cfg, ds, card)
    ok_m, l_mask = mask_training(dev, mcfg, tmp, prefix, card)
    sizes.append(dir_mib(tmp))
    shutil.rmtree(cfg.output_path, ignore_errors=True)
    ok_af, l_af = autofocus_training(dev, acfg, tmp, prefix, card)
    sizes.append(dir_mib(tmp))
    shutil.rmtree(cfg.output_path, ignore_errors=True)
    print(f"training's temporary directory (backbone, proposals, the last "
          f"run's checkpoint): {sizes[0]:.0f} MiB after (r3), {sizes[1]:.0f} "
          f"after (m3), {sizes[2]:.0f} after (t3)")
    print(f"recipe: (r1) {'PASS' if ok_r1 else 'FAIL'}, (r2) "
          f"{'PASS' if ok_r2 else 'FAIL'}, (r3) {'PASS' if ok_r3 else 'FAIL'}"
          f", (r4) {'PASS' if ok_r4 else 'FAIL'}; mask training "
          f"{'PASS' if ok_m else 'FAIL'}; autofocus training "
          f"{'PASS' if ok_af else 'FAIL'}")
    return ok and ok_r1 and ok_r2 and ok_r3 and ok_r4 and ok_m and ok_af, {
        "rpn training": l_rpn, "proposal extraction": l_ext,
        "training (recipe)": l_rec,
        "training (recipe, loader process)": l_proc,
        "mask training": l_mask, "autofocus training": l_af}, prefix


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False); this test "
                         "runs only on the card")
    from sniper_tpu_torch.config import load_config

    dev = torch.device("cuda", 0)
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, CONFIG))
    mcfg = load_config(os.path.join(root, MASK_CONFIG))
    acfg = load_config(os.path.join(root, AF_CONFIG))
    amcfg = load_config(os.path.join(root, AF_MASK_CONFIG))
    zcfgs = zoo_cfgs(root)
    card = environment()
    ok_k, results = kernel_phase(dev, cfg, mcfg, acfg, zcfgs["mobilenetv2"])
    torch.cuda.synchronize()
    ok_e, launches_infer = e2e_phase(dev, cfg, card)
    torch.cuda.synchronize()
    ok_m, launches_mask = mask_phase(dev, mcfg, card)
    torch.cuda.synchronize()
    ok_a, launches_af = autofocus_inference(dev, acfg, amcfg, card)
    torch.cuda.synchronize()
    # the recipe's backbone and proposals live here through phase 9
    with tempfile.TemporaryDirectory() as tmp:
        ok_t, launches_train, prefix = train_phase(dev, cfg, mcfg, acfg, tmp,
                                                   card)
        torch.cuda.synchronize()
        ok_z, launches_zoo = zoo_phase(dev, zcfgs, card)
        torch.cuda.synchronize()
        ok_d, launches_dp = dp_phase(dev, cfg, card)
        torch.cuda.synchronize()
        ok_o, launches_opt = options_phase(dev, cfg, amcfg, tmp, prefix,
                                           card)
        torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ok_b, launches_bench, bench_line = bench_phase(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ok_p, launches_pallas = pallas_phase(dev, card)

    # "launches": the mask-branch inference run for the kernels it runs;
    # phase 11's box inference under POOL_KERNEL pallas for the patch
    # extraction, the one path that runs it; the recipe's phase 3 (thread
    # loader) for the two backward kernels, which only training runs. Every
    # path's counts stand beside, the mask training's among them. All are
    # the kernels' counters, the host's launches: a training path's count
    # its eager steps and its CUDA graph's capture, not its replays, whose
    # traces timed_training holds to an eager step's.
    def main_path(name):
        if name == "roi_patch":
            return "inference (pallas)"
        return ("mask inference" if name in INFERENCE_KERNELS
                else "training (recipe)")

    by_path = {"inference": launches_infer, "mask inference": launches_mask,
               "autofocus inference": launches_af, **launches_train,
               **launches_zoo, **launches_dp, **launches_opt,
               "bench (r101 sections)": launches_bench,
               "inference (pallas)": launches_pallas}
    kernels = [{
        "name": r["kernel"].name, "route": "cuda",
        "source": r["kernel"].source, "replaces": r["kernel"].replaces,
        "launches": by_path[main_path(r["kernel"].name)][r["kernel"].name],
        "launches_path": main_path(r["kernel"].name),
        "launches_by_path": {p: c.get(r["kernel"].name, 0)
                             for p, c in by_path.items()},
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
    } for r in results]
    if not (ok_k and ok_e and ok_m and ok_a and ok_t and ok_z and ok_d
            and ok_o and ok_b and ok_p):
        print(f"chip_smoke: FAILED (kernels {ok_k}, inference {ok_e}, "
              f"mask inference {ok_m}, autofocus inference {ok_a}, training, "
              f"the recipe and autofocus training {ok_t}, the model zoo "
              f"{ok_z}, data parallelism {ok_d}, the remaining options "
              f"{ok_o}, the bench {ok_b}, the pallas route {ok_p})")
        return 1
    print(json.dumps(bench_line))
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
