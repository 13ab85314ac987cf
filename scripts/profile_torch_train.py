#!/usr/bin/env python3
"""Where the time goes in one training step of the port.

Runs sniper_tpu_torch's R101 detector (``--cfg``, by default
configs/sniper_res101_e2e.yml, at full width, seeded random weights with the
flax init's zero offsets) through make_train_step on a synthetic batch that
already lies on the device: BATCH_IMAGES uint8 chips of CHIP_SIZE with GT
boxes and sparse RPN targets, and with the mask config (TRAIN.WITH_MASK)
each GT's dense mask rasterized from the ellipse inscribed in its box.
After warm-up steps it profiles a few eager steps (a no-op forward hook
keeps the step eager: train/trainer.py) with torch.profiler and prints the
host-clock time per step, the device-busy time (sum of kernel times) and
its share, the device time by kernel group (the five hand-written kernels,
convolutions, GEMMs, BatchNorm, the optimizer, the rest), then the top
kernels. Then, the hook removed, the step captures its CUDA graph and
replays it: the script profiles as many replayed steps and prints their
time per step, device-busy time, the host ms inside one replayed step's
call with the card drained before it, and the share of the steps taken
that replayed (``eager_reason`` None). The layer spans' split comes from
the eager steps: a replay opens the one span ``graph``. The chip loader is
left out: it runs on the host, in its own
threads. With TRAIN.AUTO_FOCUS the batch also carries seeded FocusPixel
labels; with TRAIN.ENABLE_OHEM (``--set TRAIN.ENABLE_OHEM True``) the step
trains on the BATCH_ROIS_OHEM hardest rois per chip. Needs one CUDA
device.

    python3 scripts/profile_torch_train.py [--steps 3] [--warmup 2] [--cfg configs/sniper_res101_e2e_mask.yml] [--set KEY VALUE ...]

TF32 stays at torch's defaults, as main_train runs.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GROUPS = (
    ("kernel:fused_pool_bwd", ("pool_pass_bwd_kernel",)),
    ("kernel:deform_im2col_bwd", ("deform_im2col_bwd_kernel",)),
    ("kernel:fused_pool", ("pool_pass_kernel",)),
    ("kernel:deform_im2col", ("deform_im2col_kernel",)),
    ("kernel:nms", ("nms_mask_kernel", "nms_scan_kernel")),
    ("BatchNorm", ("batch_norm", "batchnorm", "bn_")),
    ("conv (cuDNN)", ("conv", "cudnn", "implicit", "xmma", "fprop", "dgrad",
                      "wgrad")),
    ("gemm (cuBLAS)", ("gemm", "cutlass", "sm90_")),
    ("optimizer (SGD)", ("multi_tensor", "foreach")),
    ("sort/topk", ("sort", "Sort", "radix", "topk")),
)


def group_of(name: str) -> str:
    for g, keys in GROUPS:
        if any(k in name for k in keys):
            return g
    return "other (elementwise, reductions, copies)"


def synthetic_batch(cfg, dev, gen):
    B, S = cfg.TRAIN.BATCH_IMAGES, cfg.TRAIN.CHIP_SIZE
    A, fh = cfg.network.NUM_ANCHORS, S // cfg.network.RPN_FEAT_STRIDE
    G = cfg.TRAIN.MAX_GT_BOXES
    gt = torch.full((B, G, 5), -1.0)
    n = 12
    xy = torch.rand(B, n, 2, generator=gen) * (S - 100)
    wh = 12 + torch.rand(B, n, 2, generator=gen) * 200
    gt[:, :n, :2] = xy
    gt[:, :n, 2:4] = (xy + wh).clamp_max(S - 1)
    gt[:, :n, 4] = torch.randint(1, cfg.dataset.NUM_CLASSES, (B, n),
                                 generator=gen).float()
    pids = torch.stack([torch.randperm(A * fh * fh, generator=gen)[:256]
                        for _ in range(B)])
    batch = {
        "data": torch.randint(0, 255, (B, S, S, 3), generator=gen,
                              dtype=torch.uint8),
        "data_extent": torch.full((B, 2), float(S)),
        "im_info": torch.tensor([[S, S, 1.0]] * B),
        "gt_boxes": gt, "valid_ranges": torch.tensor([[0.0, 1e5]] * B),
        "rpn_pids": pids.int(),
        "rpn_label_vals": (torch.rand(B, 256, generator=gen) < 0.25).float(),
        "fg_pids": pids[:, :64].int(),
        "fg_targets": torch.randn(B, 64, 4, generator=gen) * 0.2,
    }
    if cfg.TRAIN.WITH_MASK:
        import numpy as np

        from sniper_tpu_torch.data.mask_utils import rasterize_gt_masks

        t = np.arange(24) * (2 * np.pi / 24)

        def ellipse(b):
            return np.stack([(b[0] + b[2]) / 2 + (b[2] - b[0]) / 2 * np.cos(t),
                             (b[1] + b[3]) / 2 + (b[3] - b[1]) / 2 * np.sin(t)],
                            1).reshape(-1)

        batch["gt_masks"] = torch.from_numpy(np.stack([rasterize_gt_masks(
            [[ellipse(b)] if b[4] >= 0 else [] for b in rows], rows[:, :4],
            grid=112, max_n_gts=G) for rows in gt.numpy()]))
    if cfg.TRAIN.AUTO_FOCUS:
        batch["scale_label"] = (torch.randint(0, 3, (B, fh * fh),
                                              generator=gen) - 1).float()
    return {k: v.to(dev) for k, v in batch.items()}


def profiled(step, batch, n):
    """``n`` steps under torch.profiler: (host ms per step to a
    synchronise, {kernel: device ms per step}, {group: launches per
    step})."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    per_kernel = collections.Counter()
    launches = collections.Counter()
    for e in prof.events():
        # a user range (a program span) spans kernels: not one itself
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            per_kernel[e.name] += e.time_range.elapsed_us() / 1e3 / n
            launches[group_of(e.name)] += 1 / n
    return wall, per_kernel, launches


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--cfg", default="configs/sniper_res101_e2e.yml")
    p.add_argument("--set", dest="overrides", nargs="*", default=[],
                   help="config overrides: key value ...")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs a CUDA device")

    from sniper_tpu_torch.config import load_config
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.train import trainer
    from sniper_tpu_torch.train.optimizer import make_optimizer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    cfg = load_config(os.path.join(ROOT, args.cfg), args.overrides)
    ohem = int(cfg.TRAIN.BATCH_ROIS_OHEM) if cfg.TRAIN.ENABLE_OHEM else 0
    print(f"{args.cfg} {' '.join(args.overrides)}: symbol {cfg.symbol}, "
          f"TRAIN.WITH_MASK {bool(cfg.TRAIN.WITH_MASK)}, TRAIN.AUTO_FOCUS "
          f"{bool(cfg.TRAIN.AUTO_FOCUS)}, OHEM rois {ohem}, cuDNN TF32 "
          f"{torch.backends.cudnn.allow_tf32}")
    model = init_detector(get_model(cfg), seed=0).to(dev)
    opt, sched, _ = make_optimizer(cfg, 1000, model)
    step = trainer.make_train_step(
        model, opt, sched, cfg.TRAIN.BATCH_IMAGES,
        rpn_batch_size=cfg.TRAIN.RPN_BATCH_SIZE,
        pixel_means=cfg.network.PIXEL_MEANS,
        generator=torch.Generator(device=dev).manual_seed(0),
        ohem_rois=ohem)
    batch = synthetic_batch(cfg, dev, torch.Generator().manual_seed(0))
    replayed = []  # per step taken: whether it replayed

    def counted(b):
        m = step(b)
        replayed.append(step.eager_reason is None)
        return m

    hook = model.register_forward_hook(lambda *a: None)  # keeps it eager
    for _ in range(max(args.warmup, trainer.GRAPH_WARMUP - args.steps)):
        counted(batch)
    wall, per_kernel, launches = profiled(counted, batch, args.steps)
    hook.remove()
    for _ in range(2):  # the capture, then one replay
        counted(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counted(batch)
    host_ms = (time.perf_counter() - t0) * 1e3
    r_wall, r_kernel, _ = profiled(counted, batch, args.steps)
    busy = sum(per_kernel.values())
    groups = collections.Counter()
    for name, ms in per_kernel.items():
        groups[group_of(name)] += ms
    print(f"eager train step: {cfg.TRAIN.BATCH_IMAGES} chips of "
          f"{cfg.TRAIN.CHIP_SIZE}x{cfg.TRAIN.CHIP_SIZE}: {wall:.2f} ms/step "
          f"(host clock, profiler on), device busy {busy:.2f} ms "
          f"({busy / wall:.0%}), idle {max(0.0, 1 - busy / wall):.0%} "
          f"[{card}]")
    for g, ms in groups.most_common():
        print(f"  {g:40s} {ms:9.3f} ms  {ms / busy:6.1%}  "
              f"{launches[g]:5.0f} launches")
    for name, ms in per_kernel.most_common(12):
        print(f"    {ms:9.3f} ms  {name[:100]}")
    r_busy = sum(r_kernel.values())
    print(f"replayed steps: {sum(replayed)} of the {len(replayed)} taken; "
          f"a replayed step {r_wall:.2f} ms/step (host "
          f"clock, profiler on), device busy {r_busy:.2f} ms "
          f"({r_busy / r_wall:.0%}), host {host_ms:.2f} ms inside one "
          f"replayed step's call with the card drained before it [{card}]")


if __name__ == "__main__":
    main()
