#!/usr/bin/env python3
"""Where the time goes in the port's inference forward, per test scale.

Runs sniper_tpu_torch's R101 detector (``--cfg``, by default
configs/sniper_res101_e2e.yml; seeded random weights) on synthetic
canvases at each TEST.SCALES entry with the shipped batch size and
post-NMS roi count, under torch.profiler, and prints per scale: the
host-clock time per batch, the device-busy time (sum of kernel times) and
its share, and the device time by kernel group (the hand-written kernels,
convolutions, GEMMs, the rest), then the top kernels by device time. A
second, unprofiled pass times the detector's stages on the device with
CUDA events around them (trunk, R-CNN head, and with the mask branch its
14x14 pool, the fused_pool kernels' two passes and the offset FC, and its
head). TF32 is off, as in chip_smoke.py. Needs one CUDA device.

    python3 scripts/profile_torch_infer.py [--reps 3] [--cfg configs/sniper_res101_e2e_mask.yml]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GROUPS = (
    ("kernel:fused_pool", ("pool_pass_kernel",)),
    ("kernel:nms", ("nms_mask_kernel", "nms_scan_kernel")),
    ("kernel:deform_im2col", ("deform_im2col_kernel",)),
    ("kernel:roi_patch", ("roi_patch_kernel",)),
    ("conv (cuDNN)", ("conv", "cudnn", "implicit", "xmma_fprop", "sm90_xmma",
                      "fprop")),
    ("gemm (cuBLAS)", ("gemm", "cutlass", "sm90_")),
    ("sort/topk", ("sort", "Sort", "radix", "topk")),
)


def group_of(name: str) -> str:
    for g, keys in GROUPS:
        if any(k in name for k in keys):
            return g
    return "other (elementwise, BN, copies)"


@contextlib.contextmanager
def stage_timers(model, spans):
    """Wrap the detector's stages so that each call records CUDA events
    around itself into ``spans[name]`` (restored on exit)."""
    def timed(name, fn):
        def run(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            spans[name].append((start, end))
            return out
        return run

    patched = [(model.trunk, "forward", "trunk"),
               (model.rcnn, "forward", "R-CNN head (pool + FCs)")]
    if model.with_mask:
        patched += [(model, "_mask_pool", "mask pool (14x14)"),
                    (model.mask, "forward", "mask head")]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patched]
    for obj, attr, name in patched:
        setattr(obj, attr, timed(name, getattr(obj, attr)))
    try:
        yield
    finally:
        for obj, attr, fn in saved:
            if isinstance(obj, torch.nn.Module):
                del obj.__dict__[attr]  # back to the class's forward
            else:
                setattr(obj, attr, fn)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--cfg", default="configs/sniper_res101_e2e.yml")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_infer: needs a CUDA device")

    from torch.profiler import ProfilerActivity, profile

    from sniper_tpu_torch.config import load_config
    from sniper_tpu_torch.data.test_loader import canvas_for_scale
    from sniper_tpu_torch.infer.tester import device_normalize
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(os.path.join(ROOT, args.cfg))
    print(f"{args.cfg}: symbol {cfg.symbol}")
    model = init_detector(get_model(cfg), seed=0, offset_std=1e-3)
    model.to(dev).eval()
    gen = torch.Generator().manual_seed(0)
    for s, spec in enumerate(cfg.TEST.SCALES):
        (ch, cw), _ = canvas_for_scale(spec)
        bs = int(cfg.TEST.BATCH_IMAGES[s])
        n = int(cfg.TEST.N_PROPOSAL_PER_SCALE[s])
        data = torch.randint(0, 255, (bs, ch, cw, 3), generator=gen,
                             dtype=torch.uint8).to(dev)
        info = torch.tensor([[ch, cw, 1.0]] * bs, device=dev)

        @torch.inference_mode()
        def fwd():
            d = device_normalize(data, info, cfg.network.PIXEL_MEANS)
            return model(d, info, post_nms_top_n=n)

        fwd()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.reps):
                fwd()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / args.reps
        per_kernel = collections.Counter()
        launches = collections.Counter()  # per batch, by group
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                per_kernel[e.name] += (e.time_range.elapsed_us() / 1e3
                                       / args.reps)
                launches[group_of(e.name)] += 1 / args.reps
        busy = sum(per_kernel.values())
        groups = collections.Counter()
        for name, ms in per_kernel.items():
            groups[group_of(name)] += ms
        print(f"scale {s}: canvas {ch}x{cw}, batch {bs}, {n} rois/img: "
              f"{wall:.2f} ms/batch (host clock, profiler on), device busy "
              f"{busy:.2f} ms ({busy / wall:.0%}), idle "
              f"{max(0.0, 1 - busy / wall):.0%} [{card}]")
        for g, ms in groups.most_common():
            print(f"  {g:34s} {ms:9.3f} ms  {ms / busy:6.1%}  "
                  f"{launches[g]:5.0f} launches")
        for name, ms in per_kernel.most_common(8):
            print(f"    {ms:9.3f} ms  {name[:100]}")
        spans = collections.defaultdict(list)
        with stage_timers(model, spans):
            for _ in range(args.reps):
                fwd()
            torch.cuda.synchronize()
        print("  device time by stage (CUDA events around each call, per "
              "batch):")
        for name, evs in spans.items():
            ms = sum(a.elapsed_time(b) for a, b in evs) / args.reps
            print(f"  {name:34s} {ms:9.3f} ms")


if __name__ == "__main__":
    main()
