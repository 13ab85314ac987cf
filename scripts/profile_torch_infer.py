#!/usr/bin/env python3
"""Where the time goes in the port's inference forward, per test scale.

Runs sniper_tpu_torch's R101 detector (``--cfg``, by default
configs/sniper_res101_e2e.yml; seeded random weights) on synthetic
canvases at each TEST.SCALES entry with the shipped batch size and
post-NMS roi count, under torch.profiler, and prints per scale: the
host-clock time per batch, the device-busy time (sum of kernel times) and
its share, and the device time by kernel group (the hand-written kernels,
convolutions, GEMMs, the rest), then the top kernels by device time, then
per layer of the program (its spans, utils/profiler.span: trunk, rpn,
head, the mask branch inside head) the host time, the device time of the
work launched inside it, its launches and the device's idle time while the
host was inside it (benchmark/core/spans.py), and the unit epilogue's
launches per batch (ops/epilogue.py: 1 + 3 a unit of R101 or X101 where
every epilogue runs as the kernel). TF32 is off, as in
chip_smoke.py. Needs one CUDA device.

    python3 scripts/profile_torch_infer.py [--reps 3] [--cfg configs/sniper_res101_e2e_mask.yml]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GROUPS = (
    ("kernel:fused_pool", ("pool_pass_kernel",)),
    ("kernel:nms", ("nms_mask_kernel", "nms_scan_kernel")),
    ("kernel:deform_im2col", ("deform_im2col_kernel",)),
    ("kernel:roi_patch", ("roi_patch_kernel",)),
    ("kernel:unit_epilogue", ("bn_unit_epilogue_kernel",)),
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


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--cfg", default="configs/sniper_res101_e2e.yml")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_infer: needs a CUDA device")

    from torch.profiler import ProfilerActivity, profile

    from benchmark.core import spans
    from sniper_tpu_torch.config import load_config
    from sniper_tpu_torch.data.test_loader import canvas_for_scale
    from sniper_tpu_torch.infer.tester import device_normalize
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.ops import cuda

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
        cuda.UNIT_EPILOGUE.launches = 0
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
            # a user range (a program span) spans kernels: not one itself
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)):
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
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        t = spans.table(events, float("-inf"), float("inf"), group_of)
        print("  by layer, per batch: host ms, device ms, launches, idle ms")
        for name, row in t["spans"].items():
            print(f"  {name:34s} {row['host_s'] * 1e3 / args.reps:9.3f} "
                  f"{row['device_s'] * 1e3 / args.reps:9.3f} "
                  f"{row['launches'] / args.reps:7.0f} "
                  f"{row['idle_s'] * 1e3 / args.reps:9.3f}")
            for g, sec in sorted(row["by_group"].items(),
                                 key=lambda kv: -kv[1]):
                print(f"    {g:32s} {sec * 1e3 / args.reps:9.3f} ms")
        print(f"  launches per batch: {t['launches'] / args.reps:.0f}")
        print(f"  unit epilogue launches per batch: "
              f"{cuda.UNIT_EPILOGUE.launches / args.reps:.0f}")


if __name__ == "__main__":
    main()
