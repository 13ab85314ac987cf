#!/usr/bin/env python3
"""Where the model zoo's trunks spend their time on the card.

For ResNeXt-101 (configs/sniper_res101_e2e.yml with ``symbol
resnext_mx_101``) and MobileNetV2 (configs/sniper_mobilenetv2_e2e.yml),
with seeded random weights, a bf16 trunk and TF32 off, as chip_smoke.py
runs them:

- inference, at each test scale (the shipped batch on a synthetic canvas
  of the scale's landscape size): the trunk's device time, and the device
  time of every grouped convolution it ran (``F.conv2d`` with groups > 1:
  ResNeXt's 64-group 3x3s of stages 1-3, MobileNetV2's depthwise 3x3s),
  replayed one by one at the shapes and memory format the trunk gave
  them; for ResNeXt also its C5's three deformable convs split into the
  im2col kernel (X1, writing the col group-major), the grouped product on
  that col (``ops/deform.py:grouped_product``: one ``torch.bmm`` and the
  output's reorder) and the whole conv;
- training (the yml's BATCH_IMAGES chips of CHIP_SIZE): the same for the
  trunk's forward and backward (the grouped convs replayed forward and
  backward); for ResNeXt the C5 convs also forward and backward and the
  im2col backward (X2) alone, and the CUDA kernels of one profiled trunk
  step next to each X1 and X2 launch in launch order (torch.profiler),
  which shows what runs between X1 and the grouped GEMM and between the
  GEMM's input gradient and X2.

Times are CUDA events over ``--reps`` calls after a warm-up. Needs one CUDA
device:

    python3 scripts/profile_torch_zoo.py [--reps 5] [--models resnext_mx_101]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def time_ms(fn, reps: int) -> float:
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


@contextlib.contextmanager
def grouped_convs(calls: list):
    """Record every F.conv2d call with groups > 1 as (input shape, dtype,
    channels_last, weight shape, stride, padding, dilation, groups)."""
    inner = F.conv2d

    def conv2d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        if groups > 1:
            calls.append((tuple(x.shape), x.dtype,
                          x.is_contiguous(memory_format=torch.channels_last),
                          tuple(w.shape), stride, padding, dilation, groups))
        return inner(x, w, b, stride, padding, dilation, groups)

    F.conv2d = conv2d
    try:
        yield
    finally:
        F.conv2d = inner


def replay(calls, reps: int, backward: bool) -> list:
    """Each recorded grouped conv's device time in ms (forward, or forward
    and backward), alone at its shapes."""
    out = []
    for shape, dtype, cl, wshape, stride, padding, dilation, groups in calls:
        x = torch.randn(shape, device="cuda", dtype=dtype)
        if cl:
            x = x.contiguous(memory_format=torch.channels_last)
        w = torch.randn(wshape, device="cuda", dtype=dtype) * 0.05
        if backward:
            x.requires_grad_()
            w.requires_grad_()

            def run():
                y = F.conv2d(x, w, None, stride, padding, dilation, groups)
                y.backward(torch.ones_like(y))
        else:
            def run():
                with torch.inference_mode():
                    F.conv2d(x, w, None, stride, padding, dilation, groups)
        out.append(time_ms(run, reps))
    return out


def deform_split(model, x, reps: int, train: bool) -> str:
    """ResNeXt's C5 deformable convs, each part timed alone at its unit's
    shapes: X1 (the col group-major), the grouped product on that col, the
    whole conv forward; in training also the conv forward and backward and
    X2 alone."""
    from sniper_tpu_torch.ops import deform

    ins = []
    hooks = [getattr(model.trunk, f"stage4_unit{j + 1}").bn1
             .register_forward_hook(lambda m, a, o: ins.append(o.detach()))
             for j in range(model.trunk.units[3])]
    with torch.no_grad():
        model.trunk(x)
    for h in hooks:
        h.remove()
    x1 = product = conv = both = x2 = 0.0
    for j, h in enumerate(ins):
        h = torch.relu(h).permute(0, 2, 3, 1).contiguous()
        B, H, W, C = h.shape
        unit = getattr(model.trunk, f"stage4_unit{j + 1}")
        kw = dict(num_groups=4, dilation=2, conv_groups=unit.num_groups)
        off = torch.randn(B, H, W, 72, device="cuda") * 2
        w = unit.conv2_weight.detach().to(h.dtype)
        with torch.inference_mode():
            col = deform.deform_im2col(h, off, **kw)
            x1 += time_ms(lambda: deform.deform_im2col(h, off, **kw), reps)
            product += time_ms(
                lambda: deform.grouped_product(col, w, (B, H, W)), reps)
            conv += time_ms(lambda: deform.deformable_conv(h, off, w, **kw),
                            reps)
        if train:
            gcol = torch.randn_like(col)
            x2 += time_ms(lambda: deform.deform_im2col_bwd(h, off, gcol,
                                                           **kw), reps)
            hr, offr, wr = (t.clone().requires_grad_() for t in (h, off, w))
            gout = torch.randn(B, H, W, w.shape[0], device="cuda",
                               dtype=h.dtype)
            both += time_ms(lambda: deform.deformable_conv(
                hr, offr, wr, **kw).backward(gout), reps)
            del gcol
        del col
    line = (f"C5's {len(ins)} deformable convs (col group-major): X1 "
            f"{x1:.3f} ms, grouped product {product:.3f} ms, the conv "
            f"forward {conv:.3f} ms")
    if train:
        line += f"; forward and backward {both:.3f} ms, X2 {x2:.3f} ms"
    return line


def c5_kernel_order(trunk_step) -> list[str]:
    """The CUDA kernels of one profiled trunk step that run right after
    each X1 launch and right before each X2 launch, in launch order: what
    separates X1 from the grouped GEMM, and the GEMM's input gradient from
    X2."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        trunk_step()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)

    def show(e):
        return f"{e.name[:70]} ({e.time_range.elapsed_us():.0f} us)"

    lines = []
    for i, e in enumerate(kernels):
        if "deform_im2col_kernel" in e.name:
            lines.append(f"X1 {show(e)} -> then: "
                         + " | ".join(show(k) for k in kernels[i + 1:i + 4]))
        elif "deform_im2col_bwd_kernel" in e.name:
            lines.append("before: " + " | ".join(
                show(k) for k in kernels[max(0, i - 3):i])
                + f" -> X2 {show(e)}")
    return lines


def profile(name, cfg, reps: int):
    from sniper_tpu_torch.data.test_loader import canvas_for_scale
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model

    model = init_detector(get_model(cfg), seed=0, offset_std=1e-3).cuda()
    runs = []
    for s, spec in enumerate(cfg.TEST.SCALES):
        (h, w), _ = canvas_for_scale(spec)
        runs.append((f"scale {s} ({int(cfg.TEST.BATCH_IMAGES[s])}x{h}x{w})",
                     int(cfg.TEST.BATCH_IMAGES[s]), h, w, False))
    c = int(cfg.TRAIN.CHIP_SIZE)
    runs.append((f"training ({int(cfg.TRAIN.BATCH_IMAGES)}x{c}x{c}, forward "
                 "and backward)", int(cfg.TRAIN.BATCH_IMAGES), c, c, True))
    for label, B, h, w, train in runs:
        g = torch.Generator(device="cuda").manual_seed(1)
        x = (torch.randn(B, h, w, 3, device="cuda", generator=g) * 50
             ).permute(0, 3, 1, 2)
        model.train(train)
        calls: list = []
        with grouped_convs(calls):
            if train:
                model.trunk.feature(x)
            else:
                with torch.inference_mode():
                    model.trunk(x)

        def trunk():
            if train:
                model.trunk.feature(x).float().mean().backward()
            else:
                with torch.inference_mode():
                    model.trunk(x)

        trunk_ms = time_ms(trunk, reps)
        model.zero_grad(set_to_none=True)
        times = replay(calls, reps, train)
        total = sum(times)
        kinds = {}
        for call, t in zip(calls, times):
            key = (call[3][1], call[7])  # channels per group, groups
            n, ms = kinds.get(key, (0, 0.0))
            kinds[key] = (n + 1, ms + t)
        parts = ", ".join(f"{n} x {g} groups of {cpg} channels {ms:.2f} ms"
                          for (cpg, g), (n, ms) in sorted(kinds.items()))
        extra = order = ""
        if model.trunk_type == "resnext":
            extra = "; " + deform_split(model, x, reps, train)
            if train:
                order = "\n  ".join(c5_kernel_order(trunk))
                model.zero_grad(set_to_none=True)
        print(f"{name} {label}: trunk {trunk_ms:.2f} ms; its {len(calls)} "
              f"grouped convs replayed alone {total:.2f} ms "
              f"({100 * total / trunk_ms:.1f}% of the trunk): {parts}{extra}",
              flush=True)
        if order:
            print(f"{name} {label}: kernels next to X1 and X2 in one "
                  f"profiled step:\n  {order}", flush=True)
    del model
    torch.cuda.empty_cache()


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--models", nargs="+",
                   default=["resnext_mx_101", "mobilenetv2_e2e"],
                   choices=["resnext_mx_101", "mobilenetv2_e2e"])
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_zoo: needs a CUDA device")
    from sniper_tpu_torch.config import load_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    x101 = load_config(os.path.join(ROOT, "configs/sniper_res101_e2e.yml"),
                       ["symbol", "resnext_mx_101"])
    mnv2 = load_config(os.path.join(ROOT,
                                    "configs/sniper_mobilenetv2_e2e.yml"))
    for name, cfg in (("resnext_mx_101", x101), ("mobilenetv2_e2e", mnv2)):
        if name in args.models:
            profile(name, cfg, args.reps)


if __name__ == "__main__":
    main()
