#!/usr/bin/env python3
"""ResNeXt-101's C5 deformable conv alone on the card, through
``ops/deform.py:deformable_conv`` (the entry every version of the port has):
x [B,H,W,2048] bf16, 4 deformable groups, 64 conv groups, dilation 2, at
the first test scale's C5 map of configs/sniper_res101_e2e.yml (4 x 88 x
128) and at training's (16 x 32 x 32), forward and forward + backward, at
zero offsets (a fresh model's), +-0.5 px (a trained model's small
offsets) and +-6 px (samples clamp onto the border).

``--tree DIR`` imports the port from DIR, an older checkout (``git archive
<commit> | tar -x -C DIR``), so that two versions can be timed in one call,
in turns:

    python3 scripts/profile_torch_c5.py --tree build/parent_tree
    python3 scripts/profile_torch_c5.py
    python3 scripts/profile_torch_c5.py
    python3 scripts/profile_torch_c5.py --tree build/parent_tree

Times are CUDA events over ``--reps`` calls after a warm-up, with the
launches of the im2col kernels counted over the timed calls.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (label, B, H, W): X101's C5 maps at the first test scale and in training
SHAPES = (("scale 0", 4, 88, 128), ("training", 16, 32, 32))
OFFSETS = (("zero offsets", 0.0), ("+-0.5 px", 0.5), ("+-6 px", 6.0))


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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=ROOT,
                   help="the checkout whose sniper_tpu_torch is timed")
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_c5: needs a CUDA device")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from sniper_tpu_torch.ops import cuda, deform

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"{card}; the port from {tree}")
    CG, C, G = 64, 2048, 4
    kw = dict(num_groups=G, dilation=2, conv_groups=CG)
    g = torch.Generator().manual_seed(13)
    w = (torch.randn(C, C // CG, 3, 3, generator=g) * 0.02).cuda().to(
        torch.bfloat16)
    for label, B, H, W in SHAPES:
        x = torch.randn(B, H, W, C, generator=g).cuda().to(torch.bfloat16)
        gout = torch.randn(B, H, W, C, generator=g).cuda().to(torch.bfloat16)
        for olabel, scale in OFFSETS:
            off = ((torch.rand(B, H, W, G * 18, generator=g) * 2 - 1)
                   * scale).cuda()
            with torch.no_grad():
                fwd = time_ms(lambda: deform.deformable_conv(x, off, w, **kw),
                              args.reps)
            xr, offr, wr = (t.clone().requires_grad_() for t in (x, off, w))

            def step():
                deform.deformable_conv(xr, offr, wr, **kw).backward(gout)

            step()
            for k in cuda.KERNELS:
                k.launches = 0
            both = time_ms(step, args.reps)
            launches = {k.name: k.launches for k in cuda.KERNELS
                        if k.launches}
            print(f"X101 C5 conv [{label}, x [{B},{H},{W},{C}] bf16, "
                  f"{olabel}]: forward {fwd:.4f} ms, forward + backward "
                  f"{both:.4f} ms; launches over {args.reps + 1} steps "
                  f"{launches} [{card}]", flush=True)
            del xr, offr, wr
        del x, gout
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
