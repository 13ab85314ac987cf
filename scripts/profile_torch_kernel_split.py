#!/usr/bin/env python3
"""Where the time of the DCN im2col (X1) and the pool backward (P3) kernels
goes, by building variants of their sources.

Each ``--pool-bwd SRC`` is a version of csrc/fused_pool_bwd.cu (the
repository's by default; pass an older copy beside it to compare the two
in one run). The script compiles, in a temporary directory, the source as
it is and variants with one part of the work removed by a text edit (the
global atomics into dfeat, the cross-thread reductions of the window-start
sums, the feature reads, the gather loads of g; for the current design
also each of its two channel phases whole), and times pass B
(stencil) and pass A (avg) of each at the training shapes of
configs/sniper_res101_e2e.yml: 16 chips of 512x512 (a 32x32 map at stride
16), 300 rois per chip with sides of 8 to 480 px, C 256, P 7, S 4, margin
4, window starts from random offsets. A part's share is the full kernel's
time less the variant's: the parts overlap on the card, so the shares need
not add up to the whole.

Each ``--im2col SRC`` is a version of csrc/deform_im2col.cu, timed as it is
at the shapes chip_smoke.py checks it at (x bf16 with C 512 on the C5 maps
of the three test scales and of training, offsets of +-6 px), with its
effective write rate.

Times are CUDA events over REPS launches after one warm-up, on one card,
all versions in one process.

    python3 scripts/profile_torch_kernel_split.py \
        [--pool-bwd SRC ...] [--im2col SRC ...] [--reps 10]
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sniper_tpu_torch.ops import cuda, deform  # noqa: E402

CSRC = os.path.join(ROOT, "sniper_tpu_torch", "csrc")
_P, _I = ctypes.c_void_p, ctypes.c_int
POOL_SIG = [_P] * 6 + [_I] * 8 + [_P]
IM2COL_SIG = [_P, _P, _P] + [_I] * 8 + [_P]

# (part removed, [(text, replacement), ...]) per version of the source,
# told apart by a line only that version has. Each edit keeps the values it
# no longer computes alive through a branch that never runs.
POOL_VARIANTS = {
    # the first design: threads over channels, one block per roi
    "block_add(": [
        ("dfeat atomics", [(
            "atomicAdd(drow + (size_t)w * C, __fmul_rn(wxv, t));",
            "if (wxv == 1e-30f) drow[(size_t)w * C] = t;")]),
        ("block reductions", [(
            "  v = warp_sum(v);\n  if ((threadIdx.x & 31) == 0) atomicAdd(dst, v);",
            "  if (v == 1e-30f) *dst = v;")]),
        ("feature reads", [
            ("frow[(size_t)w * C]", "(float)w"),
            ("fcol[(size_t)h * W * C]", "(float)h")]),
    ],
    # warps own bins, dfeat gathered per footprint cell
    "bin_start_sums": [
        ("dfeat atomics", [(
            "if (v < nv) add_to<VEC>(dcell + v * VEC, acc[s]);",
            "{ float t = 0.0f; for (int j = 0; j < VEC; ++j) t += acc[s][j]; "
            "if (v < nv && t == 1e-30f) dcell[v * VEC] = t; }")]),
        ("warp reductions", [("s = warp_sum(s);", "")]),
        ("feature reads", [(
            "load_vec<VEC>(fl + h * WC + (size_t)w * C + 32 * VEC * k, f);",
            "for (int j = 0; j < VEC; ++j) f[j] = (float)(h + w + j);")]),
        ("gather loads of g", [(
            "load_vec<VEC>(gp + v * VEC, gv);",
            "for (int j = 0; j < VEC; ++j) gv[j] = (float)(p + j);")]),
    ],
}
# whole phases of the current design, each removed on its own: what is left
# without both is the per-roi geometry (phase 0 and the final d(py, px))
POOL_PHASES = {
    "bin_start_sums": [
        ("phase 1 (window-start sums)", [(
            "  if (stencil) {\n    for (int p = threadIdx.x >> 5;",
            "  if (false) {\n    for (int p = threadIdx.x >> 5;")]),
        ("phase 2 (dfeat gather)", [(
            "if (box[1] >= box[0] && box[3] >= box[2]) {", "if (false) {")]),
    ],
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def edit(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise ValueError(f"variant edit does not match: {old!r}")
        text = text.replace(old, new)
    return text


def pool_variants(text: str) -> list[tuple[str, str]]:
    """(label, source) for the full kernel, each part removed, all removed."""
    marker = next((m for m in POOL_VARIANTS if m in text), None)
    if marker is None:
        raise ValueError("unknown fused_pool_bwd.cu version")
    parts = POOL_VARIANTS[marker]
    out = [("full", text)]
    out += [(f"without {name}", edit(text, e)) for name, e in parts]
    every = [x for _, e in parts for x in e]
    out.append(("without all of these", edit(text, every)))
    phases = POOL_PHASES.get(marker, [])
    out += [(f"without {name}", edit(text, e)) for name, e in phases]
    if phases:
        both = [x for _, e in phases for x in e]
        out.append(("without both phases", edit(text, both)))
    return out


def build_all(jobs, tmp):
    """jobs: [(key, source text)] -> {key: CDLL}, one nvcc each, in
    parallel; pool_geometry.cuh sits beside every source."""
    procs = []
    for i, (key, text) in enumerate(jobs):
        d = os.path.join(tmp, f"v{i}")
        os.makedirs(d)
        shutil.copy(os.path.join(CSRC, "pool_geometry.cuh"), d)
        src = os.path.join(d, "kernel.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(d, "kernel.so")
        procs.append((key, lib, subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-shared", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for key, lib, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(lib)
    return libs


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def pool_inputs(dev):
    """chip_smoke.py:check_pool_bwd's training inputs, random offsets."""
    B, rpi, C, H, W, P, S, M, chip = 16, 300, 256, 32, 32, 7, 4, 4, 512
    R = B * rpi
    g = torch.Generator().manual_seed(5)
    feat = torch.randn(B, H, W, C, generator=g).to(dev)
    rois = torch.zeros(R, 5)
    rois[:, 0] = torch.arange(B).repeat_interleave(rpi).float()
    xy = torch.rand(R, 2, generator=g) * (chip + 60) - 30
    wh = torch.exp(torch.rand(R, 2, generator=g) * math.log(60.0)) * 8.0
    rois[:, 1:3], rois[:, 3:5] = xy, xy + wh
    gout = torch.randn(R, P * P, C, generator=g).to(dev)
    geom, roi_h, roi_w, sub_h, sub_w = deform.pool_geometry(
        rois.to(dev), P=P, S=S, M=M, spatial_scale=1 / 16)
    off = (torch.randn(R, 2 * P * P, generator=g) * 0.3).to(dev)
    pypx = deform.window_starts(off, roi_h, roi_w, sub_h, sub_w, P=P, S=S,
                                M=M, trans_std=0.1)
    dims = dict(R=R, H=H, W=W, C=C, rpi=rpi, P=P, S=S, M=M)
    return feat, geom, pypx, gout, dims


def run_pool(lib, feat, geom, pypx, gout, dims, reps):
    fn = lib.sniper_pool_pass_bwd
    fn.argtypes, fn.restype = POOL_SIG, ctypes.c_int
    d = dims
    dfeat = torch.zeros_like(feat)
    dpp = torch.empty(d["R"], 2, d["P"] ** 2, device=feat.device)
    st = torch.cuda.current_stream().cuda_stream

    def call(bins):
        code = fn(feat.data_ptr(), geom.data_ptr(),
                  None if bins is None else bins.data_ptr(), gout.data_ptr(),
                  dfeat.data_ptr(), None if bins is None else dpp.data_ptr(),
                  d["R"], d["H"], d["W"], d["C"], d["rpi"], d["P"], d["S"],
                  d["M"], st)
        if code:
            raise RuntimeError(f"sniper_pool_pass_bwd: CUDA error {code}")

    return (time_ms(lambda: call(pypx), reps),
            time_ms(lambda: call(None), reps))


def im2col_shapes():
    # (label, B, H, W): the C5 maps of the test scales and of training
    return (("scale 0", 4, 88, 128), ("scale 1", 8, 52, 80),
            ("scale 2", 8, 32, 32), ("training", 16, 32, 32))


def run_im2col(lib, dev, reps):
    fn = lib.sniper_deform_im2col
    fn.argtypes, fn.restype = IM2COL_SIG, ctypes.c_int
    out = []
    for label, B, H, W in im2col_shapes():
        C, G, K, d = 512, 4, 3, 2
        g = torch.Generator().manual_seed(2)
        x = torch.randn(B, H, W, C, generator=g).to(dev, torch.bfloat16)
        off = ((torch.rand(B, H, W, G * K * K * 2, generator=g) * 2 - 1)
               * 6.0).to(dev)
        col = torch.empty(B, H, W, K * K, C, device=dev, dtype=torch.bfloat16)
        st = torch.cuda.current_stream().cuda_stream

        def call():
            code = fn(x.data_ptr(), off.data_ptr(), col.data_ptr(), 1, B, H,
                      W, C, G, K, d, st)
            if code:
                raise RuntimeError(f"sniper_deform_im2col: CUDA error {code}")

        ms = time_ms(call, reps)
        nbytes = x.numel() * 2 + off.numel() * 4 + col.numel() * 2
        out.append((label, ms, nbytes / ms / 1e6))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pool-bwd", action="append", default=[])
    ap.add_argument("--im2col", action="append", default=[])
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_kernel_split: needs a CUDA device")
    if not a.pool_bwd and not a.im2col:
        a.pool_bwd = [os.path.join(CSRC, "fused_pool_bwd.cu")]
        a.im2col = [os.path.join(CSRC, "deform_im2col.cu")]
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    jobs = []
    for src in a.pool_bwd:
        with open(src) as f:
            jobs += [(("pool", src, label), text)
                     for label, text in pool_variants(f.read())]
    for src in a.im2col:
        with open(src) as f:
            jobs.append((("im2col", src, "full"), f.read()))
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(jobs, tmp)
        if a.pool_bwd:
            inputs = pool_inputs(dev)
        for (kind, src, label), lib in libs.items():
            if kind == "pool":
                b_ms, a_ms = run_pool(lib, *inputs, a.reps)
                print(f"fused_pool_bwd {src} [{label}]: pass B {b_ms:.4f} ms, "
                      f"pass A {a_ms:.4f} ms, both {b_ms + a_ms:.4f} ms "
                      f"[{card}]")
            else:
                for shape, ms, rate in run_im2col(lib, dev, a.reps):
                    print(f"deform_im2col {src} [{shape}]: {ms:.4f} ms, "
                          f"{rate:.1f} GB/s effective [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
