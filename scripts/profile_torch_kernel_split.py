#!/usr/bin/env python3
"""Where the time of five of the port's kernels goes, by building variants
of their sources: the pool forward (P1/P2), the pool backward (P3), the DCN
im2col (X1) and its backward (X2), and greedy NMS (P4).

Each ``--pool SRC`` is a version of csrc/fused_pool.cu (pass your own copy
of an older one beside the repository's to compare the two in one run),
each ``--pool-bwd SRC`` one of csrc/fused_pool_bwd.cu, each
``--im2col-bwd SRC`` one of csrc/deform_im2col_bwd.cu. The script compiles,
in a temporary directory, the source as it is and variants with one part of
the work removed by a text edit, and times them:

- the pool forward, pass A (avg) and pass B (stencil) at the shapes
  chip_smoke.py:check_pool gives them (the three test scales of
  configs/sniper_res101_e2e.yml and training, random rois, window starts
  from a random offset FC). Parts: the shared-memory zeroing, the per-bin
  composition, the feature reads (the first design's zeroing is timed by
  doing it twice, since without it the tap loop reads stale weights);
- the pool backward, pass B and pass A at the training shapes: 16 chips of
  512x512 (a 32x32 map at stride 16), 300 rois per chip with sides of 8 to
  480 px, C 256, P 7, S 4, margin 4, window starts from random offsets.
  Parts: the global atomics into dfeat, the cross-thread reductions of the
  window-start sums, the feature reads, the gather loads of g, and for the
  current design each of its two channel phases whole;
- the im2col backward at chip_smoke.py:check_im2col_bwd's training shapes
  at R101's C5 width (x [16,32,32,512] bf16, G 4, dilation 2) and at
  ResNeXt-101's (C 2048, 64 conv groups: gcol group-major for a source
  that takes conv_groups), at zero offsets, at +-0.5 px (a trained model's
  small offsets: all four corners of a sample weigh) and at +-6 px.
  Parts: the gx atomics, the goff reductions (shuffles, the shared-memory
  atomics of the route for groups wider than a warp, the per-warp partial
  sums), the x corner reads, the gcol reads, the per-channel geometry.
  The wrapper's zeroing of the fp32 gx scratch and its cast to bf16 are
  timed once per width.

A part's share is the full kernel's time less the variant's ("with a
second" variants add the part once more: their excess over the full kernel
is the part's cost; "all of these" then means the removals plus that
addition). The parts
overlap on the card, so the shares need not add up to the whole.

Each ``--nms SRC`` is a version of csrc/nms.cu, timed at chip_smoke.py's
check_nms shapes (N 6000 -> 300, 200, 100 at batches 4, 8, 8 and the
training batch 16 -> 300) on its two inputs (clustered boxes with distinct
scores; saturated ones, tied at 1.0 and repeated, as a random-weight RPN
emits them): the kernel on the sorted input (what the proposal op runs),
and the wrapper's stable sort and gather followed by the kernel (what
``nms`` runs). Parts: the scan (without it, the mask kernel alone: with
the scan state cleared, every range's rows in full, so the whole upper
triangle) and the mask kernel (without it, the scan alone, reading the
mask the full kernel wrote); the sort and gather alone are timed once per
input. The full kernel's keep lists are held against nms_plain.

Each ``--im2col SRC`` is a version of csrc/deform_im2col.cu, timed as it is
at the shapes chip_smoke.py checks it at (x bf16 with C 512 on the C5 maps
of the three test scales and of training, and C 2048 with 64 conv groups at
scale 0 and in training; offsets of +-6 px), with its effective rate.

Times are CUDA events over REPS launches after one warm-up, on one card,
all versions in one process; ``--rounds 2`` times them all twice, the
second time in reverse order (old, new, new, old). With no source named,
the repository's five sources are timed.

    python3 scripts/profile_torch_kernel_split.py [--pool SRC ...] \
        [--pool-bwd SRC ...] [--im2col SRC ...] [--im2col-bwd SRC ...] \
        [--nms SRC ...] [--reps 10] [--rounds 1]
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

from chip_smoke import NMS_INPUTS, nms_input, random_rois  # noqa: E402
from sniper_tpu_torch.ops import cuda, deform, nms  # noqa: E402

CSRC = os.path.join(ROOT, "sniper_tpu_torch", "csrc")
_P, _I = ctypes.c_void_p, ctypes.c_int
POOL_SIG = [_P] * 4 + [_I] * 9 + [_P]
POOL_BWD_SIG = [_P] * 6 + [_I] * 8 + [_P]
# the im2col entries before and after they took conv_groups (one more int)
IM2COL_SIG = [_P, _P, _P] + [_I] * 8 + [_P]
IM2COL_BWD_SIG = [_P] * 5 + [_I] * 8 + [_P]
IM2COL_CG_SIG = [_P, _P, _P] + [_I] * 9 + [_P]
IM2COL_BWD_CG_SIG = [_P] * 5 + [_I] * 9 + [_P]
NMS_SIG = [_P] * 3 + [_I] * 3 + [ctypes.c_float] * 2 + [_P] * 4

# Per kernel: {a line only that version of the source has: [(part removed,
# [(text, replacement), ...]), ...]}. Each edit keeps the values it no
# longer computes alive through a branch that never runs.
VARIANTS = {
    "pool": {
        # the first design: one block per (roi, 128 channels), dense cy, cx
        "compose_axis(stencil": [
            ("a second shared-memory zeroing", [(
                "smem[i] = 0.0f;\n  __syncthreads();",
                "smem[i] = 0.0f;\n  __syncthreads();\n"
                "  for (int i = threadIdx.x; i < PP * (H + W); "
                "i += blockDim.x) smem[i] = 0.0f;\n  __syncthreads();")]),
            ("per-bin composition over all E cells (only the cells in "
             "reach, factor 1)", [(
                 "  for (int e = 0; e < E; ++e) {\n"
                 "    const float f = bin_factor(stencil, p0, first, S, e);",
                 "  const int ea = stencil ? max(0, (int)p0) : first;\n"
                 "  const int ez = min(E, ea + (stencil && p0 != (int)p0 "
                 "? S + 1 : S));\n"
                 "  for (int e = ea; e < ez; ++e) {\n"
                 "    const float f = 1.0f;")]),
            ("feature reads", [(
                "inner += wxv * frow[(size_t)w * C];",
                "inner += wxv * (float)w;")]),
        ],
        # one block per roi, compact weight lists, warps own bins
        "compose_list(": [
            ("per-bin composition (the lists of the first bin's tent)", [(
                "  for (int i = threadIdx.x; i < 2 * PP; i += blockDim.x) {",
                "  for (int i = threadIdx.x; i < 2; i += blockDim.x) {"), (
                "const int li = 2 * p;", "const int li = 0;")]),
            ("feature reads", [(
                "load_vec<VEC>(src + 32 * VEC * k, f[u][k]);",
                "for (int q = 0; q < VEC; ++q) "
                "f[u][k][q] = (float)(j + u + q);")]),
            ("output stores", [(
                "store_vec<VEC>(ob + c, o);",
                "{ float t = 0.0f; for (int q = 0; q < VEC; ++q) t += o[q]; "
                "if (t == 1e-30f) ob[c] = t; }")]),
        ],
    },
    "pool_bwd": {
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
    },
    "im2col_bwd": {
        # the first design: one block per (pixel, tap), scalar channels
        "sample_at(o + g * KK * 2, py, px, ky, kx, dilation,\n": [
            ("gx atomics", [(
                "      atomicAdd(gxb + base, __fmul_rn(__fmul_rn(mly, mlx), gv));\n"
                "      atomicAdd(gxb + base + C, __fmul_rn(__fmul_rn(mly, s.lx), gv));\n"
                "      atomicAdd(gxb + base + (int64_t)W * C,\n"
                "                __fmul_rn(__fmul_rn(s.ly, mlx), gv));\n"
                "      atomicAdd(gxb + base + (int64_t)W * C + C,\n"
                "                __fmul_rn(__fmul_rn(s.ly, s.lx), gv));\n",
                "      if (gv == 1e-30f) gxb[base] = __fmul_rn(mly, mlx);\n")]),
            ("goff reductions", [(
                "    if (warp_groups) {\n"
                "      gy = warp_sum(gy);\n"
                "      gxv = warp_sum(gxv);\n"
                "      if ((threadIdx.x & 31) == 0 && c < C) {\n"
                "        atomicAdd(&red[2 * g], gy);\n"
                "        atomicAdd(&red[2 * g + 1], gxv);\n"
                "      }\n"
                "    } else if (c < C) {\n"
                "      atomicAdd(&red[2 * g], gy);\n"
                "      atomicAdd(&red[2 * g + 1], gxv);\n"
                "    }\n",
                "    if (gy == 1e-30f && gxv == 1e-30f) red[2 * g] = gy;\n")]),
            ("x corner reads", [
                ("to_float(xc[0])", "(float)c"),
                ("to_float(xc[C])", "(float)(c + 1)"),
                ("to_float(xc[(int64_t)W * C])", "(float)(c + 2)"),
                ("to_float(xc[(int64_t)W * C + C])", "(float)(c + 3)")]),
            ("per-channel geometry (group 0's, once per block)", [(
                "  for (int c0 = 0; c0 < C; c0 += blockDim.x) {",
                "  const Sample s0 = sample_at(o, py, px, ky, kx, dilation, "
                "half, H, W);\n"
                "  for (int c0 = 0; c0 < C; c0 += blockDim.x) {"), (
                "      const Sample s = sample_at(o + g * KK * 2, py, px, ky, "
                "kx, dilation,\n                                 half, H, W);",
                "      const Sample s = s0;")]),
        ],
        # per-group blocks at L >= 32, group-major gcol, the warp route
        "route == kWarp": [
            ("gx atomics", [(
                "if (w[q] != 0.0f) add_corner<V>(gb + corner[q], w[q], g);",
                "if (g[0] == 1e-30f) gb[q] = w[q];")]),
            ("goff shuffles (seg and warp routes)", [(
                "dy += __shfl_xor_sync(0xffffffffu, dy, m);\n"
                "          dx += __shfl_xor_sync(0xffffffffu, dx, m);",
                "")]),
            ("per-group blocks (one block across all groups)", [(
                "const int slices = L >= 32 ? G : 1;",
                "const int slices = 1;")]),
            ("x corner reads", [(
                "Io<T, V>::load(base + corner[q], xv[q]);",
                "for (int k = 0; k < V; ++k) xv[q][k] = (float)(q + k);")]),
            ("gcol reads", [(
                "Io<T, V>::load_stream(gsrc + (int64_t)pt * cg_in, gv);",
                "for (int k = 0; k < V; ++k) gv[k] = (float)(c + k);")]),
        ],
        # a 16-pixel row tile per block, 16-byte vectors and vector atomics
        "scatter<V>(": [
            ("gx atomics", [(
                "if (w[q] != 0.0f) add_corner<V>(gb + corner[q], w[q], g);",
                "if (g[0] == 1e-30f) gb[q] = w[q];")]),
            ("goff reductions", [(
                "dy += __shfl_xor_sync(0xffffffffu, dy, m);\n"
                "          dx += __shfl_xor_sync(0xffffffffu, dx, m);",
                "")]),
            ("goff shared atomics (the sums route, L > 32)", [(
                "        atomicAdd(&sums[2 * si], dy);\n"
                "        atomicAdd(&sums[2 * si + 1], dx);",
                "        if (dy == 1e-30f && dx == 1e-30f) sums[2 * si] = dy;")]),
            ("x corner reads", [(
                "Io<T, V>::load(base + corner[q], xv[q]);",
                "for (int k = 0; k < V; ++k) xv[q][k] = (float)(q + k);")]),
            ("gcol reads", [(
                "Io<T, V>::load_stream(grow + c, gv);",
                "for (int k = 0; k < V; ++k) gv[k] = (float)(c + k);")]),
        ],
    },
    "nms": {
        # both designs launch the two kernels from sniper_nms (the second
        # once per range of tiles)
        "nms_scan_kernel<<<": [
            ("the scan", [("  nms_scan_kernel<<<",
                           "  if (false) nms_scan_kernel<<<")]),
            ("the mask kernel", [("  nms_mask_kernel<<<",
                                  "  if (false) nms_mask_kernel<<<")]),
        ],
    },
}
# whole phases of the current P3 design, each removed on its own: what is
# left without both is the per-roi geometry (phase 0 and the final d(py,px))
POOL_BWD_PHASES = {
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


def variants(kind: str, text: str) -> list[tuple[str, str]]:
    """(label, source) for the full kernel, each part removed, all removed
    (and, for P3, its phases)."""
    table = VARIANTS[kind]
    marker = next((m for m in table if m in text), None)
    if marker is None:
        raise ValueError(f"unknown version of the {kind} source")
    out = [("full", text)]
    parts = []
    for name, e in table[marker]:
        try:
            edit(text, e)
            parts.append((name, e))
        except ValueError:
            print(f"{kind}: no variant without {name} (its text is not in "
                  "this source)")
    out += [(f"{'with' if name.startswith('a second') else 'without'} "
             f"{name}", edit(text, e)) for name, e in parts]
    every = [x for _, e in parts for x in e]
    out.append(("without all of these", edit(text, every)))
    phases = POOL_BWD_PHASES.get(marker, []) if kind == "pool_bwd" else []
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


def _entry(lib, name, sig):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = sig, ctypes.c_int

    def call(*args):
        code = fn(*args)
        if code:
            raise RuntimeError(f"{name}: CUDA error {code}")

    return call


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# (label, B, H, W, rois per image): the C5 maps and roi counts of the test
# scales of configs/sniper_res101_e2e.yml and of training
SHAPES = (("scale 0", 4, 88, 128, 300), ("scale 1", 8, 52, 80, 200),
          ("scale 2", 8, 32, 32, 100), ("training", 16, 32, 32, 300))


def pool_inputs(dev):
    """chip_smoke.py:check_pool's inputs at each shape."""
    out = []
    C, P, S, M = 256, 7, 4, 4
    for label, B, H, W, rpi in SHAPES:
        g = torch.Generator().manual_seed(3)
        feat = torch.randn(B, H, W, C, generator=g).to(dev)
        R = B * rpi
        rois = random_rois(B, rpi, H, W, g).to(dev)
        off_w = (torch.randn(2 * P * P, P * P * C, generator=g) * 0.03).to(dev)
        off_b = (torch.randn(2 * P * P, generator=g) * 0.3).to(dev)
        geom, roi_h, roi_w, sub_h, sub_w = deform.pool_geometry(
            rois, P=P, S=S, M=M, spatial_scale=1 / 16)
        kw = dict(rois_per_image=rpi, P=P, S=S, M=M)
        pass1 = deform.pool_pass_plain(feat, geom, None, **kw)
        off = pass1.reshape(R, -1) @ off_w.t() + off_b
        pypx = deform.window_starts(off, roi_h, roi_w, sub_h, sub_w, P=P, S=S,
                                    M=M, trans_std=0.1)
        out.append((label, feat, geom, pypx,
                    dict(R=R, H=H, W=W, C=C, rpi=rpi, P=P, S=S, M=M)))
    return out


def run_pool(lib, inputs, reps):
    call = _entry(lib, "sniper_pool_pass", POOL_SIG)
    lines = []
    for label, feat, geom, pypx, d in inputs:
        out = torch.empty(d["R"], d["P"] ** 2, d["C"], device=feat.device)

        def run(bins):
            call(feat.data_ptr(), geom.data_ptr(),
                 None if bins is None else bins.data_ptr(), out.data_ptr(),
                 d["R"], d["H"], d["W"], d["C"], d["rpi"], d["P"], d["S"],
                 d["M"], int(bins is not None), stream())

        a_ms = time_ms(lambda: run(None), reps)
        b_ms = time_ms(lambda: run(pypx), reps)
        lines.append(f"[{label}]: pass A {a_ms:.4f} ms, pass B {b_ms:.4f} "
                     f"ms, both {a_ms + b_ms:.4f} ms")
    return lines


def pool_bwd_inputs(dev):
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


def run_pool_bwd(lib, inputs, reps):
    call = _entry(lib, "sniper_pool_pass_bwd", POOL_BWD_SIG)
    feat, geom, pypx, gout, d = inputs
    dfeat = torch.zeros_like(feat)
    dpp = torch.empty(d["R"], 2, d["P"] ** 2, device=feat.device)

    def run(bins):
        call(feat.data_ptr(), geom.data_ptr(),
             None if bins is None else bins.data_ptr(), gout.data_ptr(),
             dfeat.data_ptr(), None if bins is None else dpp.data_ptr(),
             d["R"], d["H"], d["W"], d["C"], d["rpi"], d["P"], d["S"],
             d["M"], stream())

    b_ms = time_ms(lambda: run(pypx), reps)
    a_ms = time_ms(lambda: run(None), reps)
    return [f"[training]: pass B {b_ms:.4f} ms, pass A {a_ms:.4f} ms, both "
            f"{b_ms + a_ms:.4f} ms"]


# (label, C, conv groups) of the C5 deformable conv: R101's and
# ResNeXt-101's (4 deformable groups each)
C5_WIDTHS = (("r101", 512, 1), ("x101", 2048, 64))


def im2col_bwd_inputs(dev):
    """chip_smoke.py:check_im2col_bwd's training inputs at both C5 widths:
    zero offsets, offsets of +-0.5 px and of +-6 px."""
    out = []
    for width, C, CG in C5_WIDTHS:
        B, H, W, G, K = 16, 32, 32, 4, 3
        g = torch.Generator().manual_seed(6)
        x = torch.randn(B, H, W, C, generator=g).to(dev, torch.bfloat16)
        gcol = torch.randn(B, H, W, K * K, C, generator=g).to(
            dev, torch.bfloat16)
        offs = []
        for label, scale in (("zero offsets", 0.0), ("offsets +-0.5 px", 0.5),
                             ("offsets +-6 px", 6.0)):
            offs.append((label, ((torch.rand(B, H, W, G * K * K * 2,
                                              generator=g) * 2 - 1)
                                  * scale).to(dev)))
        out.append((width, x, gcol, offs,
                    dict(B=B, H=H, W=W, C=C, G=G, K=K, d=2, CG=CG)))
    return out


def takes_conv_groups(text: str) -> bool:
    """Whether a version of an im2col source takes conv_groups (and
    reads or writes the col group-major)."""
    return "int conv_groups" in text


def wrapper_lines(inputs, reps):
    """The im2col backward wrapper's work around the kernel: zeroing the
    fp32 gx scratch and rounding it to bf16."""
    lines = []
    for width, x, _, _, _ in inputs:
        zero_ms = time_ms(lambda: torch.zeros(x.shape, device=x.device), reps)
        gx = torch.zeros(x.shape, device=x.device)
        cast_ms = time_ms(lambda: gx.to(torch.bfloat16), reps)
        lines.append(f"[{width} training]: zeroing the fp32 gx scratch "
                     f"{zero_ms:.4f} ms, its cast to bf16 {cast_ms:.4f} ms "
                     f"({gx.numel() * 4 / 1e6:.0f} MB)")
    return lines


def run_im2col_bwd(lib, inputs, reps, grouped):
    call = _entry(lib, "sniper_deform_im2col_bwd",
                  IM2COL_BWD_CG_SIG if grouped else IM2COL_BWD_SIG)
    lines = []
    for width, x, gcol, offs, d in inputs:
        gx = torch.zeros(x.shape, device=x.device)
        goff = torch.empty(offs[0][1].shape, device=x.device)
        nbytes = 2 * x.numel() * 2 + gcol.numel() * 2 + 2 * goff.numel() * 4
        cg = (d["CG"],) if grouped else ()
        for label, off in offs:
            ms = time_ms(lambda: call(
                x.data_ptr(), off.data_ptr(), gcol.data_ptr(), gx.data_ptr(),
                goff.data_ptr(), 1, d["B"], d["H"], d["W"], d["C"], d["G"],
                d["K"], d["d"], *cg, stream()), reps)
            lines.append(f"[{width} training, {label}]: {ms:.4f} ms, "
                         f"{nbytes / ms / 1e6:.1f} GB/s effective")
    return lines


def nms_inputs(dev, reps):
    """chip_smoke.py:check_nms's inputs at each shape and input kind: the
    sorted arrays, the identity order, the plain keep lists, a mask buffer
    each source's variants share (the full kernel's mask is what the scan
    alone reads), and the unsorted arrays with the sort's own time."""
    out = []
    N, thresh = 6000, 0.7
    for label, B, H, W, rpi in SHAPES:
        for kind in NMS_INPUTS:
            boxes, scores = nms_input(kind, B, N, H * 16, W * 16, 1)
            boxes, scores = boxes.to(dev), scores.to(dev)

            def sort(boxes=boxes, scores=scores, B=B):
                s_scores, order = torch.sort(scores, dim=1, descending=True,
                                             stable=True)
                return (torch.gather(boxes, 1,
                                     order[..., None].expand(B, N, 4)),
                        s_scores, order)

            s_boxes, s_scores, _ = sort()
            want = nms.nms_plain(s_boxes, s_scores, rpi, thresh)
            sort_ms = time_ms(sort, reps)
            # the scratch: the mask, then the scan state (1 + N rows of
            # stride words and 2 more per image)
            scratch = torch.empty(nms.scratch_words(B, N), dtype=torch.int64,
                                  device=dev)
            stride = (nms.scratch_words(1, N) - 2) // (N + 1)
            out.append(dict(
                label=f"{label}, {kind}", B=B, N=N, max_out=rpi,
                thresh=thresh, sort=sort, sort_ms=sort_ms, s_boxes=s_boxes,
                s_scores=s_scores, want=want,
                ident=torch.arange(N, device=dev).expand(B, N).contiguous(),
                mask=scratch, state=scratch[B * N * stride:],
                keep=torch.empty(B, rpi, dtype=torch.int32, device=dev),
                valid=torch.empty(B, rpi, dtype=torch.bool, device=dev)))
    return out


def run_nms(lib, inputs, reps, full):
    call = _entry(lib, "sniper_nms", NMS_SIG)
    lines = []
    for d in inputs:
        def launch(boxes, scores, order, d=d):
            call(boxes.data_ptr(), scores.data_ptr(), order.data_ptr(),
                 d["B"], d["N"], d["max_out"], d["thresh"], nms.NEG_INF / 2,
                 d["mask"].data_ptr(), d["keep"].data_ptr(),
                 d["valid"].data_ptr(), stream())

        def with_sort(d=d, launch=launch):
            launch(*d["sort"]())

        # a cleared scan state: without the scan, every range's mask rows
        # are computed (no image done, no box removed)
        d["state"].zero_()
        ms = time_ms(lambda: launch(d["s_boxes"], d["s_scores"], d["ident"]),
                     reps)
        check = ""
        if full:
            same = (torch.equal(d["keep"], d["want"][0])
                    and torch.equal(d["valid"], d["want"][1]))
            check = (f", keep lists {'identical to' if same else 'DIFFER from'}"
                     f" nms_plain ({int(d['want'][1].sum())} kept)")
        sort_ms = time_ms(with_sort, reps)
        lines.append(f"[{d['label']}]: kernel on sorted input {ms:.4f} ms, "
                     f"with the sort and gather {sort_ms:.4f} ms{check}")
    return lines


def run_im2col(lib, dev, reps, grouped):
    call = _entry(lib, "sniper_deform_im2col",
                  IM2COL_CG_SIG if grouped else IM2COL_SIG)
    lines = []
    shapes = [(f"r101 {label}", B, H, W, 512, 1)
              for label, B, H, W, _ in SHAPES]
    shapes += [(f"x101 {label}", B, H, W, 2048, 64)
               for label, B, H, W, _ in (SHAPES[0], SHAPES[3])]
    for label, B, H, W, C, CG in shapes:
        G, K, d = 4, 3, 2
        g = torch.Generator().manual_seed(2)
        x = torch.randn(B, H, W, C, generator=g).to(dev, torch.bfloat16)
        off = ((torch.rand(B, H, W, G * K * K * 2, generator=g) * 2 - 1)
               * 6.0).to(dev)
        col = torch.empty(B, H, W, K * K, C, device=dev, dtype=torch.bfloat16)
        cg = (CG,) if grouped else ()
        ms = time_ms(lambda: call(x.data_ptr(), off.data_ptr(),
                                  col.data_ptr(), 1, B, H, W, C, G, K, d,
                                  *cg, stream()), reps)
        nbytes = x.numel() * 2 + off.numel() * 4 + col.numel() * 2
        lines.append(f"[{label}]: {ms:.4f} ms, {nbytes / ms / 1e6:.1f} GB/s "
                     "effective")
        del x, col
    return lines


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pool", action="append", default=[])
    ap.add_argument("--pool-bwd", action="append", default=[])
    ap.add_argument("--im2col", action="append", default=[])
    ap.add_argument("--im2col-bwd", action="append", default=[])
    ap.add_argument("--nms", action="append", default=[])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=1,
                    help="time every version this many times, in turns: "
                         "the second round in reverse order")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_kernel_split: needs a CUDA device")
    if not (a.pool or a.pool_bwd or a.im2col or a.im2col_bwd or a.nms):
        a.pool = [os.path.join(CSRC, "fused_pool.cu")]
        a.pool_bwd = [os.path.join(CSRC, "fused_pool_bwd.cu")]
        a.im2col = [os.path.join(CSRC, "deform_im2col.cu")]
        a.im2col_bwd = [os.path.join(CSRC, "deform_im2col_bwd.cu")]
        a.nms = [os.path.join(CSRC, "nms.cu")]
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    jobs = []
    for kind, srcs in (("pool", a.pool), ("pool_bwd", a.pool_bwd),
                       ("im2col_bwd", a.im2col_bwd), ("nms", a.nms)):
        for src in srcs:
            with open(src) as f:
                jobs += [((kind, src, label), text)
                         for label, text in variants(kind, f.read())]
    for src in a.im2col:
        with open(src) as f:
            jobs.append((("im2col", src, "full"), f.read()))
    grouped = {key: takes_conv_groups(text) for key, text in jobs}
    inputs = {}
    if a.pool:
        inputs["pool"] = pool_inputs(dev)
    if a.pool_bwd:
        inputs["pool_bwd"] = pool_bwd_inputs(dev)
    if a.im2col_bwd:
        inputs["im2col_bwd"] = im2col_bwd_inputs(dev)
        for line in wrapper_lines(inputs["im2col_bwd"], a.reps):
            print(f"deform_im2col_bwd wrapper {line} [{card}]")
    if a.nms:
        inputs["nms"] = nms_inputs(dev, a.reps)
        for d in inputs["nms"]:
            print(f"nms sort and gather [{d['label']}]: {d['sort_ms']:.4f} "
                  f"ms [{card}]")
    names = {"pool": "fused_pool", "pool_bwd": "fused_pool_bwd",
             "im2col": "deform_im2col", "im2col_bwd": "deform_im2col_bwd",
             "nms": "nms"}
    with tempfile.TemporaryDirectory() as tmp:
        libs = list(build_all(jobs, tmp).items())
        for rnd in range(a.rounds):
            for (kind, src, label), lib in libs[::-1] if rnd % 2 else libs:
                key = (kind, src, label)
                if kind == "pool":
                    lines = run_pool(lib, inputs[kind], a.reps)
                elif kind == "pool_bwd":
                    lines = run_pool_bwd(lib, inputs[kind], a.reps)
                elif kind == "im2col_bwd":
                    lines = run_im2col_bwd(lib, inputs[kind], a.reps,
                                           grouped[key])
                elif kind == "nms":
                    lines = run_nms(lib, inputs[kind], a.reps,
                                    label == "full")
                else:
                    lines = run_im2col(lib, dev, a.reps, grouped[key])
                for line in lines:
                    print(f"{names[kind]} {src} [{label}] {line} "
                          f"(round {rnd + 1}) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
