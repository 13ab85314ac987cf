"""Build, load and account for the port's hand-written CUDA kernels.

The sources in ``sniper_tpu_torch/csrc/*.cu`` compile with nvcc for
``sm_90a``, one nvcc process per source started together, and link into ONE
shared library with a plain C interface, loaded with ctypes. The build runs
at first use, into ``build/sniper_tpu_torch/`` at the root of the checkout,
under a file name keyed by a hash of the sources, their headers and the
flags: a changed source rebuilds, an unchanged one loads at once. The
compiler's log (``-Xptxas -v``: registers, shared memory, spills per kernel)
is kept beside the library.

Every entry point takes device pointers and the CUDA stream as ``c_void_p``
and returns ``cudaGetLastError()`` after its launches; ``check`` raises on a
non-zero code. Nothing here runs at import: the CPU tests import every
module of the port on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sniper_tpu_torch"
# no --use_fast_math: the NMS and im2col geometry must round like the plain
# torch versions (IEEE division, no approximate transcendentals)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # boxes, scores, order, B, N, max_out, thresh, live_above, scratch,
    # keep, valid, stream
    "sniper_nms": [_P, _P, _P, _I, _I, _I, _F, _F, _P, _P, _P, _P],
    # x, offsets, col, dtype, B, H, W, C, G, K, dilation, conv_groups,
    # stream
    "sniper_deform_im2col": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P],
    # feat, geom, pypx, out, R, H, W, C, rpi, P, S, M, stencil, stream
    "sniper_pool_pass": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P],
    # x, offsets, gcol, gx, goff, dtype, B, H, W, C, G, K, dilation,
    # conv_groups, stream
    "sniper_deform_im2col_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _P],
    # feat, geom, pypx, g, dfeat, dpypx, R, H, W, C, rpi, P, S, M, stream
    "sniper_pool_pass_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _P],
    # feat, geom, out, dtype, H, W, C, rpi, r0, r1, E, stream
    "sniper_roi_patch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}


@dataclass
class Kernel:
    """One hand-written kernel: where it lives, what TPU kernel it
    replaces, and how often the path launched it. ``launches`` is bumped
    by the kernel's wrapper at each launch and nowhere else."""

    name: str
    source: str
    replaces: str
    launches: int = 0


NMS = Kernel(
    "nms", "sniper_tpu_torch/csrc/nms.cu",
    "sniper_tpu/ops/pallas/nms.py:83",
)
DEFORM_IM2COL = Kernel(
    "deform_im2col", "sniper_tpu_torch/csrc/deform_im2col.cu",
    "sniper_tpu/ops/deform.py:120",
)
FUSED_POOL = Kernel(
    "fused_pool", "sniper_tpu_torch/csrc/fused_pool.cu",
    "sniper_tpu/ops/pallas/fused_pool.py:191",
)
DEFORM_IM2COL_BWD = Kernel(
    "deform_im2col_bwd", "sniper_tpu_torch/csrc/deform_im2col_bwd.cu",
    "sniper_tpu/ops/deform.py:153",
)
POOL_BWD = Kernel(
    "fused_pool_bwd", "sniper_tpu_torch/csrc/fused_pool_bwd.cu",
    "sniper_tpu/ops/pallas/fused_pool.py:487",
)
ROI_PATCH = Kernel(
    "roi_patch", "sniper_tpu_torch/csrc/roi_patch.cu",
    "sniper_tpu/ops/pallas/roi_patch.py:101",
)
KERNELS = (NMS, DEFORM_IM2COL, FUSED_POOL, DEFORM_IM2COL_BWD, POOL_BWD,
           ROI_PATCH)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):  # the sources and their headers
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libsniper_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists: one
    nvcc per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in _sources():
            obj = Path(tmp) / f"{src.stem}.o"
            jobs.append((src, obj, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, proc in jobs:
            text = proc.communicate()[0]
            log.append(f"== {src.name}\n{text}")
            if proc.returncode:
                failed.append(f"{src.name} (code {proc.returncode}):\n{text}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        lib = Path(tmp) / out.name
        res = subprocess.run(
            [_nvcc(), "-shared", "-o", str(lib), *(str(o) for _, o, _ in jobs)],
            capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc link failed with code {res.returncode}:"
                               f"\n{res.stderr}")
        out.with_suffix(".log").write_text("\n".join(log))
        os.replace(lib, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sniper_error_string.argtypes = [_I]
    lib.sniper_error_string.restype = ctypes.c_char_p
    return lib


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(code: int, what: str) -> None:
    if code:
        msg = library().sniper_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def require(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype (and
    shape, where given; None entries match any size)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and (
        len(shape) != t.dim()
        or any(s is not None and s != d for s, d in zip(shape, t.shape))
    ):
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
