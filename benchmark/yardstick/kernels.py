"""The hand kernels' least times and the card's peaks: the numerators of
the ``*_roofline`` metrics and the denominators of the ``*_mfu`` ones.

Frozen copies of chip_smoke.py's ``bound()`` and of the bytes and fp32
operations it counts per kernel call (PR 4-16), and of the kernel-name
groups of scripts/profile_torch_infer.py and _train.py. The work is the
function's at the call's shapes, whatever kernel computes it, so a later
fusion or redesign reads the same bound.

Peaks: NVIDIA's H100 SXM data sheet, at the full 700 W power limit: HBM
3.35 TB/s, fp32 outside the tensor cores 67 TFLOP/s, dense bf16 989
TFLOP/s.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
PEAK_BF16 = {"H100 80GB HBM3": 989e12, "H100 SXM": 989e12}

# (metric kernel name, the substrings of its device kernels' names)
GROUPS = (
    ("fused_pool_bwd", ("pool_pass_bwd_kernel",)),
    ("deform_im2col_bwd", ("deform_im2col_bwd_kernel",)),
    ("fused_pool", ("pool_pass_kernel",)),
    ("deform_im2col", ("deform_im2col_kernel",)),
    ("nms", ("nms_mask_kernel", "nms_scan_kernel")),
    ("roi_patch", ("roi_patch_kernel",)),
    ("conv (cuDNN)", ("conv", "cudnn", "implicit", "xmma", "fprop", "dgrad",
                      "wgrad")),
    ("BatchNorm", ("batch_norm", "batchnorm", "bn_")),
    ("gemm (cuBLAS)", ("gemm", "cutlass", "sm90_")),
    ("optimizer (SGD)", ("multi_tensor", "foreach")),
    ("sort/topk", ("sort", "Sort", "radix", "topk")),
)
OTHER = "other (elementwise, reductions, copies)"


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return OTHER


def peak_bf16(device_name: str) -> float:
    for key, peak in PEAK_BF16.items():
        if key in device_name:
            return peak
    raise ValueError(f"no published bf16 peak for {device_name!r}")


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the fp32 operations over the fp32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def im2col(B, H, W, C, x_bytes=2, G=4, K=3):
    """X1 at x [B,H,W,C] (bf16): x and the offsets in, the col out; 7 fp32
    ops per (pixel, tap, channel)."""
    KK = K * K
    nbytes = B * H * W * C * x_bytes + B * H * W * G * KK * 2 * 4 \
        + B * H * W * KK * C * x_bytes
    return bound_s(nbytes, 7.0 * B * H * W * KK * C)


def im2col_bwd(B, H, W, C, x_bytes=2, G=4, K=3):
    """X2: x and gcol in, gx and goff out, the offsets in and goff out in
    fp32; ~20 fp32 ops per (pixel, tap, channel)."""
    KK = K * K
    off = B * H * W * G * KK * 2
    nbytes = 2 * B * H * W * C * x_bytes + B * H * W * KK * C * x_bytes \
        + 2 * off * 4
    return bound_s(nbytes, 20.0 * B * H * W * KK * C)


def pool(B, H, W, C, R, P=7, S=4):
    """P1/P2, both passes: each reads the map and the geometry (pass B
    also the window starts) and writes [R, P*P, C] fp32; 8 fp32 ops per
    sample, tap and channel."""
    nbytes = 2 * (B * H * W * C * 4 + R * 16 + R * P * P * C * 4) \
        + R * 2 * P * P * 4
    return bound_s(nbytes, 2 * 8.0 * R * P * P * S * S * C)


def pool_bwd(B, H, W, C, R, P=7, S=4):
    """P3, both transposed passes: the map, the geometry and g in, dfeat
    out (pass B also the window starts and their gradient); 16 + 8 fp32
    ops per sample, tap and channel."""
    nbytes = 2 * (2 * B * H * W * C * 4 + R * 16 + R * P * P * C * 4) \
        + 2 * R * 2 * P * P * 4
    return bound_s(nbytes, (16.0 + 8.0) * R * P * P * S * S * C)


def nms(B, N, max_out, kept):
    """P4: boxes and scores in, keep and valid out; ~14 fp32 ops for the
    IoU test of every kept box against every candidate."""
    return bound_s(B * N * 20 + B * max_out * 5, 14.0 * kept * N)
