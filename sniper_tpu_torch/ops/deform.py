"""Deformable convolution and the two-pass deformable PSROI pool, forward.

Port of sniper_tpu/ops/deform.py's inference path:

- ``deformable_conv`` (deform.py:237-286, ``conv_groups == 1``): DCNv1
  im2col with the JAX package's CLAMP border rule (``deform_im2col``; the
  CUDA kernel in csrc/deform_im2col.cu on CUDA tensors, its plain version
  on the CPU), then one ``torch.matmul`` with the kernel as
  [K*K*Cin, Cout].
- ``fused_offset_pool`` (deform.py:643-794, the einsum path's semantics)
  driven as sniper_tpu/ops/pallas/fused_pool.py:_forward_parts drives its
  kernel: pass A (undeformed interior bin average) -> offset FC as one
  matmul -> clipped per-bin window starts -> pass B (offset-shifted
  tent-stack pool). Each pass is ``pool_pass``: the CUDA kernel in
  csrc/fused_pool.cu on CUDA tensors, its plain version on the CPU.
- ``rcnn_head_fused`` (deform.py:797-841): the pool plus the FC stack.

All public arrays are NHWC, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from sniper_tpu_torch.ops import cuda

# ---------------------------------------------------------------------------
# deformable convolution
# ---------------------------------------------------------------------------


def deform_im2col_plain(x, offsets, *, num_groups, kernel_size, dilation):
    """x [B,H,W,C], offsets [B,H,W,G*K*K*2] -> col [B,H,W,K*K,C] in x's
    dtype. The sample geometry and the bilinear blend follow
    _make_im2col.fwd_impl; the blend runs in fp32 and rounds once."""
    B, H, W, C = x.shape
    G, K = num_groups, kernel_size
    KK = K * K
    cg = C // G
    half = (K - 1) // 2 * dilation
    dev = x.device
    off = offsets.float().reshape(B, H, W, G, KK, 2)
    taps = torch.arange(KK, device=dev)
    ty = ((taps // K) * dilation - half).float()  # [KK]
    tx = ((taps % K) * dilation - half).float()
    base_y = torch.arange(H, device=dev, dtype=torch.float32)
    base_x = torch.arange(W, device=dev, dtype=torch.float32)
    sy = (base_y[None, :, None, None, None] + ty) + off[..., 0]
    sx = (base_x[None, None, :, None, None] + tx) + off[..., 1]
    sy = sy.clamp(0.0, H - 1.0)
    sx = sx.clamp(0.0, W - 1.0)
    y0 = torch.floor(sy).long().clamp_max(H - 2)
    x0 = torch.floor(sx).long().clamp_max(W - 2)
    ly = (sy - y0.float())[..., None]
    lx = (sx - x0.float())[..., None]
    xg = x.float().reshape(B, H * W, G, cg)
    bi = torch.arange(B, device=dev)[:, None, None, None, None]
    gi = torch.arange(G, device=dev)[None, None, None, :, None]

    def corner(dy, dx):  # -> [B,H,W,G,KK,cg]
        return xg[bi, (y0 + dy) * W + (x0 + dx), gi]

    top = corner(0, 0) * (1 - lx) + corner(0, 1) * lx
    bot = corner(1, 0) * (1 - lx) + corner(1, 1) * lx
    col = top * (1 - ly) + bot * ly
    return col.permute(0, 1, 2, 4, 3, 5).reshape(B, H, W, KK, C).to(x.dtype)


_IM2COL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _deform_im2col_kernel(x, offsets, *, num_groups, kernel_size, dilation):
    B, H, W, C = x.shape
    G, K = num_groups, kernel_size
    if x.dtype not in _IM2COL_DTYPES:
        raise ValueError(f"deform_im2col takes float32 or bfloat16, got "
                         f"{x.dtype}")
    cuda.require(x, "x", x.dtype)
    cuda.require(offsets, "offsets", torch.float32, (B, H, W, G * K * K * 2))
    if C % G or H < 2 or W < 2:
        raise ValueError(f"deform_im2col needs C % G == 0 and H, W >= 2, "
                         f"got C={C}, G={G}, H={H}, W={W}")
    col = torch.empty((B, H, W, K * K, C), dtype=x.dtype, device=x.device)
    lib = cuda.library()
    cuda.DEFORM_IM2COL.launches += 1
    cuda.check(lib.sniper_deform_im2col(
        x.data_ptr(), offsets.data_ptr(), col.data_ptr(),
        _IM2COL_DTYPES[x.dtype], B, H, W, C, G, K, dilation,
        cuda.stream(x)), "deform_im2col")
    return col


def deform_im2col(x, offsets, *, num_groups=4, kernel_size=3, dilation=2):
    """DCNv1 im2col: x [B,H,W,C], offsets [B,H,W,G*K*K*2] fp32 ((dy, dx)
    per tap, group-major) -> col [B,H,W,K*K,C] in x's dtype."""
    kw = dict(num_groups=num_groups, kernel_size=kernel_size,
              dilation=dilation)
    if x.is_cuda:
        return _deform_im2col_kernel(x, offsets, **kw)
    return deform_im2col_plain(x, offsets, **kw)


def deformable_conv(x, offsets, weight, *, num_groups=4, kernel_size=3,
                    dilation=2):
    """DCNv1 convolution, stride 1, 'same' padding. x [B,H,W,Cin],
    offsets [B,H,W,G*K*K*2], weight [Cout,Cin,K,K] (OIHW). Returns
    [B,H,W,Cout] in x's dtype (the matmul accumulates in fp32)."""
    B, H, W, Cin = x.shape
    K = kernel_size
    col = deform_im2col(x, offsets, num_groups=num_groups, kernel_size=K,
                        dilation=dilation)
    w = weight.permute(2, 3, 1, 0).reshape(K * K * Cin, -1).to(x.dtype)
    return torch.matmul(col.reshape(B, H, W, K * K * Cin), w)


# ---------------------------------------------------------------------------
# two-pass deformable PSROI pool
# ---------------------------------------------------------------------------


def _roi_geom(crois, spatial_scale, T):
    """DCN roi decode: snap corners to pixels (round half to even, like
    jnp.round), scale, 0.1 min size. crois [..., 5] -> (x1, y1, roi_w,
    roi_h, sub_w, sub_h), each [...]."""
    x1 = torch.round(crois[..., 1]) * spatial_scale - 0.5
    y1 = torch.round(crois[..., 2]) * spatial_scale - 0.5
    x2 = (torch.round(crois[..., 3]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(crois[..., 4]) + 1.0) * spatial_scale - 0.5
    roi_w = (x2 - x1).clamp_min(0.1)
    roi_h = (y2 - y1).clamp_min(0.1)
    return x1, y1, roi_w, roi_h, roi_w / T, roi_h / T


def _resize_tents(start, step, n_out, n_in):
    """Per-roi dense 1-D resize tents [R, n_out, n_in] and in-bounds flags
    [R, n_out] (fp32): zero weight outside (-0.5, n_in-0.5), clamp inside
    to [0, n_in-1]."""
    o = torch.arange(n_out, device=start.device, dtype=torch.float32)
    pos = start[:, None] + o[None, :] * step[:, None]
    inb = ((pos > -0.5) & (pos < n_in - 0.5)).float()
    posc = pos.clamp(0.0, n_in - 1.0)
    cells = torch.arange(n_in, device=start.device, dtype=torch.float32)
    w = (1.0 - (posc[..., None] - cells).abs()).clamp_min(0.0)
    return w * inb[..., None], inb


def _avg_factors(P, S, M, E, device):
    """Interior-average factors [P*P, E] per axis: 1 iff the cell is one of
    bin p's S samples on that axis."""
    b = np.arange(P * P)
    cell = np.arange(E)
    ay = ((cell[None, :] >= M + (b[:, None] // P) * S)
          & (cell[None, :] < M + (b[:, None] // P + 1) * S))
    ax = ((cell[None, :] >= M + (b[:, None] % P) * S)
          & (cell[None, :] < M + (b[:, None] % P + 1) * S))
    return (torch.as_tensor(ay, dtype=torch.float32, device=device),
            torch.as_tensor(ax, dtype=torch.float32, device=device))


def _tent_stack(p0, S, E):
    """Offset-shifted S-tap tent stack: p0 [R, PP] window starts ->
    [R, PP, E] weights sum_k max(0, 1 - |p0 + k - e|)."""
    cell = torch.arange(E, device=p0.device, dtype=torch.float32)
    w = torch.zeros(p0.shape + (E,), device=p0.device)
    for k in range(S):
        w = w + (1.0 - (p0[..., None] + k - cell).abs()).clamp_min(0.0)
    return w


def pool_pass_plain(feat, geom, pypx, *, rois_per_image, P, S, M):
    """One pool pass, in the composed-tent form of the JAX kernel.

    feat [B,H,W,C] fp32; geom [R,4] = (ys, xs, sub_h, sub_w): the patch
    origin and sample spacing per roi; pypx None (pass A, interior average)
    or [R,2,P*P] clipped window starts (pass B). Returns [R, P*P, C] fp32.
    The map contraction runs 64 rois at a time, which bounds its
    [rois*P*P, H*C] intermediate (about 280 MB at C=256 and an 88x128 map).
    """
    B, H, W, C = feat.shape
    R = geom.shape[0]
    rpi = rois_per_image
    E = P * S + 2 * M
    wy, vy = _resize_tents(geom[:, 0], geom[:, 2], E, H)  # [R,E,H], [R,E]
    wx, vx = _resize_tents(geom[:, 1], geom[:, 3], E, W)
    if pypx is None:
        ay, ax = _avg_factors(P, S, M, E, feat.device)
        fy = ay.expand(R, -1, -1)
        fx = ax.expand(R, -1, -1)
    else:
        fy = _tent_stack(pypx[:, 0], S, E)
        fx = _tent_stack(pypx[:, 1], S, E)
    cy = fy @ wy  # [R,PP,H]
    cx = fx @ wx  # [R,PP,W]
    n = (fy * vy[:, None, :]).sum(-1) * (fx * vx[:, None, :]).sum(-1)
    numer = torch.empty((R, P * P, C), device=feat.device)
    for r0 in range(0, R, 64):
        r1 = min(R, r0 + 64)
        for b in range(r0 // rpi, (r1 - 1) // rpi + 1):
            lo, hi = max(r0, b * rpi), min(r1, (b + 1) * rpi)
            featt = feat[b].float().permute(1, 0, 2).reshape(W, H * C)
            tmp = (cx[lo:hi] @ featt).reshape(hi - lo, P * P, H, C)
            numer[lo:hi] = (tmp * cy[lo:hi, :, :, None]).sum(2)
    n = n[..., None]
    return torch.where(n > 0, numer / n.clamp_min(1.0), 0.0)


def _pool_pass_kernel(feat, geom, pypx, *, rois_per_image, P, S, M):
    B, H, W, C = feat.shape
    R = geom.shape[0]
    cuda.require(feat, "feat", torch.float32)
    cuda.require(geom, "geom", torch.float32, (B * rois_per_image, 4))
    if pypx is not None:
        cuda.require(pypx, "pypx", torch.float32, (R, 2, P * P))
    smem = P * P * (H + W + 1) * 4 + P * P * 16
    if smem > 227 * 1024:
        raise ValueError(f"pool_pass: a {H}x{W} map at P={P} needs {smem} B "
                         "of shared memory, more than a block has")
    out = torch.empty((R, P * P, C), dtype=torch.float32, device=feat.device)
    lib = cuda.library()
    cuda.FUSED_POOL.launches += 1
    cuda.check(lib.sniper_pool_pass(
        feat.data_ptr(), geom.data_ptr(),
        None if pypx is None else pypx.data_ptr(), out.data_ptr(),
        R, H, W, C, rois_per_image, P, S, M, int(pypx is not None),
        cuda.stream(feat)), "pool_pass")
    return out


def pool_pass(feat, geom, pypx, *, rois_per_image, P, S, M):
    """One pool pass (see pool_pass_plain): the CUDA kernel for CUDA
    tensors, the plain version on the CPU."""
    kw = dict(rois_per_image=rois_per_image, P=P, S=S, M=M)
    if feat.is_cuda:
        return _pool_pass_kernel(feat, geom, pypx, **kw)
    return pool_pass_plain(feat, geom, pypx, **kw)


def pool_geometry(rois, *, P, S, M, spatial_scale):
    """rois [R,5] -> (geom [R,4] = (ys, xs, sub_h, sub_w), roi_h, roi_w,
    sub_h, sub_w): the patch origin is the (0.5 - M)-th sub-sample cell."""
    x1, y1, roi_w, roi_h, sub_w, sub_h = _roi_geom(rois.float(),
                                                   spatial_scale, P * S)
    geom = torch.stack([y1 + (0.5 - M) * sub_h, x1 + (0.5 - M) * sub_w,
                        sub_h, sub_w], dim=-1)
    return geom.contiguous(), roi_h, roi_w, sub_h, sub_w


def window_starts(off, roi_h, roi_w, sub_h, sub_w, *, P, S, M, trans_std):
    """Offset-FC output [R, 2*P*P] (first P*P dy, then P*P dx) -> clipped
    per-bin window starts [R, 2, P*P] (fused_pool.py:_window_starts)."""
    R = off.shape[0]
    E = P * S + 2 * M
    dy = off[:, :P * P]
    dx = off[:, P * P:]
    p = torch.arange(P * P, device=off.device)
    base_y = (S * (p // P) + M).float()
    base_x = (S * (p % P) + M).float()
    raw_y = base_y + dy * trans_std * roi_h.reshape(R, 1) / sub_h.reshape(R, 1)
    raw_x = base_x + dx * trans_std * roi_w.reshape(R, 1) / sub_w.reshape(R, 1)
    hi = float(E - S)
    return torch.stack([raw_y.clamp(0.0, hi), raw_x.clamp(0.0, hi)],
                       dim=1).contiguous()


def fused_offset_pool(feat, rois, off_w, off_b, *, rois_per_image,
                      pooled_size=7, sample_per_part=4, spatial_scale=0.0625,
                      trans_std=0.1, margin_bins=1):
    """Two-pass deformable ROI pooling. feat [B,H,W,C] fp32,
    image-contiguous rois [B*rpi, 5], offset FC weight [2*P*P, P*P*C] and
    bias [2*P*P]. Returns pooled [B*rpi, P*P*C] fp32, bins p-major."""
    P, S = pooled_size, sample_per_part
    M = margin_bins * S
    R = rois.shape[0]
    feat = feat.float().contiguous()
    geom, roi_h, roi_w, sub_h, sub_w = pool_geometry(
        rois, P=P, S=S, M=M, spatial_scale=spatial_scale)
    kw = dict(rois_per_image=rois_per_image, P=P, S=S, M=M)
    pass1 = pool_pass(feat, geom, None, **kw)
    off = pass1.reshape(R, -1) @ off_w.t() + off_b  # [R, 2*P*P]
    pypx = window_starts(off, roi_h, roi_w, sub_h, sub_w, P=P, S=S, M=M,
                         trans_std=trans_std)
    return pool_pass(feat, geom, pypx, **kw).reshape(R, -1)


def rcnn_head_fused(feat, rois, head_params, *, rois_per_image,
                    pooled_size=7, sample_per_part=4, spatial_scale=0.0625,
                    trans_std=0.1, margin_bins=1):
    """fused_offset_pool + the R-CNN FC stack. ``head_params`` is
    ((off_w, off_b), (fc1_w, fc1_b), (fc2_w, fc2_b), (cls_w, cls_b),
    (bbox_w, bbox_b)), weights [out, in]. Returns (cls_score [R, classes],
    bbox_pred [R, 4]) fp32."""
    (off_w, off_b), fc1, fc2, cls, bbox = head_params
    pooled = fused_offset_pool(
        feat, rois, off_w, off_b, rois_per_image=rois_per_image,
        pooled_size=pooled_size, sample_per_part=sample_per_part,
        spatial_scale=spatial_scale, trans_std=trans_std,
        margin_bins=margin_bins)
    h = torch.relu(torch.nn.functional.linear(pooled, *fc1))
    h = torch.relu(torch.nn.functional.linear(h, *fc2))
    return (torch.nn.functional.linear(h, *cls),
            torch.nn.functional.linear(h, *bbox))
