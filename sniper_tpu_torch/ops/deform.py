"""Deformable convolution and the two-pass deformable PSROI pool, forward
and backward.

Port of sniper_tpu/ops/deform.py and sniper_tpu/ops/pallas/fused_pool.py:

- ``deformable_conv`` (deform.py:237-286): DCNv1 im2col with the JAX
  package's CLAMP border rule, then one ``torch.matmul`` with the kernel as
  [K*K*Cin, Cout], or with ``conv_groups > 1`` (ResNeXt's C5) one
  ``torch.bmm`` over the col as the im2col writes it, group-major
  [CG, B*H*W, K*K*cg_in] (JAX's ``col_g`` with the groups outermost), with
  no copy before the product nor of its input gradient. The im2col is
  ``DeformIm2col``, the counterpart of ``_make_im2col``'s custom VJP: its
  forward is ``deform_im2col`` (the CUDA kernel in csrc/deform_im2col.cu on
  CUDA tensors, the plain version on the CPU) and its backward
  ``deform_im2col_bwd`` (csrc/deform_im2col_bwd.cu, or the plain version).
  The weight gradient and gcol = gout @ W^T come from the product's own
  autograd, as the JAX package leaves that product to XLA.
- ``fused_offset_pool`` (deform.py:643-794 with fused_pool.py's composed
  form): ``FusedOffsetPool``, the counterpart of ``_make_fused_pool_vjp``.
  Forward: pass A (undeformed interior bin average) -> offset FC as one
  matmul -> clipped per-bin window starts -> pass B (offset-shifted
  tent-stack pool); each pass is ``pool_pass`` (csrc/fused_pool.cu, or the
  plain version). Backward: transposed pass B (dfeat and the window-start
  gradient) -> the clip masks -> the offset-FC transpose times
  ``OFFSET_GRAD_MULT`` -> transposed pass A; each transposed pass is
  ``pool_pass_bwd`` (csrc/fused_pool_bwd.cu, or the plain version). The
  box head pools at P=7 and the mask branch at P=14, both ways.
- ``rcnn_head_fused`` (deform.py:797-841): the pool plus the FC stack.
- ``patch_offset_pool`` (deform.py:743-794, ``fused_offset_pool`` with
  ``extract="einsum"``): the patch route of the same two-pass pool, the JAX
  mask branch's route, kept as a second reference for the 14x14 pool (no
  caller on the detector's paths). Each roi's (T+2M)^2 patch is extracted
  once by ``extract_patches`` (csrc/roi_patch.cu, the counterpart of
  pallas/roi_patch.py, or the plain version), then ``tiled_bin_avg``
  (pass 1 on the central T x T cells) -> offset FC -> ``stencil_pool``
  (the offset-shifted tent stack as one dense product per roi). Forward
  only.

The plain backwards are written out as the JAX backward is, not derived by
autograd: the zeros-initialized offset FC and C5 offset convs put every
window start and every DCN sample on an integer at step 1, exactly on the
kinks, and there the JAX conventions hold (``jnp.abs'(0) = +1``,
``jnp.maximum`` and ``jnp.clip`` split ties in half, the DCN positional
gradient is zero on the clamped border), where torch's autograd gives
``abs'(0) = 0`` and passes a clamp's whole gradient at the bound.

All public arrays are NHWC, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from sniper_tpu_torch.ops import cuda

# the offset FC's gradient scale inside the pool's backward: the reference's
# lr_mult of 0.01 on that layer, so one learning rate serves every parameter
OFFSET_GRAD_MULT = 0.01
# rois per chunk of the patch route: at P=14 a roi's fp32 patch is
# E*E*C*4 B (4.2 MB at E=64, C=256) and its stencil weights P*P*E*E*4 B
# (3.2 MB), so a chunk holds about 470 MB
PATCH_ROI_CHUNK = 64

# ---------------------------------------------------------------------------
# deformable convolution
# ---------------------------------------------------------------------------


def col_shape(x_shape, kernel_size, conv_groups):
    """The im2col's layout for x [B,H,W,C]: group-major over the conv's
    groups, [CG, B*H*W, K*K*C/CG] (channel c = g*cg_in + ci of pixel p, tap
    t at ((g*B*H*W + p)*K*K + t)*cg_in + ci), which for one group is
    [B,H,W,K*K,C] and is given that shape."""
    B, H, W, C = x_shape
    KK = kernel_size * kernel_size
    if conv_groups == 1:
        return (B, H, W, KK, C)
    return (conv_groups, B * H * W, KK * (C // conv_groups))


def _group_major(col, conv_groups):
    """col [B,H,W,K*K,C] copied group-major (``col_shape``; JAX's
    ``col_g``, deform.py:270-278, with the groups outermost)."""
    B, H, W, KK, C = col.shape
    if conv_groups == 1:
        return col
    cg_in = C // conv_groups
    return (col.reshape(B * H * W, KK, conv_groups, cg_in).permute(2, 0, 1, 3)
            .reshape(conv_groups, B * H * W, KK * cg_in))


def _group_minor(col, x_shape, conv_groups):
    """A group-major col (``col_shape``) back to [B,H,W,K*K,C]."""
    if conv_groups == 1:
        return col
    B, H, W, C = x_shape
    return (col.reshape(conv_groups, B * H * W, -1, C // conv_groups)
            .permute(1, 2, 0, 3).reshape(B, H, W, -1, C))


def deform_im2col_plain(x, offsets, *, num_groups, kernel_size, dilation,
                        conv_groups=1):
    """x [B,H,W,C], offsets [B,H,W,G*K*K*2] -> the col in x's dtype, group-
    major over ``conv_groups`` (``col_shape``). The sample geometry and the
    bilinear blend follow _make_im2col.fwd_impl; the blend runs in fp32 and
    rounds once."""
    B, H, W, C = x.shape
    G, K = num_groups, kernel_size
    KK = K * K
    cg = C // G
    _, _, y0, x0, ly, lx = _im2col_geometry(offsets, B, H, W, G, K, dilation)
    ly, lx = ly[..., None], lx[..., None]
    xg = x.float().reshape(B, H * W, G, cg)
    bi = torch.arange(B, device=x.device)[:, None, None, None, None]
    gi = torch.arange(G, device=x.device)[None, None, None, :, None]

    def corner(dy, dx):  # -> [B,H,W,G,KK,cg]
        return xg[bi, (y0 + dy) * W + (x0 + dx), gi]

    top = corner(0, 0) * (1 - lx) + corner(0, 1) * lx
    bot = corner(1, 0) * (1 - lx) + corner(1, 1) * lx
    col = top * (1 - ly) + bot * ly
    col = col.permute(0, 1, 2, 4, 3, 5).reshape(B, H, W, KK, C).to(x.dtype)
    return _group_major(col, conv_groups).contiguous()


_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _require_im2col(what, x, offsets, G, K, CG):
    """Raise unless the im2col kernels take x and the offsets."""
    B, H, W, C = x.shape
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{what} takes float32 or bfloat16, got {x.dtype}")
    cuda.require(x, "x", x.dtype)
    cuda.require(offsets, "offsets", torch.float32, (B, H, W, G * K * K * 2))
    if C % G or C % CG or H < 2 or W < 2:
        raise ValueError(f"{what} needs C % G == 0, C % conv_groups == 0 and "
                         f"H, W >= 2, got C={C}, G={G}, conv_groups={CG}, "
                         f"H={H}, W={W}")


def _deform_im2col_kernel(x, offsets, *, num_groups, kernel_size, dilation,
                          conv_groups):
    B, H, W, C = x.shape
    G, K, CG = num_groups, kernel_size, conv_groups
    _require_im2col("deform_im2col", x, offsets, G, K, CG)
    col = torch.empty(col_shape(x.shape, K, CG), dtype=x.dtype,
                      device=x.device)
    lib = cuda.library()
    cuda.DEFORM_IM2COL.launches += 1
    cuda.check(lib.sniper_deform_im2col(
        x.data_ptr(), offsets.data_ptr(), col.data_ptr(),
        _KERNEL_DTYPES[x.dtype], B, H, W, C, G, K, dilation, CG,
        cuda.stream(x)), "deform_im2col")
    return col


def deform_im2col(x, offsets, *, num_groups=4, kernel_size=3, dilation=2,
                  conv_groups=1):
    """DCNv1 im2col: x [B,H,W,C], offsets [B,H,W,G*K*K*2] fp32 ((dy, dx)
    per tap, group-major) -> the col in x's dtype, group-major over the
    conv's ``conv_groups`` (``col_shape``: [B,H,W,K*K,C] for one group)."""
    kw = dict(num_groups=num_groups, kernel_size=kernel_size,
              dilation=dilation, conv_groups=conv_groups)
    if x.is_cuda:
        return _deform_im2col_kernel(x, offsets, **kw)
    return deform_im2col_plain(x, offsets, **kw)


def _im2col_geometry(offsets, B, H, W, G, K, dilation):
    """The forward's sample geometry: clamped (sy, sx), the corner (y0, x0)
    and the blend weights (ly, lx), each [B,H,W,G,K*K]."""
    half = (K - 1) // 2 * dilation
    dev = offsets.device
    off = offsets.float().reshape(B, H, W, G, K * K, 2)
    taps = torch.arange(K * K, device=dev)
    ty = ((taps // K) * dilation - half).float()
    tx = ((taps % K) * dilation - half).float()
    base_y = torch.arange(H, device=dev, dtype=torch.float32)
    base_x = torch.arange(W, device=dev, dtype=torch.float32)
    sy = ((base_y[None, :, None, None, None] + ty) + off[..., 0]).clamp(
        0.0, H - 1.0)
    sx = ((base_x[None, None, :, None, None] + tx) + off[..., 1]).clamp(
        0.0, W - 1.0)
    y0 = torch.floor(sy).long().clamp_max(H - 2)
    x0 = torch.floor(sx).long().clamp_max(W - 2)
    return sy, sx, y0, x0, sy - y0.float(), sx - x0.float()


def deform_im2col_bwd_plain(x, offsets, gcol, *, num_groups, kernel_size,
                            dilation, conv_groups=1):
    """The im2col's VJP, written out as _make_im2col.im2col_bwd is: gcol in
    the forward's layout (``col_shape``) -> (gx [B,H,W,C] in x's dtype,
    summed in fp32 and rounded once; goff [B,H,W,G*K*K*2] fp32). gx
    scatters each sample's gradient to its four corners with weights wy*wx;
    goff reduces gcol * d(sample)/d(sy, sx) over each group's channels, and
    is zero where the clamped sample sits on the border (strictly inside
    only, as :220-228). ``conv_groups`` names gcol's layout only."""
    B, H, W, C = x.shape
    G, K = num_groups, kernel_size
    KK = K * K
    cg = C // G
    sy, sx, y0, x0, ly, lx = _im2col_geometry(offsets, B, H, W, G, K,
                                              dilation)
    gcol = _group_minor(gcol, x.shape, conv_groups)
    gq = gcol.float().reshape(B, H, W, KK, G, cg).permute(0, 1, 2, 4, 3, 5)
    ly, lx = ly[..., None], lx[..., None]
    xg = x.float().reshape(B, H * W, G, cg)
    bi = torch.arange(B, device=x.device)[:, None, None, None, None]
    gi = torch.arange(G, device=x.device)[None, None, None, :, None]
    gx = torch.zeros(B * H * W * G, cg, device=x.device)
    v = {}
    for dy, wy in ((0, 1 - ly), (1, ly)):
        for dx, wx in ((0, 1 - lx), (1, lx)):
            pix = (y0 + dy) * W + (x0 + dx)  # [B,H,W,G,KK]
            v[dy, dx] = xg[bi, pix, gi]
            row = ((bi * (H * W) + pix) * G + gi).reshape(-1)
            gx.index_add_(0, row, ((wy * wx) * gq).reshape(-1, cg))
    dvy = (v[1, 0] - v[0, 0]) * (1 - lx) + (v[1, 1] - v[0, 1]) * lx
    dvx = (v[0, 1] - v[0, 0]) * (1 - ly) + (v[1, 1] - v[1, 0]) * ly
    my = ((sy > 0.0) & (sy < H - 1.0)).float()
    mx = ((sx > 0.0) & (sx < W - 1.0)).float()
    goff = torch.stack([(gq * dvy).sum(-1) * my, (gq * dvx).sum(-1) * mx],
                       dim=-1)
    return (gx.reshape(B, H, W, C).to(x.dtype),
            goff.reshape(B, H, W, G * KK * 2))


def _deform_im2col_bwd_kernel(x, offsets, gcol, *, num_groups, kernel_size,
                              dilation, conv_groups):
    B, H, W, C = x.shape
    G, K, CG = num_groups, kernel_size, conv_groups
    _require_im2col("deform_im2col_bwd", x, offsets, G, K, CG)
    cuda.require(gcol, "gcol", x.dtype, col_shape(x.shape, K, CG))
    gx = torch.zeros((B, H, W, C), dtype=torch.float32, device=x.device)
    goff = torch.empty((B, H, W, G * K * K * 2), dtype=torch.float32,
                       device=x.device)
    lib = cuda.library()
    cuda.DEFORM_IM2COL_BWD.launches += 1
    cuda.check(lib.sniper_deform_im2col_bwd(
        x.data_ptr(), offsets.data_ptr(), gcol.data_ptr(), gx.data_ptr(),
        goff.data_ptr(), _KERNEL_DTYPES[x.dtype], B, H, W, C, G, K, dilation,
        CG, cuda.stream(x)), "deform_im2col_bwd")
    return gx.to(x.dtype), goff


def deform_im2col_bwd(x, offsets, gcol, *, num_groups=4, kernel_size=3,
                      dilation=2, conv_groups=1):
    """The im2col's VJP (see deform_im2col_bwd_plain), gcol group-major
    over ``conv_groups``: the CUDA kernel for CUDA tensors, the plain
    version on the CPU."""
    kw = dict(num_groups=num_groups, kernel_size=kernel_size,
              dilation=dilation, conv_groups=conv_groups)
    if x.is_cuda:
        return _deform_im2col_bwd_kernel(x, offsets, gcol, **kw)
    return deform_im2col_bwd_plain(x, offsets, gcol, **kw)


class DeformIm2col(torch.autograd.Function):
    """deform_im2col with the JAX package's hand-written VJP. Residuals:
    x and the offsets."""

    @staticmethod
    def forward(ctx, x, offsets, num_groups, kernel_size, dilation,
                conv_groups=1):
        ctx.kw = dict(num_groups=num_groups, kernel_size=kernel_size,
                      dilation=dilation, conv_groups=conv_groups)
        ctx.save_for_backward(x, offsets)
        return deform_im2col(x, offsets, **ctx.kw)

    @staticmethod
    def backward(ctx, gcol):
        x, offsets = ctx.saved_tensors
        gx, goff = deform_im2col_bwd(x, offsets, gcol.contiguous(), **ctx.kw)
        return gx, goff, None, None, None, None


def grouped_product(col, weight, batch_shape):
    """The grouped convolution over the deformed taps (deform.py:262-286):
    the group-major col [CG, B*H*W, K*K*cg_in] as the im2col writes it,
    times the OIHW weight [Cout, cg_in, K, K] as [CG, K*K*cg_in, cg_out], in
    one torch.bmm. Returns [*batch_shape, Cout] (batch_shape = (B, H, W))
    in col's dtype."""
    CG = col.shape[0]
    cout, cg_in, K = weight.shape[0], weight.shape[1], weight.shape[2]
    cg_out = cout // CG
    w_g = (weight.reshape(CG, cg_out, cg_in, K, K).permute(0, 3, 4, 2, 1)
           .reshape(CG, K * K * cg_in, cg_out).to(col.dtype))
    out = torch.bmm(col, w_g)  # [CG, B*H*W, cg_out]
    return out.permute(1, 0, 2).reshape(*batch_shape, cout)


def deformable_conv(x, offsets, weight, *, num_groups=4, kernel_size=3,
                    dilation=2, conv_groups=1):
    """DCNv1 convolution, stride 1, 'same' padding. x [B,H,W,Cin],
    offsets [B,H,W,G*K*K*2], weight [Cout,Cin/conv_groups,K,K] (OIHW).
    Returns [B,H,W,Cout] in x's dtype (the products accumulate in fp32).

    ``conv_groups > 1`` is the grouped convolution over the deformed taps
    (ResNeXt's C5): the im2col stays one over all Cin channels and writes
    its col group-major, then ``grouped_product``."""
    B, H, W, Cin = x.shape
    K = kernel_size
    KK = K * K
    col = DeformIm2col.apply(x, offsets, num_groups, K, dilation,
                             conv_groups)
    if conv_groups == 1:
        w = weight.permute(2, 3, 1, 0).reshape(KK * Cin, -1).to(x.dtype)
        return torch.matmul(col.reshape(B, H, W, KK * Cin), w)
    return grouped_product(col, weight, (B, H, W))


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


def _tent_stack_pair(p0, S, E):
    """The tent stack and its derivative in the window start p0, each
    [R, PP, E], with fused_pool.py:_tent_stack_pair's conventions at the
    kinks: abs'(0) = +1, and a tent's edge |d| == 1 carries half (the
    jnp.maximum tie)."""
    cell = torch.arange(E, device=p0.device, dtype=torch.float32)
    w = torch.zeros(p0.shape + (E,), device=p0.device)
    dw = torch.zeros_like(w)
    for k in range(S):
        d = p0[..., None] + k - cell
        ad = d.abs()
        w = w + (1.0 - ad).clamp_min(0.0)
        gate = (ad < 1.0).float() + 0.5 * (ad == 1.0).float()
        dw = dw - torch.where(d >= 0, 1.0, -1.0) * gate
    return w, dw


def _image_chunks(R, rpi, size=64, start=0):
    """(image, first roi, end roi) blocks of at most ``size`` rois of
    [start, R) that do not cross an image."""
    for r0 in range(start, R, size):
        r1 = min(R, r0 + size)
        for b in range(r0 // rpi, (r1 - 1) // rpi + 1):
            yield b, max(r0, b * rpi), min(r1, (b + 1) * rpi)


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
    for b, lo, hi in _image_chunks(R, rpi):
        featt = feat[b].float().permute(1, 0, 2).reshape(W, H * C)
        tmp = (cx[lo:hi] @ featt).reshape(hi - lo, P * P, H, C)
        numer[lo:hi] = (tmp * cy[lo:hi, :, :, None]).sum(2)
    n = n[..., None]
    return torch.where(n > 0, numer / n.clamp_min(1.0), 0.0)


def pool_smem_bytes(P, S):
    """Shared memory of one roi's block of csrc/fused_pool.cu (``smem_bytes``
    there): per bin and axis, a list of at most 2(S+1) (map cell, weight)
    pairs, its length and its count. It does not depend on the map."""
    return 2 * P * P * (2 * (S + 1) * 8 + 8)


def _pool_pass_kernel(feat, geom, pypx, *, rois_per_image, P, S, M):
    B, H, W, C = feat.shape
    R = geom.shape[0]
    cuda.require(feat, "feat", torch.float32)
    cuda.require(geom, "geom", torch.float32, (B * rois_per_image, 4))
    if pypx is not None:
        cuda.require(pypx, "pypx", torch.float32, (R, 2, P * P))
    smem = pool_smem_bytes(P, S)
    if smem > 227 * 1024:
        raise ValueError(f"pool_pass: P={P}, S={S} needs {smem} B of shared "
                         "memory, more than a block has")
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


def pool_pass_bwd_plain(feat, geom, pypx, g, *, rois_per_image, P, S, M,
                        dfeat=None):
    """The transposed pool pass, written out as fused_pool.py's
    _pool_bwd_kernel is.

    g [R, P*P, C] is the pass's output cotangent. Adds to ``dfeat``
    [B,H,W,C] fp32 (zeros when None) the feature gradient
    sum_p cy[p,h] cx[p,w] dnum[p,c], dnum = g / max(n, 1) where n > 0.
    Pass B (pypx given) also returns the window-start gradient [R,2,P*P]:
    the tent-stack derivative against d(cy) = dnum . (cx feat) and d(cx) =
    (cy dnum) . feat, plus the count denominator's term, which is zero for
    n < 1 (max(n, 1) picks the constant) and half at the n == 1.0 tie.
    Returns (dfeat, dpypx or None)."""
    B, H, W, C = feat.shape
    R = geom.shape[0]
    rpi = rois_per_image
    PP = P * P
    E = P * S + 2 * M
    wy, vy = _resize_tents(geom[:, 0], geom[:, 2], E, H)  # [R,E,H], [R,E]
    wx, vx = _resize_tents(geom[:, 1], geom[:, 3], E, W)
    stencil = pypx is not None
    if stencil:
        fy, dfy_dp = _tent_stack_pair(pypx[:, 0], S, E)
        fx, dfx_dp = _tent_stack_pair(pypx[:, 1], S, E)
    else:
        ay, ax = _avg_factors(P, S, M, E, feat.device)
        fy, fx = ay.expand(R, -1, -1), ax.expand(R, -1, -1)
    cy = fy @ wy  # [R,PP,H]
    cx = fx @ wx  # [R,PP,W]
    sy = (fy * vy[:, None, :]).sum(-1)  # [R,PP]
    sx = (fx * vx[:, None, :]).sum(-1)
    n = sy * sx
    pos = n > 0
    den = n.clamp_min(1.0)
    dnum = torch.where(pos[..., None], g / den[..., None], 0.0)
    if dfeat is None:
        dfeat = torch.zeros((B, H, W, C), device=feat.device)
    if stencil:
        numer = torch.empty((R, PP, C), device=feat.device)
        dcy = torch.empty((R, PP, H), device=feat.device)
        dcx = torch.empty((R, PP, W), device=feat.device)
    for b, lo, hi in _image_chunks(R, rpi):
        featt = feat[b].float().permute(1, 0, 2).reshape(W, H * C)
        gg = cy[lo:hi, :, :, None] * dnum[lo:hi, :, None, :]  # [n,PP,H,C]
        gg = gg.reshape(-1, H * C)
        contrib = cx[lo:hi].reshape(-1, W).t() @ gg  # [W, H*C]
        dfeat[b] += contrib.reshape(W, H, C).permute(1, 0, 2)
        if stencil:
            big = (cx[lo:hi] @ featt).reshape(hi - lo, PP, H, C)
            numer[lo:hi] = (big * cy[lo:hi, :, :, None]).sum(2)
            dcy[lo:hi] = (dnum[lo:hi, :, None, :] * big).sum(-1)
            dcx[lo:hi] = (gg @ featt.t()).reshape(hi - lo, PP, W)
    if not stencil:
        return dfeat, None
    tie = torch.where(n == 1.0, 0.5, 1.0)
    dn = torch.where(pos & (n >= 1.0),
                     -tie * (g * numer).sum(-1) / (den * den), 0.0)
    dfy = dcy @ wy.transpose(1, 2) + (dn * sx)[..., None] * vy[:, None, :]
    dfx = dcx @ wx.transpose(1, 2) + (dn * sy)[..., None] * vx[:, None, :]
    dpp = torch.stack([(dfy * dfy_dp).sum(-1), (dfx * dfx_dp).sum(-1)],
                      dim=1)
    return dfeat, dpp


def pool_bwd_smem_bytes(H, W, P):
    """Shared memory of one roi's block of csrc/fused_pool_bwd.cu
    (``smem_bytes`` there): a row and a column mask of the P*P bins in
    64-bit words, cy, cx and their gradients [P*P, H or W], four floats and
    eight window bounds per bin, and the footprint box."""
    PP = P * P
    words = (PP + 63) // 64
    return (H + W) * words * 8 + PP * (2 * (H + W) + 4) * 4 + PP * 32 + 16


def _pool_pass_bwd_kernel(feat, geom, pypx, g, *, rois_per_image, P, S, M,
                          dfeat=None):
    B, H, W, C = feat.shape
    R = geom.shape[0]
    PP = P * P
    cuda.require(feat, "feat", torch.float32)
    cuda.require(geom, "geom", torch.float32, (B * rois_per_image, 4))
    cuda.require(g, "g", torch.float32, (R, PP, C))
    if pypx is not None:
        cuda.require(pypx, "pypx", torch.float32, (R, 2, PP))
    smem = pool_bwd_smem_bytes(H, W, P)
    if smem > 227 * 1024:
        raise ValueError(f"pool_pass_bwd: a {H}x{W} map at P={P} needs "
                         f"{smem} B of shared memory, more than a block has")
    if dfeat is None:
        dfeat = torch.zeros((B, H, W, C), dtype=torch.float32,
                            device=feat.device)
    else:
        cuda.require(dfeat, "dfeat", torch.float32, (B, H, W, C))
    dpp = (None if pypx is None else
           torch.empty((R, 2, PP), dtype=torch.float32, device=feat.device))
    lib = cuda.library()
    cuda.POOL_BWD.launches += 1
    cuda.check(lib.sniper_pool_pass_bwd(
        feat.data_ptr(), geom.data_ptr(),
        None if pypx is None else pypx.data_ptr(), g.data_ptr(),
        dfeat.data_ptr(), None if dpp is None else dpp.data_ptr(),
        R, H, W, C, rois_per_image, P, S, M, cuda.stream(feat)),
        "pool_pass_bwd")
    return dfeat, dpp


def pool_pass_bwd(feat, geom, pypx, g, *, rois_per_image, P, S, M,
                  dfeat=None):
    """The transposed pool pass (see pool_pass_bwd_plain): the CUDA kernel
    for CUDA tensors, the plain version on the CPU."""
    kw = dict(rois_per_image=rois_per_image, P=P, S=S, M=M, dfeat=dfeat)
    if feat.is_cuda:
        return _pool_pass_bwd_kernel(feat, geom, pypx, g, **kw)
    return pool_pass_bwd_plain(feat, geom, pypx, g, **kw)


def pool_geometry(rois, *, P, S, M, spatial_scale):
    """rois [R,5] -> (geom [R,4] = (ys, xs, sub_h, sub_w), roi_h, roi_w,
    sub_h, sub_w): the patch origin is the (0.5 - M)-th sub-sample cell."""
    x1, y1, roi_w, roi_h, sub_w, sub_h = _roi_geom(rois.float(),
                                                   spatial_scale, P * S)
    geom = torch.stack([y1 + (0.5 - M) * sub_h, x1 + (0.5 - M) * sub_w,
                        sub_h, sub_w], dim=-1)
    return geom.contiguous(), roi_h, roi_w, sub_h, sub_w


def _window_raw(off, roi_h, roi_w, sub_h, sub_w, *, P, S, M, trans_std):
    """Offset-FC output [R, 2*P*P] (first P*P dy, then P*P dx) -> the
    unclipped per-bin window starts (raw_y, raw_x), each [R, P*P]."""
    R = off.shape[0]
    dy = off[:, :P * P]
    dx = off[:, P * P:]
    p = torch.arange(P * P, device=off.device)
    base_y = (S * (p // P) + M).float()
    base_x = (S * (p % P) + M).float()
    raw_y = base_y + dy * trans_std * roi_h.reshape(R, 1) / sub_h.reshape(R, 1)
    raw_x = base_x + dx * trans_std * roi_w.reshape(R, 1) / sub_w.reshape(R, 1)
    return raw_y, raw_x


def _rail(P, S, M):
    """The last window start in the patch, E - S."""
    return float(P * S + 2 * M - S)


def _clip_starts(raw_y, raw_x, hi):
    return torch.stack([raw_y.clamp(0.0, hi), raw_x.clamp(0.0, hi)],
                       dim=1).contiguous()


def window_starts(off, roi_h, roi_w, sub_h, sub_w, *, P, S, M, trans_std):
    """Offset-FC output [R, 2*P*P] -> clipped per-bin window starts
    [R, 2, P*P] (fused_pool.py:_window_starts)."""
    raw_y, raw_x = _window_raw(off, roi_h, roi_w, sub_h, sub_w, P=P, S=S,
                               M=M, trans_std=trans_std)
    return _clip_starts(raw_y, raw_x, _rail(P, S, M))


def _clip_mask(raw, hi):
    """jnp.clip's subgradient: 1 strictly inside, 0 outside, 0.5 at a rail
    (jnp.maximum and jnp.minimum split ties in half)."""
    inside = (raw > 0.0) & (raw < hi)
    at_rail = (raw == 0.0) | (raw == hi)
    return inside.float() + 0.5 * at_rail.float()


class FusedOffsetPool(torch.autograd.Function):
    """The two-pass pool with _make_fused_pool_vjp's backward. Residuals:
    feat, rois, the offset FC and pass A's output. Returns (pooled
    [R, P*P*C], the raw offset-FC output [R, 2*P*P]); the second output is
    telemetry and carries no gradient. rois get none (the roi snapping's
    round() has zero gradient)."""

    @staticmethod
    def forward(ctx, feat, rois, off_w, off_b, statics):
        rpi, P, S, M, spatial_scale, trans_std = statics
        R = rois.shape[0]
        geom, roi_h, roi_w, sub_h, sub_w = pool_geometry(
            rois, P=P, S=S, M=M, spatial_scale=spatial_scale)
        kw = dict(rois_per_image=rpi, P=P, S=S, M=M)
        pass1 = pool_pass(feat, geom, None, **kw)
        off = pass1.reshape(R, -1) @ off_w.t() + off_b  # [R, 2*P*P]
        pypx = window_starts(off, roi_h, roi_w, sub_h, sub_w, P=P, S=S, M=M,
                             trans_std=trans_std)
        pooled = pool_pass(feat, geom, pypx, **kw).reshape(R, -1)
        ctx.statics = statics
        ctx.save_for_backward(feat, rois, off_w, off_b, pass1)
        ctx.mark_non_differentiable(off)
        return pooled, off

    @staticmethod
    def backward(ctx, gpooled, _goff):
        feat, rois, off_w, off_b, pass1 = ctx.saved_tensors
        rpi, P, S, M, spatial_scale, trans_std = ctx.statics
        R, PP, C = pass1.shape
        geom, roi_h, roi_w, sub_h, sub_w = pool_geometry(
            rois, P=P, S=S, M=M, spatial_scale=spatial_scale)
        off = pass1.reshape(R, -1) @ off_w.t() + off_b
        raw_y, raw_x = _window_raw(off, roi_h, roi_w, sub_h, sub_w, P=P,
                                   S=S, M=M, trans_std=trans_std)
        hi = _rail(P, S, M)
        pypx = _clip_starts(raw_y, raw_x, hi)
        kw = dict(rois_per_image=rpi, P=P, S=S, M=M)
        g = gpooled.reshape(R, PP, C).float().contiguous()
        # transposed pass B -> dfeat term 1 and the window-start gradient
        dfeat, dpp = pool_pass_bwd(feat, geom, pypx, g, **kw)
        # window starts -> the offset FC's transpose, with the forward's
        # exact scale trans_std * roi / sub and the reference's lr_mult
        ddy = (dpp[:, 0] * _clip_mask(raw_y, hi)
               * (trans_std * roi_h.reshape(R, 1) / sub_h.reshape(R, 1)))
        ddx = (dpp[:, 1] * _clip_mask(raw_x, hi)
               * (trans_std * roi_w.reshape(R, 1) / sub_w.reshape(R, 1)))
        dfc = torch.cat([ddy, ddx], dim=1) * OFFSET_GRAD_MULT  # [R, 2*P*P]
        doff_w = dfc.t() @ pass1.reshape(R, PP * C)
        doff_b = dfc.sum(0)
        dpass1 = (dfc @ off_w).reshape(R, PP, C).contiguous()
        # transposed pass A -> dfeat term 2, into the same buffer
        dfeat, _ = pool_pass_bwd(feat, geom, None, dpass1, dfeat=dfeat, **kw)
        return (dfeat.to(feat.dtype), None, doff_w.to(off_w.dtype),
                doff_b.to(off_b.dtype), None)


def fused_offset_pool(feat, rois, off_w, off_b, *, rois_per_image,
                      pooled_size=7, sample_per_part=4, spatial_scale=0.0625,
                      trans_std=0.1, margin_bins=1, return_offset=False):
    """Two-pass deformable ROI pooling. feat [B,H,W,C] fp32,
    image-contiguous rois [B*rpi, 5], offset FC weight [2*P*P, P*P*C] and
    bias [2*P*P]. Returns pooled [B*rpi, P*P*C] fp32, bins p-major, and
    with ``return_offset`` also the raw offset-FC output [B*rpi, 2*P*P]
    (detached). The offset FC's gradient is scaled by OFFSET_GRAD_MULT."""
    P, S = pooled_size, sample_per_part
    statics = (rois_per_image, P, S, margin_bins * S, spatial_scale,
               trans_std)
    pooled, off = FusedOffsetPool.apply(feat.float().contiguous(), rois,
                                        off_w, off_b, statics)
    return (pooled, off) if return_offset else pooled


def rcnn_head_fused(feat, rois, head_params, *, rois_per_image,
                    pooled_size=7, sample_per_part=4, spatial_scale=0.0625,
                    trans_std=0.1, margin_bins=1, return_offset=False):
    """fused_offset_pool + the R-CNN FC stack. ``head_params`` is
    ((off_w, off_b), (fc1_w, fc1_b), (fc2_w, fc2_b), (cls_w, cls_b),
    (bbox_w, bbox_b)), weights [out, in]. Returns (cls_score [R, classes],
    bbox_pred [R, 4]) fp32, and the raw offset-FC output with
    ``return_offset``."""
    (off_w, off_b), fc1, fc2, cls, bbox = head_params
    pooled, off = fused_offset_pool(
        feat, rois, off_w, off_b, rois_per_image=rois_per_image,
        pooled_size=pooled_size, sample_per_part=sample_per_part,
        spatial_scale=spatial_scale, trans_std=trans_std,
        margin_bins=margin_bins, return_offset=True)
    h = torch.relu(torch.nn.functional.linear(pooled, *fc1))
    h = torch.relu(torch.nn.functional.linear(h, *fc2))
    out = (torch.nn.functional.linear(h, *cls),
           torch.nn.functional.linear(h, *bbox))
    return out + (off,) if return_offset else out


# ---------------------------------------------------------------------------
# the patch route of the two-pass pool (the JAX mask branch's route)
# ---------------------------------------------------------------------------


def extract_patches_plain(feat, geom, *, rois_per_image, patch_cells, r0=0,
                          r1=None):
    """Per-roi bilinear resize of feat [B,H,W,C] onto the E x E patch grid
    (E = ``patch_cells``) for rois [r0, r1): geom [R,4] = (ys, xs, sub_h,
    sub_w) fp32, image-contiguous rois (roi r -> image r // rpi). Returns
    [r1-r0, E, E, C] in feat's dtype: the dense ``_resize_tents`` products
    of _extract_patch_batched, in fp32, rounded once."""
    B, H, W, C = feat.shape
    r1 = geom.shape[0] if r1 is None else r1
    E = patch_cells
    g = geom[r0:r1]
    wy, _ = _resize_tents(g[:, 0], g[:, 2], E, H)  # [n,E,H]
    wx, _ = _resize_tents(g[:, 1], g[:, 3], E, W)  # [n,E,W]
    out = torch.empty((r1 - r0, E, E, C), dtype=feat.dtype,
                      device=feat.device)
    for b, lo, hi in _image_chunks(r1, rois_per_image, start=r0):
        a, z = lo - r0, hi - r0
        tmp = (wy[a:z] @ feat[b].float().reshape(H, W * C)).reshape(
            z - a, E, W, C)
        # [n,1,E(s),W] @ [n,E(t),W,C] -> [n,t,s,C]
        out[a:z] = (wx[a:z, None] @ tmp).to(feat.dtype)
    return out


def _extract_patches_kernel(feat, geom, *, rois_per_image, patch_cells, r0,
                            r1):
    B, H, W, C = feat.shape
    R = B * rois_per_image
    if feat.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"extract_patches takes float32 or bfloat16, got "
                         f"{feat.dtype}")
    cuda.require(feat, "feat", feat.dtype)
    cuda.require(geom, "geom", torch.float32, (R, 4))
    if H < 2 or W < 2 or not 0 <= r0 <= r1 <= R:
        raise ValueError(f"extract_patches needs H, W >= 2 and 0 <= r0 <= r1 "
                         f"<= {R}, got H={H}, W={W}, r0={r0}, r1={r1}")
    E = patch_cells
    out = torch.empty((r1 - r0, E, E, C), dtype=feat.dtype,
                      device=feat.device)
    lib = cuda.library()
    cuda.ROI_PATCH.launches += 1
    cuda.check(lib.sniper_roi_patch(
        feat.data_ptr(), geom.data_ptr(), out.data_ptr(),
        _KERNEL_DTYPES[feat.dtype], H, W, C, rois_per_image, r0, r1, E,
        cuda.stream(feat)), "extract_patches")
    return out


def extract_patches(feat, geom, *, rois_per_image, patch_cells, r0=0,
                    r1=None):
    """Patch extraction (see extract_patches_plain): the CUDA kernel for
    CUDA tensors, the plain version on the CPU."""
    r1 = geom.shape[0] if r1 is None else r1
    kw = dict(rois_per_image=rois_per_image, patch_cells=patch_cells, r0=r0,
              r1=r1)
    if feat.is_cuda:
        return _extract_patches_kernel(feat, geom, **kw)
    return extract_patches_plain(feat, geom, **kw)


def patch_counts(geom, E, H, W):
    """In-bounds mask [n, E, E] fp32 of the patch cells of geom [n,4]
    (_extract_patches_pallas's cnt)."""
    o = torch.arange(E, device=geom.device, dtype=torch.float32)
    pos_y = geom[:, 0:1] + o * geom[:, 2:3]
    pos_x = geom[:, 1:2] + o * geom[:, 3:4]
    vy = (pos_y > -0.5) & (pos_y < H - 0.5)
    vx = (pos_x > -0.5) & (pos_x < W - 0.5)
    return (vy[:, :, None] & vx[:, None, :]).float()


def tiled_bin_avg(patch, cnt, P, S):
    """Undeformed per-bin average (deform.py:_tiled_bin_avg): patch
    [n, T, T, C] (T = P*S), cnt [n, T, T] -> [n, P, P, C] fp32. The S-wide
    bins tile the patch, so this is a reshape-sum."""
    n, C = patch.shape[0], patch.shape[-1]
    out = patch.float().reshape(n, P, S, P, S, C).sum(dim=(2, 4))
    cn = cnt.reshape(n, P, S, P, S).sum(dim=(2, 4))[..., None]
    return torch.where(cn > 0, out / cn.clamp_min(1.0), 0.0)


def stencil_pool(patch, cnt, roi_h, roi_w, sub_h, sub_w, ctrans, *, P, S, M,
                 trans_std):
    """Deformed per-bin average (deform.py:_stencil_pool): each bin's S^2
    samples shift by the learned offset, which is a tent-stack stencil on
    the patch, applied as one dense [P*P, E*E] x [E*E, C] product per roi.
    patch [n,E,E,C], cnt [n,E,E], roi_h .. sub_w [n], ctrans [n,P,P,2]
    (plane 0 dy, plane 1 dx). Returns [n, P, P, C] fp32."""
    n, E, _, C = patch.shape
    dy = (ctrans[..., 0].float() * trans_std * roi_h[:, None, None]
          / sub_h[:, None, None])
    dx = (ctrans[..., 1].float() * trans_std * roi_w[:, None, None]
          / sub_w[:, None, None])
    base = S * torch.arange(P, device=patch.device, dtype=torch.float32) + M
    # window starts clamp to E - S so all S samples stay on the patch
    py = (base[:, None] + dy).clamp(0.0, float(E - S)).reshape(n, P * P)
    px = (base[None, :] + dx).clamp(0.0, float(E - S)).reshape(n, P * P)
    w_y = _tent_stack(py, S, E)  # [n, PP, E]
    w_x = _tent_stack(px, S, E)
    wf = (w_y[..., :, None] * w_x[..., None, :]).reshape(n, P * P, E * E)
    pooled = wf @ patch.float().reshape(n, E * E, C)
    cn = wf @ cnt.reshape(n, E * E, 1)
    pooled = torch.where(cn > 0, pooled / cn.clamp_min(1.0), 0.0)
    return pooled.reshape(n, P, P, C)


def patch_offset_pool(feat, rois, off_w, off_b, *, rois_per_image,
                      pooled_size=14, sample_per_part=4, spatial_scale=0.0625,
                      trans_std=0.1, margin_bins=1):
    """Two-pass deformable ROI pooling through one patch extraction per roi
    (fused_offset_pool(extract="einsum"), deform.py:743-794): extract ->
    pass-1 average of the central T x T cells -> offset FC (weight
    [2*P*P, P*P*C], bias [2*P*P]; the first P*P outputs are dy, the next
    dx) -> stencil. feat [B,H,W,C] (pooled in fp32), image-contiguous rois
    [B*rpi, 5]. Returns pooled [B*rpi, P*P*C] fp32, bins p-major. Rois run
    PATCH_ROI_CHUNK at a time. Forward only: the mask branch trains
    through fused_offset_pool."""
    if torch.is_grad_enabled() and (feat.requires_grad or off_w.requires_grad
                                    or off_b.requires_grad):
        raise NotImplementedError(
            "patch_offset_pool is forward only; the mask branch trains "
            "through fused_offset_pool")
    P, S = pooled_size, sample_per_part
    T = P * S
    M = margin_bins * S
    E = T + 2 * M
    feat = feat.float().contiguous()
    B, H, W, C = feat.shape
    R = rois.shape[0]
    geom, roi_h, roi_w, sub_h, sub_w = pool_geometry(
        rois, P=P, S=S, M=M, spatial_scale=spatial_scale)
    out = torch.empty((R, P * P * C), device=feat.device)
    for r0 in range(0, R, PATCH_ROI_CHUNK):
        r1 = min(R, r0 + PATCH_ROI_CHUNK)
        sl = slice(r0, r1)
        patch = extract_patches(feat, geom, rois_per_image=rois_per_image,
                                patch_cells=E, r0=r0, r1=r1)
        cnt = patch_counts(geom[sl], E, H, W)
        pass1 = tiled_bin_avg(patch[:, M:M + T, M:M + T],
                              cnt[:, M:M + T, M:M + T], P, S)
        off = pass1.reshape(r1 - r0, -1) @ off_w.t() + off_b
        ctrans = off.reshape(r1 - r0, 2, P, P).permute(0, 2, 3, 1)
        out[sl] = stencil_pool(
            patch, cnt, roi_h[sl], roi_w[sl], sub_h[sl], sub_w[sl], ctrans,
            P=P, S=S, M=M, trans_std=trans_std).reshape(r1 - r0, -1)
    return out
