"""The port's deformable conv and two-pass deformable ROI pool against the
JAX package, on the CPU in fp32.

- deformable_conv: offsets of +-6 px on a small map, so many samples clamp
  onto the border; the im2col is the same fp32 arithmetic, the matmul sums
  in another order: atol 1e-4, rtol 1e-4.
- fused_offset_pool: against fused_pool_pallas in interpret mode and the
  einsum fused_offset_pool, within tests/test_pallas_fused_pool.py's
  atol=3e-5, rtol=2e-4 (fp32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sniper_tpu.ops import deform as jdeform
from sniper_tpu.ops.pallas.fused_pool import fused_pool_pallas
from sniper_tpu_torch.ops import deform as tdeform
from torch_port import cuda_or_skip


def _random_rois(rng, B, rpi, span=400):
    R = B * rpi
    rois = np.zeros((R, 5), np.float32)
    rois[:, 0] = np.repeat(np.arange(B), rpi)
    rois[:, 1] = rng.uniform(-40, span, R)
    rois[:, 2] = rng.uniform(-40, span, R)
    rois[:, 3] = rois[:, 1] + rng.uniform(3, span, R)
    rois[:, 4] = rois[:, 2] + rng.uniform(3, span, R)
    # half-pixel corners exercise round-half-to-even in the roi snapping
    rois[:4, 1:] = np.floor(rois[:4, 1:]) + 0.5
    return rois


def _offset_fc(rng, C, P=7, scale=0.05):
    off_k = (rng.randn(P * P * C, 2 * P * P) * scale).astype(np.float32)
    off_b = (rng.randn(2 * P * P) * scale * 2).astype(np.float32)
    return off_k, off_b


@pytest.mark.parametrize("G,dilation", [(4, 2), (1, 1)])
def test_deformable_conv_matches_jax(rng, G, dilation):
    B, H, W, Cin, Cout = 2, 9, 11, 8, 6
    x = rng.randn(B, H, W, Cin).astype(np.float32)
    off = rng.uniform(-6, 6, (B, H, W, G * 18)).astype(np.float32)
    k = (rng.randn(3, 3, Cin, Cout) * 0.2).astype(np.float32)
    want = jdeform.deformable_conv(jnp.asarray(x), jnp.asarray(off),
                                   jnp.asarray(k), num_groups=G,
                                   dilation=dilation)
    got = tdeform.deformable_conv(
        torch.from_numpy(x), torch.from_numpy(off),
        torch.from_numpy(k.transpose(3, 2, 0, 1).copy()), num_groups=G,
        dilation=dilation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_deform_im2col_matches_jax(rng):
    """The im2col itself is the same fp32 arithmetic in the same order."""
    B, H, W, C, G = 1, 7, 10, 8, 2
    x = rng.randn(B, H, W, C).astype(np.float32)
    off = rng.uniform(-6, 6, (B, H, W, G * 18)).astype(np.float32)
    want = jdeform._make_im2col(G, 3, 2)(jnp.asarray(x), jnp.asarray(off))
    got = tdeform.deform_im2col(torch.from_numpy(x), torch.from_numpy(off),
                                num_groups=G, dilation=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_roi_geom_rounds_half_to_even():
    rois = np.array([[0, 2.5, 3.5, 10.5, 11.5], [0, -0.5, 1.5, 4.5, 5.5]],
                    np.float32)
    want = jdeform._roi_geom(jnp.asarray(rois), 0.0625, 28)
    got = tdeform._roi_geom(torch.from_numpy(rois), 0.0625, 28)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("margin_bins", [1, 2])
def test_pool_matches_pallas_and_einsum(rng, margin_bins):
    B, H, W, C, rpi = 2, 20, 28, 8, 6
    feat = rng.randn(B, H, W, C).astype(np.float32)
    rois = _random_rois(rng, B, rpi)
    off_k, off_b = _offset_fc(rng, C)
    got = tdeform.fused_offset_pool(
        torch.from_numpy(feat), torch.from_numpy(rois),
        torch.from_numpy(off_k.T.copy()), torch.from_numpy(off_b),
        rois_per_image=rpi, margin_bins=margin_bins).numpy()
    args = (jnp.asarray(feat), jnp.asarray(rois), jnp.asarray(off_k),
            jnp.asarray(off_b))
    pallas = fused_pool_pallas(*args, rois_per_image=rpi,
                               margin_bins=margin_bins, interpret=True)
    einsum = jdeform.fused_offset_pool(*args, rois_per_image=rpi,
                                       margin_bins=margin_bins,
                                       extract="einsum")
    np.testing.assert_allclose(got, np.asarray(pallas), atol=3e-5, rtol=2e-4)
    np.testing.assert_allclose(got, np.asarray(einsum), atol=3e-5, rtol=2e-4)


def test_pool_offmap_and_degenerate_rois(rng):
    """Off-map rois pool to exactly zero; sub-pixel rois stay finite."""
    B, H, W, C = 1, 10, 12, 4
    feat = rng.randn(B, H, W, C).astype(np.float32)
    rois = np.array([[0, -500, -500, -400, -400],
                     [0, 5000, 5000, 6000, 6000],
                     [0, 40, 40, 41, 41]], np.float32)
    off_k, off_b = _offset_fc(rng, C)
    got = tdeform.fused_offset_pool(
        torch.from_numpy(feat), torch.from_numpy(rois),
        torch.from_numpy(off_k.T.copy()), torch.from_numpy(off_b),
        rois_per_image=3).numpy()
    want = jdeform.fused_offset_pool(
        jnp.asarray(feat), jnp.asarray(rois), jnp.asarray(off_k),
        jnp.asarray(off_b), rois_per_image=3, margin_bins=1,
        extract="einsum")
    assert np.isfinite(got).all()
    assert np.abs(got[:2]).max() == 0.0
    np.testing.assert_allclose(got, np.asarray(want), atol=3e-5, rtol=2e-4)


def test_rcnn_head_fused_matches_jax(rng):
    B, H, W, C, rpi, P, fc, ncls = 2, 12, 16, 8, 4, 7, 32, 5
    feat = rng.randn(B, H, W, C).astype(np.float32)
    rois = _random_rois(rng, B, rpi, span=200)

    def lin(i, o):
        return ((rng.randn(i, o) * 0.05).astype(np.float32),
                (rng.randn(o) * 0.05).astype(np.float32))

    params = [lin(P * P * C, 2 * P * P), lin(P * P * C, fc), lin(fc, fc),
              lin(fc, ncls), lin(fc, 4)]
    want = jdeform.rcnn_head_fused(
        jnp.asarray(feat), jnp.asarray(rois),
        tuple(jnp.asarray(a) for kb in params for a in kb),
        rois_per_image=rpi, margin_bins=1)
    got = tdeform.rcnn_head_fused(
        torch.from_numpy(feat), torch.from_numpy(rois),
        tuple((torch.from_numpy(k.T.copy()), torch.from_numpy(b))
              for k, b in params),
        rois_per_image=rpi, margin_bins=1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


# im2col edge cases, (B, H, W, C, G, dilation, offsets): the kernel's pixel
# tile is 16 wide and its vector 8 bf16 or 4 fp32 channels
IM2COL_EDGES = {
    # W = 17: a ragged tile of one pixel; 16-channel groups (whole vectors)
    "ragged": (2, 13, 17, 64, 4, 2, "random"),
    # 3-channel groups: below and not a multiple of either vector width
    "narrow": (1, 6, 33, 12, 4, 2, "random"),
    # 6-channel groups (not a multiple of 4 or 8), one group
    "odd": (2, 5, 9, 6, 1, 1, "random"),
    # 4-channel groups: whole fp32 vectors, below the bf16 vector
    "half": (1, 7, 20, 16, 4, 2, "random"),
    # every sample clamps: offsets of +-40 on a 5x6 map, and exact borders
    "clamp": (2, 5, 6, 32, 2, 2, "clamp"),
    # the smallest map the kernel takes
    "tiny": (1, 2, 2, 8, 1, 1, "random"),
}


def _im2col_edge(rng, case):
    B, H, W, C, G, d, kind = IM2COL_EDGES[case]
    x = rng.randn(B, H, W, C).astype(np.float32)
    if kind == "clamp":
        # past every border: each sample clamps onto an edge or a corner
        off = rng.choice(np.float32([-40.0, 40.0, -(H + 3.0), W + 3.0]),
                         (B, H, W, G * 18))
        # the centre tap (t = 4, no dilation shift) lands exactly on the
        # top and the right border: sy = 0, sx = W - 1 (x0 = W - 2, lx = 1)
        off[..., 8::18] = -np.arange(H)[None, :, None, None]
        off[..., 9::18] = (W - 1) - np.arange(W)[None, None, :, None]
    else:
        off = rng.uniform(-6, 6, (B, H, W, G * 18))
    return x, off.astype(np.float32), dict(num_groups=G, dilation=d)


@pytest.mark.parametrize("case", sorted(IM2COL_EDGES))
def test_deform_im2col_edges_match_jax(rng, case):
    """The plain im2col against the JAX one at the kernel's edge cases."""
    x, off, kw = _im2col_edge(rng, case)
    want = jdeform._make_im2col(kw["num_groups"], 3, kw["dilation"])(
        jnp.asarray(x), jnp.asarray(off))
    got = tdeform.deform_im2col(torch.from_numpy(x), torch.from_numpy(off),
                                **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(IM2COL_EDGES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_im2col_kernel_matches_plain(rng, dtype, case):
    dev = cuda_or_skip()
    x, off, kw = _im2col_edge(rng, case)
    x = torch.from_numpy(x).to(dev, dtype)
    off = torch.from_numpy(off).to(dev)
    a = tdeform.deform_im2col(x, off, **kw)
    b = tdeform.deform_im2col_plain(x, off, kernel_size=3, **kw)
    assert torch.equal(a, b)  # same fp32 ops in the same order


@pytest.mark.cuda
def test_pool_kernel_matches_plain(rng):
    dev = cuda_or_skip()
    B, H, W, C, rpi = 2, 30, 44, 160, 20
    feat = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32)).to(dev)
    rois = torch.from_numpy(_random_rois(rng, B, rpi, span=600)).to(dev)
    off_k, off_b = _offset_fc(rng, C, scale=0.03)
    off_w = torch.from_numpy(off_k.T.copy()).to(dev)
    off_b = torch.from_numpy(off_b).to(dev)
    geom, roi_h, roi_w, sub_h, sub_w = tdeform.pool_geometry(
        rois, P=7, S=4, M=4, spatial_scale=1 / 16)
    kw = dict(rois_per_image=rpi, P=7, S=4, M=4)
    # fp32 sums in another order than the plain version's: 1e-4
    pass1 = tdeform.pool_pass_plain(feat, geom, None, **kw)
    torch.testing.assert_close(tdeform.pool_pass(feat, geom, None, **kw),
                               pass1, atol=1e-4, rtol=1e-4)
    off = pass1.reshape(B * rpi, -1) @ off_w.t() + off_b
    pypx = tdeform.window_starts(off, roi_h, roi_w, sub_h, sub_w, P=7, S=4,
                                 M=4, trans_std=0.1)
    pooled = tdeform.pool_pass_plain(feat, geom, pypx, **kw)
    torch.testing.assert_close(tdeform.pool_pass(feat, geom, pypx, **kw),
                               pooled, atol=1e-4, rtol=1e-4)
    got = tdeform.fused_offset_pool(feat, rois, off_w, off_b,
                                    rois_per_image=rpi)
    torch.testing.assert_close(got, pooled.reshape(B * rpi, -1), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take():
    dev = cuda_or_skip()
    x = torch.zeros(1, 5, 5, 8, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        tdeform.deform_im2col(x, torch.zeros(1, 5, 5, 72, device=dev))
    feat = torch.zeros(1, 5, 5, 8, device=dev, dtype=torch.bfloat16)
    geom = torch.zeros(2, 4, device=dev)
    with pytest.raises(ValueError):
        tdeform.pool_pass(feat, geom, None, rois_per_image=2, P=7, S=4, M=4)
