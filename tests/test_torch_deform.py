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
from torch_port import (
    IM2COL_EDGES,
    IM2COL_GROUPED,
    cuda_or_skip,
    im2col_edge,
    whole_map_rois,
)


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


@pytest.mark.parametrize("case", sorted(IM2COL_EDGES))
def test_deform_im2col_edges_match_jax(rng, case):
    """The plain im2col against the JAX one at the kernel's edge cases."""
    x, off, kw = im2col_edge(rng, case)
    want = jdeform._make_im2col(kw["num_groups"], 3, kw["dilation"])(
        jnp.asarray(x), jnp.asarray(off))
    got = tdeform.deform_im2col(torch.from_numpy(x), torch.from_numpy(off),
                                **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(IM2COL_EDGES) + sorted(IM2COL_GROUPED))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_im2col_kernel_matches_plain(rng, dtype, case):
    """Bit-exact, the col [B,H,W,K*K,C] or, for a grouped case, group-major
    [CG, B*H*W, K*K*C/CG]."""
    dev = cuda_or_skip()
    x, off, kw = im2col_edge(rng, case)
    x = torch.from_numpy(x).to(dev, dtype)
    off = torch.from_numpy(off).to(dev)
    a = tdeform.deform_im2col(x, off, **kw)
    b = tdeform.deform_im2col_plain(x, off, kernel_size=3, **kw)
    assert torch.equal(a, b)  # same fp32 ops in the same order


# pool kernel cases, (B, H, W, C, rpi, P, margin_bins, rois): the kernel
# composes per-bin weight lists (at most 2(S+1) pairs per axis) and its
# lanes own 4-channel vectors
POOL_CASES = {
    "random": (2, 30, 44, 160, 20, 7, 1, "random"),
    # the mask branch's 14x14 pool
    "p14": (2, 30, 44, 160, 20, 14, 1, "random"),
    # the mask branch in training: 32x32 maps, C 256, whole-map footprints
    "p14_train": (2, 32, 32, 256, 25, 14, 1, "whole"),
    # footprints up to the whole map, as in training
    "whole": (2, 32, 32, 100, 12, 7, 1, "whole"),
    # a channel count that is not a multiple of 4: scalar channels
    "c37": (2, 30, 44, 37, 20, 7, 1, "random"),
    "margin2": (2, 30, 44, 160, 20, 7, 2, "random"),
    # rois off the map (all-zero output) and sub-pixel rois
    "offmap": (1, 10, 12, 8, 6, 7, 1, "offmap"),
    # a map wider than the first design's dense weights could hold
    "wide": (1, 48, 1200, 8, 16, 7, 1, "random"),
    # AutoFocus's smallest FocusChip tier (256x320 canvas, a 16x20 map):
    # 300 rois per image, each spanning up to the whole map, at P=7 and,
    # with the mask config, at P=14
    "focus_tier": (2, 16, 20, 256, 300, 7, 1, "whole"),
    "focus_tier_p14": (2, 16, 20, 256, 300, 14, 1, "whole"),
}


def _pool_case_rois(rng, case):
    B, H, W, _, rpi, _, _, kind = POOL_CASES[case]
    if kind == "whole":
        return whole_map_rois(rng, B, rpi, H, W)
    rois = _random_rois(rng, B, rpi, span=600)
    if kind == "offmap":
        rois[:4, 1:] = [[-500, -500, -400, -400], [5000, 5000, 6000, 6000],
                        [40, 40, 41, 41], [100, 60, 100, 60]]
    return rois


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_kernel_matches_plain(rng, case):
    dev = cuda_or_skip()
    B, H, W, C, rpi, P, margin_bins, _ = POOL_CASES[case]
    S, M = 4, 4 * margin_bins
    feat = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32)).to(dev)
    rois = torch.from_numpy(_pool_case_rois(rng, case)).to(dev)
    off_k, off_b = _offset_fc(rng, C, P=P, scale=0.03)
    off_w = torch.from_numpy(off_k.T.copy()).to(dev)
    off_b = torch.from_numpy(off_b).to(dev)
    geom, roi_h, roi_w, sub_h, sub_w = tdeform.pool_geometry(
        rois, P=P, S=S, M=M, spatial_scale=1 / 16)
    kw = dict(rois_per_image=rpi, P=P, S=S, M=M)
    # fp32 sums in another order than the plain version's: 1e-4
    pass1 = tdeform.pool_pass_plain(feat, geom, None, **kw)
    torch.testing.assert_close(tdeform.pool_pass(feat, geom, None, **kw),
                               pass1, atol=1e-4, rtol=1e-4)
    off = pass1.reshape(B * rpi, -1) @ off_w.t() + off_b
    pypx = tdeform.window_starts(off, roi_h, roi_w, sub_h, sub_w, P=P, S=S,
                                 M=M, trans_std=0.1)
    pooled = tdeform.pool_pass_plain(feat, geom, pypx, **kw)
    torch.testing.assert_close(tdeform.pool_pass(feat, geom, pypx, **kw),
                               pooled, atol=1e-4, rtol=1e-4)
    got = tdeform.fused_offset_pool(feat, rois, off_w, off_b,
                                    rois_per_image=rpi, pooled_size=P,
                                    margin_bins=margin_bins)
    torch.testing.assert_close(got, pooled.reshape(B * rpi, -1), atol=1e-4,
                               rtol=1e-4)
    if case == "offmap":
        assert float(got[:2].abs().max()) == 0.0


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
    # the pool's shared memory grows with P*P*S, not with the map: P=40
    # needs 2*1600*(2*5*8 + 8) B, more than a block has
    feat = torch.zeros(1, 5, 5, 8, device=dev)
    with pytest.raises(ValueError):
        tdeform.pool_pass(feat, geom, None, rois_per_image=2, P=40, S=4, M=4)
