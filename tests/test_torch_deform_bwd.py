"""The backward of the port's deformable conv and two-pass pool against
jax.grad through the JAX package, on the CPU in fp32, and the backward
kernels against their plain versions on the card.

- deformable_conv: d(x), d(offsets), d(weight) against jax.grad through
  sniper_tpu.ops.deform.deformable_conv (the _make_im2col custom VJP), in
  three offset regimes: zero offsets (every sample on an integer, the
  step-1 regime), small random offsets, and offsets that push samples past
  the border (the clamp, where the positional gradient is zero). The same
  fp32 arithmetic summed in another order: within 2e-5 * max|ref|.
- fused_offset_pool: d(feat), d(off_w), d(off_b) against jax.grad through
  fused_pool_vjp in interpret mode, as tests/test_pallas_fused_pool.py
  runs it, at fc_scale 0.0 (every window start on the tent kinks), 0.01
  (interior) and 0.1 (the clip rails), at margin_bins 1 and 2, and on the
  count-tie rois (n == 1.0) of that file's slow test; within that test's
  2e-5 * max|ref|.
- On the card (``cuda``): each backward kernel against its plain version
  at the same inputs; the kernels sum with fp32 atomics in another order:
  within 1e-4 * max|ref| (gx of a bf16 input: two bf16 steps of the plain
  value plus that 1e-4 * max|ref|, since a sum that cancels to near zero
  carries the order's error into the rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sniper_tpu.ops import deform as jdeform
from sniper_tpu.ops.pallas.fused_pool import fused_pool_vjp
from sniper_tpu_torch.ops import deform as tdeform
from torch_port import (
    IM2COL_EDGES,
    cuda_or_skip,
    im2col_edge,
    whole_map_rois,
)


def _close(got, want, rel=2e-5, name=""):
    want = np.asarray(want)
    tol = rel * max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol, rtol=0,
                               err_msg=name)


def _offsets(rng, regime, shape):
    if regime == "zero":
        return np.zeros(shape, np.float32)
    if regime == "small":
        return rng.uniform(-0.45, 0.45, shape).astype(np.float32)
    return rng.uniform(-6, 6, shape).astype(np.float32)  # "border"


@pytest.mark.parametrize("regime", ["zero", "small", "border"])
def test_deformable_conv_grads_match_jax(rng, regime):
    B, H, W, Cin, Cout, G, d = 2, 9, 11, 8, 6, 4, 2
    x = rng.randn(B, H, W, Cin).astype(np.float32)
    off = _offsets(rng, regime, (B, H, W, G * 18))
    k = (rng.randn(3, 3, Cin, Cout) * 0.2).astype(np.float32)
    gout = rng.randn(B, H, W, Cout).astype(np.float32)

    def loss(x, off, k):
        y = jdeform.deformable_conv(x, off, k, num_groups=G, dilation=d)
        return jnp.sum(y * gout)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(k))
    tx = torch.from_numpy(x).requires_grad_()
    toff = torch.from_numpy(off).requires_grad_()
    tk = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_()
    y = tdeform.deformable_conv(tx, toff, tk, num_groups=G, dilation=d)
    (y * torch.from_numpy(gout)).sum().backward()
    _close(tx.grad, want[0], name="dx")
    _close(toff.grad, want[1], name="doffsets")
    _close(tk.grad.permute(2, 3, 1, 0), want[2], name="dweight")
    if regime == "border":  # the clamp zeroes some positional gradients
        assert (toff.grad == 0).any()


def _random_rois(rng, B, rpi, span=400):
    R = B * rpi
    rois = np.zeros((R, 5), np.float32)
    rois[:, 0] = np.repeat(np.arange(B), rpi)
    rois[:, 1] = rng.uniform(-40, span, R)
    rois[:, 2] = rng.uniform(-40, span, R)
    rois[:, 3] = rois[:, 1] + rng.uniform(3, span, R)
    rois[:, 4] = rois[:, 2] + rng.uniform(3, span, R)
    return rois


# the count-tie rois of tests/test_pallas_fused_pool.py: feature-aligned
# corners, 3-px bins, straddling the map's border, so that at zero offsets
# a bin has exactly one valid row and column (n == 1.0)
TIE_ROIS = np.array([[0, -32, 16, 304, 352], [0, -80, 16, 256, 352],
                     [0, -128, 16, 208, 352]], np.float32)


def _pool_grads_jax(feat, rois, off_k, off_b, gct, rpi, margin_bins):
    def loss(feat, off_k, off_b):
        out = fused_pool_vjp(feat, jnp.asarray(rois), off_k, off_b,
                             rois_per_image=rpi, margin_bins=margin_bins)
        return jnp.sum(out * gct)

    return jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(feat), jnp.asarray(off_k), jnp.asarray(off_b))


def _pool_grads_torch(feat, rois, off_k, off_b, gct, rpi, margin_bins):
    tf = torch.from_numpy(feat).requires_grad_()
    tw = torch.from_numpy(off_k.T.copy()).requires_grad_()
    tb = torch.from_numpy(off_b).requires_grad_()
    out = tdeform.fused_offset_pool(tf, torch.from_numpy(rois), tw, tb,
                                    rois_per_image=rpi,
                                    margin_bins=margin_bins)
    (out * torch.from_numpy(gct)).sum().backward()
    return tf.grad, tw.grad.t(), tb.grad


@pytest.mark.parametrize("fc_scale,margin_bins,tie", [
    (0.0, 1, False), (0.01, 1, False), (0.1, 1, False), (0.0, 2, False),
    (0.01, 2, False), (0.0, 1, True)])
def test_pool_grads_match_fused_pool_vjp(rng, fc_scale, margin_bins, tie):
    P, C = 7, 8
    if tie:
        B, H, W, rpi = 1, 20, 28, 3
        rois = TIE_ROIS
    else:
        B, H, W, rpi = 2, 20, 28, 6
        rois = _random_rois(rng, B, rpi)
    feat = rng.randn(B, H, W, C).astype(np.float32)
    off_k = (rng.randn(P * P * C, 2 * P * P) * fc_scale).astype(np.float32)
    off_b = (rng.randn(2 * P * P) * fc_scale).astype(np.float32)
    gct = rng.randn(B * rpi, P * P * C).astype(np.float32)
    args = (feat, rois, off_k, off_b, gct, rpi, margin_bins)
    want = _pool_grads_jax(*args)
    got = _pool_grads_torch(*args)
    for name, a, b in zip(("dfeat", "doff_k", "doff_b"), got, want):
        _close(a, b, name=name)
    if fc_scale == 0.0:  # the kink conventions decide the FC's gradient
        assert float(np.abs(np.asarray(want[1])).max()) > 0


def test_pool_offset_telemetry_is_detached(rng):
    feat = torch.from_numpy(rng.randn(1, 10, 12, 4).astype(np.float32))
    rois = torch.tensor([[0.0, 10, 20, 100, 120], [0.0, 30, 5, 60, 90]])
    w = torch.zeros(98, 196, requires_grad=True)
    b = torch.zeros(98, requires_grad=True)
    pooled, off = tdeform.fused_offset_pool(feat, rois, w, b,
                                            rois_per_image=2,
                                            return_offset=True)
    assert pooled.requires_grad and not off.requires_grad
    assert off.shape == (2, 98) and float(off.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the backward kernels on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(IM2COL_EDGES))
def test_deform_im2col_bwd_edges_match_jax(rng, case):
    """The plain im2col backward against jax.vjp of the JAX im2col at the
    kernels' edge cases (ragged tiles, narrow and odd groups, clamping)."""
    x, off, kw = im2col_edge(rng, case)
    B, H, W, C = x.shape
    gcol = rng.randn(B, H, W, 9, C).astype(np.float32)
    im2col = jdeform._make_im2col(kw["num_groups"], 3, kw["dilation"])
    _, vjp = jax.vjp(im2col, jnp.asarray(x), jnp.asarray(off))
    want_gx, want_goff = vjp(jnp.asarray(gcol))
    gx, goff = tdeform.deform_im2col_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(off), torch.from_numpy(gcol),
        kernel_size=3, **kw)
    _close(gx, want_gx, name="gx")
    _close(goff, want_goff, name="goff")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,regime,case", [
    (torch.float32, "zero", None), (torch.float32, "border", None),
    (torch.bfloat16, "small", None), (torch.bfloat16, "border", None)] + [
    (dtype, None, case) for case in sorted(IM2COL_EDGES)
    for dtype in (torch.float32, torch.bfloat16)])
def test_im2col_bwd_kernel_matches_plain(rng, dtype, regime, case):
    dev = cuda_or_skip()
    if case is None:
        B, H, W, C, G = 2, 13, 17, 256, 4
        x = rng.randn(B, H, W, C).astype(np.float32)
        off = _offsets(rng, regime, (B, H, W, G * 18))
        kw = dict(num_groups=G, kernel_size=3, dilation=2)
    else:  # the forward's edge cases: ragged tiles, narrow groups, clamps
        x, off, kw = im2col_edge(rng, case)
        B, H, W, C = x.shape
        kw["kernel_size"] = 3
    gcol = torch.from_numpy(rng.randn(B, H, W, 9, C).astype(np.float32))
    x, off = torch.from_numpy(x).to(dev, dtype), torch.from_numpy(off).to(dev)
    gcol = gcol.to(dev, dtype)
    gx, goff = tdeform.deform_im2col_bwd(x, off, gcol, **kw)
    px, poff = tdeform.deform_im2col_bwd_plain(x, off, gcol, **kw)
    assert gx.dtype == dtype and goff.dtype == torch.float32
    tol = 1e-4 * float(poff.abs().max())
    torch.testing.assert_close(goff, poff, atol=tol, rtol=0)
    if dtype == torch.float32:
        torch.testing.assert_close(gx, px, atol=1e-4 * float(px.abs().max()),
                                   rtol=0)
    else:  # two bf16 steps, over the fp32 sums' own order error
        err = (gx.float() - px.float()).abs()
        floor = 1e-4 * float(px.float().abs().max())
        assert bool((err <= 2 * 2.0 ** -8 * px.float().abs() + floor).all())


@pytest.mark.parametrize("fc_scale,C", [(0.0, 5), (0.05, 8)])
def test_pool_grads_whole_map_rois_match_jax(rng, fc_scale, C):
    """The plain pool backward against jax.grad on rois whose footprint is
    the whole map, with a channel count that is not a multiple of 4."""
    P, B, H, W, rpi = 7, 1, 12, 14, 4
    rois = whole_map_rois(rng, B, rpi, H, W)
    feat = rng.randn(B, H, W, C).astype(np.float32)
    off_k = (rng.randn(P * P * C, 2 * P * P) * fc_scale).astype(np.float32)
    off_b = (rng.randn(2 * P * P) * fc_scale).astype(np.float32)
    gct = rng.randn(B * rpi, P * P * C).astype(np.float32)
    args = (feat, rois, off_k, off_b, gct, rpi, 1)
    want = _pool_grads_jax(*args)
    got = _pool_grads_torch(*args)
    for name, a, b in zip(("dfeat", "doff_k", "doff_b"), got, want):
        _close(a, b, name=name)


# the count-tie rois at P=14: corners at -24 px and 28-cell sides put bin
# (0, 0)'s four samples per axis at -1.75, -1.25, -0.75 and -0.25 cells, of
# which only the last is on the map (n == 1.0 at zero offsets)
TIE_ROIS_P14 = np.array([[0, -24, -24, 423, 423], [0, -24, 40, 423, 487],
                         [0, 100, -24, 300, 423]], np.float32)


# the kernel's channel tile is 32 lanes x 2 vectors x 4 channels = 256; at
# P=14 on training's 32x32 map a block takes 111,824 B of shared memory,
# above the 48 KB default (the opt-in path)
@pytest.mark.cuda
@pytest.mark.parametrize("fc_scale,tie,C,whole,P", [
    (0.0, False, 160, False, 7), (0.05, False, 160, False, 7),
    (0.0, True, 160, False, 7), (0.05, False, 100, True, 7),
    (0.0, False, 37, True, 7), (0.05, False, 300, True, 7),
    (0.0, False, 256, True, 14), (0.05, False, 256, True, 14),
    (0.0, True, 160, False, 14)])
def test_pool_bwd_kernel_matches_plain(rng, fc_scale, tie, C, whole, P):
    dev = cuda_or_skip()
    S, M = 4, 4
    if tie:
        B, H, W, rpi = 1, 20, 28, 3
        rois = TIE_ROIS if P == 7 else TIE_ROIS_P14
    elif whole:  # footprints up to the whole map, and 32x32 as in training
        B, H, W, rpi = 2, 32, 32, 12
        rois = whole_map_rois(rng, B, rpi, H, W)
    else:
        B, H, W, rpi = 2, 30, 44, 20
        rois = _random_rois(rng, B, rpi, span=600)
    R = B * rpi
    feat = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32)).to(dev)
    rois = torch.from_numpy(rois).to(dev)
    off = torch.from_numpy((rng.randn(R, 2 * P * P) * fc_scale * 30)
                           .astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.randn(R, P * P, C).astype(np.float32)).to(dev)
    geom, roi_h, roi_w, sub_h, sub_w = tdeform.pool_geometry(
        rois, P=P, S=S, M=M, spatial_scale=1 / 16)
    pypx = tdeform.window_starts(off, roi_h, roi_w, sub_h, sub_w, P=P, S=S,
                                 M=M, trans_std=0.1)
    kw = dict(rois_per_image=rpi, P=P, S=S, M=M)
    for bins in (pypx, None):
        dk, pk = tdeform.pool_pass_bwd(feat, geom, bins, g, **kw)
        dp, pp = tdeform.pool_pass_bwd_plain(feat, geom, bins, g, **kw)
        torch.testing.assert_close(dk, dp, atol=1e-4 * float(dp.abs().max()),
                                   rtol=0)
        if bins is not None:
            torch.testing.assert_close(
                pk, pp, atol=1e-4 * max(float(pp.abs().max()), 1e-3), rtol=0)


@pytest.mark.cuda
def test_backward_kernels_reject_what_they_do_not_take():
    dev = cuda_or_skip()
    x = torch.zeros(1, 5, 5, 8, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        tdeform.deform_im2col_bwd(x, torch.zeros(1, 5, 5, 72, device=dev),
                                  torch.zeros(1, 5, 5, 9, 8, device=dev,
                                              dtype=torch.float16))
    feat = torch.zeros(1, 5, 5, 8, device=dev)
    with pytest.raises(ValueError):
        tdeform.pool_pass_bwd(feat, torch.zeros(2, 4, device=dev), None,
                              torch.zeros(2, 49, 4, device=dev),
                              rois_per_image=2, P=7, S=4, M=4)
    # at P=14 the block's shared memory grows with H + W: 1600 (H + W) +
    # 9424 B, so a 70x70 map needs 233,424 B, more than a block has
    assert tdeform.pool_bwd_smem_bytes(70, 70, 14) > 227 * 1024
    assert tdeform.pool_bwd_smem_bytes(69, 70, 14) <= 227 * 1024
    feat = torch.zeros(1, 70, 70, 8, device=dev)
    with pytest.raises(ValueError):
        tdeform.pool_pass_bwd(feat, torch.zeros(2, 4, device=dev), None,
                              torch.zeros(2, 196, 8, device=dev),
                              rois_per_image=2, P=14, S=4, M=4)
