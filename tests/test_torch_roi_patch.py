"""The port's patch route of the two-pass pool (ROI patch extraction, the
pass-1 bin average, the stencil) against the JAX package, on the CPU in
fp32, and the CUDA kernel against its plain version on the card.

- extract_patches_plain against _extract_patch_batched (the einsum
  extraction, fp32 on the CPU) and against the Pallas extract_patches in
  interpret mode, within tests/test_pallas_roi_patch.py's atol=2e-5,
  rtol=1e-5: the same tents, summed in another order. The in-bounds mask is
  exact.
- patch_offset_pool against fused_offset_pool(extract="einsum") with a
  random nonzero offset FC, within tests/test_torch_deform.py's atol=3e-5,
  rtol=2e-4 (fp32 sums in another order; the stencil's window starts go
  through the offset FC, whose rounding moves them by ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sniper_tpu.ops import deform as jdeform
from sniper_tpu.ops.pallas.roi_patch import extract_patches as jextract
from sniper_tpu_torch.ops import deform as tdeform
from torch_port import cuda_or_skip


def _rois(rng, B, rpi, span=400):
    R = B * rpi
    rois = np.zeros((R, 5), np.float32)
    rois[:, 0] = np.repeat(np.arange(B), rpi)
    rois[:, 1] = rng.uniform(-40, span, R)
    rois[:, 2] = rng.uniform(-40, span, R)
    rois[:, 3] = rois[:, 1] + rng.uniform(3, span, R)
    rois[:, 4] = rois[:, 2] + rng.uniform(3, span, R)
    # fully off the map on both sides, and a sub-bin roi (0.1 min size)
    rois[0, 1:] = [-500, -500, -400, -400]
    rois[1, 1:] = [5000, 5000, 6000, 6000]
    rois[2, 1:] = [40, 40, 41, 41]
    return rois


def _geom(rois, P, S, M):
    """The port's and the JAX package's geometry of the same rois."""
    geom, *_ = tdeform.pool_geometry(torch.from_numpy(rois), P=P, S=S, M=M,
                                     spatial_scale=1 / 16)
    return geom


@pytest.mark.parametrize("margin_bins", [0, 1, 2])
def test_extract_patches_matches_einsum(rng, margin_bins):
    B, H, W, C, rpi, P, S = 2, 14, 18, 8, 5, 7, 4
    T, M = P * S, margin_bins * S
    E = T + 2 * M
    feat = rng.randn(B, H, W, C).astype(np.float32)
    rois = _rois(rng, B, rpi)
    crois = jnp.asarray(rois).reshape(B, rpi, 5)
    jgeom = jdeform._roi_geom(crois, 1.0 / 16, T)
    want, want_cnt = jdeform._extract_patch_batched(jnp.asarray(feat), crois,
                                                    jgeom, M, E)
    geom = _geom(rois, P, S, M)
    got = tdeform.extract_patches(torch.from_numpy(feat), geom,
                                  rois_per_image=rpi, patch_cells=E)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).reshape(got.shape),
                               atol=2e-5, rtol=1e-5)
    cnt = tdeform.patch_counts(geom, E, H, W)
    np.testing.assert_array_equal(cnt.numpy(),
                                  np.asarray(want_cnt).reshape(cnt.shape))
    assert np.abs(got.numpy()[:2]).max() == 0.0  # off-map rois


def test_extract_patches_matches_pallas_interpret(rng):
    """The Pallas kernel itself, in interpret mode (slow on the CPU: one
    small case)."""
    B, H, W, C, rpi, P, S, M = 2, 9, 12, 4, 3, 7, 4, 4
    E = P * S + 2 * M
    feat = rng.randn(B, H, W, C).astype(np.float32)
    rois = _rois(rng, B, rpi, span=180)
    geom = _geom(rois, P, S, M)
    g = jnp.asarray(geom.numpy())
    want = jextract(jnp.asarray(feat), g[:, 0], g[:, 1], g[:, 2], g[:, 3],
                    rois_per_image=rpi, patch_cells=E, interpret=True)
    got = tdeform.extract_patches(torch.from_numpy(feat), geom,
                                  rois_per_image=rpi, patch_cells=E)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)


def test_extract_patches_roi_range_is_a_slice(rng):
    """A chunk [r0, r1) that crosses an image is the same rows of the whole
    extraction, bit for bit."""
    B, H, W, C, rpi, E = 3, 10, 11, 4, 5, 36
    feat = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32))
    geom = _geom(_rois(rng, B, rpi, span=150), 7, 4, 4)
    full = tdeform.extract_patches(feat, geom, rois_per_image=rpi,
                                   patch_cells=E)
    part = tdeform.extract_patches(feat, geom, rois_per_image=rpi,
                                   patch_cells=E, r0=3, r1=12)
    assert torch.equal(part, full[3:12])


@pytest.mark.parametrize("P,margin_bins", [(14, 1), (7, 1), (7, 2)])
def test_patch_offset_pool_matches_jax(rng, monkeypatch, P, margin_bins):
    # chunks of 5 rois cross the images' boundary
    monkeypatch.setattr(tdeform, "PATCH_ROI_CHUNK", 5)
    B, H, W, C, rpi = 2, 20, 28, 8, 6
    feat = rng.randn(B, H, W, C).astype(np.float32)
    rois = _rois(rng, B, rpi)
    off_k = (rng.randn(P * P * C, 2 * P * P) * 0.05).astype(np.float32)
    off_b = (rng.randn(2 * P * P) * 0.1).astype(np.float32)
    want = jdeform.fused_offset_pool(
        jnp.asarray(feat), jnp.asarray(rois), jnp.asarray(off_k),
        jnp.asarray(off_b), rois_per_image=rpi, pooled_size=P,
        margin_bins=margin_bins, roi_chunk=B, extract="einsum")
    with torch.no_grad():
        got = tdeform.patch_offset_pool(
            torch.from_numpy(feat), torch.from_numpy(rois),
            torch.from_numpy(off_k.T.copy()), torch.from_numpy(off_b),
            rois_per_image=rpi, pooled_size=P, margin_bins=margin_bins)
    assert got.shape == (B * rpi, P * P * C)
    assert np.abs(got.numpy()[:2]).max() == 0.0  # off-map rois
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=2e-4)


def test_patch_offset_pool_is_forward_only(rng):
    feat = torch.zeros(1, 6, 6, 4, requires_grad=True)
    rois = torch.tensor([[0.0, 10, 10, 60, 60]])
    with pytest.raises(NotImplementedError):
        tdeform.patch_offset_pool(feat, rois, torch.zeros(2 * 49, 49 * 4),
                                  torch.zeros(2 * 49), rois_per_image=1,
                                  pooled_size=7)


def _card_rois(rng, case):
    """(B, H, W, C, rpi, E, r0, r1, rois) of one card case of the kernel:
    the map, the patch size, the chunk [r0, r1) and image-contiguous rois
    in image pixels (stride 16)."""
    if case == "mixed":
        B, H, W, C, rpi, E, r0, r1 = 2, 24, 33, 160, 37, 64, 5, 70
        return B, H, W, C, rpi, E, r0, r1, _rois(rng, B, rpi, span=500)
    if case == "chunk_crosses_image":
        B, H, W, C, rpi, E, r0, r1 = 3, 20, 26, 64, 10, 36, 7, 24
        return B, H, W, C, rpi, E, r0, r1, _rois(rng, B, rpi, span=400)
    if case == "single_roi":
        B, H, W, C, rpi, E, r0, r1 = 2, 20, 26, 96, 10, 36, 13, 14
        rois = _rois(rng, B, rpi, span=400)
        rois[13, 1:] = [60, 40, 300, 250]  # image 1, on the map
        return B, H, W, C, rpi, E, r0, r1, rois
    B, H, W, C, rpi = 1, 22, 30, 64, 12
    E, r0, r1 = 36, 0, 12
    hi_y, hi_x = H * 16.0, W * 16.0
    if case == "off_map":
        # wholly off each side, then straddling each edge and both corners
        boxes = [(-900, 40, -300, 200), (40, -900, 200, -300),
                 (hi_x + 100, 40, hi_x + 600, 200),
                 (40, hi_y + 100, 200, hi_y + 600),
                 (-150, 30, 120, 200), (30, -150, 200, 120),
                 (hi_x - 120, 30, hi_x + 150, 200),
                 (30, hi_y - 120, 200, hi_y + 150),
                 (-200, -200, 100, 100), (hi_x - 90, hi_y - 90,
                                          hi_x + 300, hi_y + 300),
                 (-400, -400, hi_x + 400, hi_y + 400), (50, 50, 300, 250)]
    elif case == "last_row_col":
        # samples on and around the last row and column (i0 = n-2, w0 = 0)
        boxes = [(hi_x - 40, hi_y - 40, hi_x - 8, hi_y - 8),
                 (hi_x - 200, hi_y - 200, hi_x - 16, hi_y - 16),
                 (hi_x - 16, hi_y - 16, hi_x, hi_y),
                 (hi_x - 300, 10, hi_x + 7, 150),
                 (10, hi_y - 300, 150, hi_y + 7),
                 (hi_x - 24, hi_y - 24, hi_x + 8, hi_y + 8)] * 2
    elif case == "tiny":
        # sub-cell rois: sub_w << 1, the same x0 for many s
        boxes = [(100 + 7 * i, 60 + 5 * i, 100 + 7 * i + w, 60 + 5 * i + w)
                 for i, w in enumerate((0.2, 0.5, 1, 1.5, 2, 3, 4, 6, 8,
                                        12, 16, 24))]
    else:
        raise ValueError(case)
    rois = np.zeros((B * rpi, 5), np.float32)
    rois[:, 1:] = np.asarray(boxes, np.float32)
    return B, H, W, C, rpi, E, r0, r1, rois


def _check_against_plain(feat, geom, dtype, **kw):
    got = tdeform.extract_patches(feat, geom, **kw)
    want = tdeform.extract_patches_plain(feat, geom, **kw)
    torch.cuda.synchronize()
    # both blend the same taps in fp32 and round once; the plain version's
    # dense products sum in another order: 1e-5 in fp32, and in bf16 one
    # rounding step of the result (2^-7 relative) where the fp32 sums sit
    # on either side of a rounding boundary
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5
    else:
        assert bool((err <= 2.0 ** -7 * want.float().abs() + 1e-6).all())
    return got


CARD_CASES = ["mixed", "off_map", "last_row_col", "tiny",
              "chunk_crosses_image", "single_roi"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CARD_CASES)
def test_roi_patch_kernel_matches_plain(rng, case, dtype):
    dev = cuda_or_skip()
    B, H, W, C, rpi, E, r0, r1, rois = _card_rois(rng, case)
    feat = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32))
    S, M = 4, 4
    geom = _geom(rois, (E - 2 * M) // S, S, M)
    got = _check_against_plain(feat.to(dev, dtype), geom.to(dev), dtype,
                               rois_per_image=rpi, patch_cells=E, r0=r0,
                               r1=r1)
    if case == "off_map":  # the four rois wholly off the map are zero
        assert float(got[:4].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_patch_kernel_whole_map_roi(rng, dtype):
    """E 64 and C 256 with rois over most of a 120-column map: the column
    window (~120 columns) is wider than one shared-memory stage, so the
    kernel cuts it into column tiles."""
    dev = cuda_or_skip()
    B, H, W, C, rpi = 1, 40, 120, 256, 4
    hi_y, hi_x = H * 16.0, W * 16.0
    rois = np.array([[0, 0, 0, hi_x, hi_y],
                     [0, -100, -60, hi_x + 100, hi_y + 60],
                     [0, 30, 20, hi_x - 50, hi_y - 10],
                     [0, 0, 0, 900, hi_y]], np.float32)
    feat = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32))
    geom = _geom(rois, 14, 4, 4)
    assert float(geom[0, 3]) * 63 > 48  # wider than one stage
    _check_against_plain(feat.to(dev, dtype), geom.to(dev), dtype,
                         rois_per_image=rpi, patch_cells=64)


@pytest.mark.cuda
def test_patch_route_matches_fused_pool_kernels(rng):
    """The patch route (roi_patch kernel) and the composed-tent kernels
    (fused_pool) at P=14 pool the same tents in another order."""
    dev = cuda_or_skip()
    B, H, W, C, rpi, P = 2, 24, 33, 64, 20, 14
    feat = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32)).to(dev)
    rois = torch.from_numpy(_rois(rng, B, rpi, span=500)).to(dev)
    off_w = torch.from_numpy((rng.randn(2 * P * P, P * P * C) * 0.01)
                             .astype(np.float32)).to(dev)
    off_b = torch.from_numpy((rng.randn(2 * P * P) * 0.1)
                             .astype(np.float32)).to(dev)
    with torch.inference_mode():
        a = tdeform.patch_offset_pool(feat, rois, off_w, off_b,
                                      rois_per_image=rpi, pooled_size=P)
        b = tdeform.fused_offset_pool(feat, rois, off_w, off_b,
                                      rois_per_image=rpi, pooled_size=P)
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_roi_patch_kernel_rejects_what_it_does_not_take():
    dev = cuda_or_skip()
    geom = torch.zeros(2, 4, device=dev)
    with pytest.raises(ValueError):
        tdeform.extract_patches(torch.zeros(1, 5, 5, 8, device=dev,
                                            dtype=torch.float16), geom,
                                rois_per_image=2, patch_cells=8)
    with pytest.raises(ValueError):
        tdeform.extract_patches(torch.zeros(1, 1, 5, 8, device=dev), geom,
                                rois_per_image=2, patch_cells=8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,C", [(torch.float32, 6),
                                     (torch.bfloat16, 12)])
def test_roi_patch_kernel_rejects_unsupported_channels(dtype, C):
    """The kernel moves 16-byte channel vectors (4 fp32 or 8 bf16): other
    channel counts raise, and never reach the plain version."""
    dev = cuda_or_skip()
    geom = torch.zeros(2, 4, device=dev)
    with pytest.raises(ValueError, match="multiple of"):
        tdeform.extract_patches(torch.zeros(1, 5, 5, C, device=dev,
                                            dtype=dtype), geom,
                                rois_per_image=2, patch_cells=8)
