"""The group-major im2col of the port's grouped deformable conv (ResNeXt's
C5) against the JAX package, on the CPU in fp32.

The port's im2col writes the col for ``conv_groups`` CG as [CG, B*H*W,
K*K*cg_in], the layout the grouped product multiplies as it is. The JAX
package writes [B,H,W,K*K,C] and reorders it to ``col_g`` [B,H,W,CG,
K*K*cg_in] in XLA (sniper_tpu/ops/deform.py:270-278); moved to
group-outermost, that is the port's col.

- the plain group-major col against JAX's ``col_g`` (the same fp32 blend:
  within 1e-6, as tests/test_torch_deform.py's im2col edge cases);
- the plain backward on group-major gcol against ``jax.vjp`` of that
  reorder composed with the JAX im2col, gx and goff, at zero offsets (every
  sample on an integer) and at +-6 px (samples clamp onto the border);
- ``deformable_conv(conv_groups=CG)``'s gradients of x, the offsets and the
  weight against ``jax.grad`` of the JAX ``deformable_conv`` at wider groups
  than tests/test_torch_zoo_deform.py's.

Gradients within 2e-5 * max|ref| (the same fp32 arithmetic summed in
another order), as tests/test_torch_deform_bwd.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sniper_tpu.ops import deform as jdeform
from sniper_tpu_torch.ops import deform as tdeform


def _close(got, want, rel=2e-5, name=""):
    want = np.asarray(want)
    tol = rel * max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol, rtol=0,
                               err_msg=name)


def _jax_col_g(G, dilation, CG):
    """JAX's im2col then its grouped reorder (deform.py:270-278), with the
    conv groups moved outermost: (x, offsets) -> [CG, B*H*W, 9*cg_in]."""
    im2col = jdeform._make_im2col(G, 3, dilation)

    def f(x, off):
        col = im2col(x, off)
        B, H, W, KK, C = col.shape
        cg_in = C // CG
        col_g = col.reshape(B, H, W, KK, CG, cg_in)
        col_g = col_g.transpose(0, 1, 2, 4, 3, 5).reshape(
            B, H, W, CG, KK * cg_in)
        return col_g.transpose(3, 0, 1, 2, 4).reshape(CG, B * H * W,
                                                      KK * cg_in)

    return f


def _inputs(rng, B, H, W, C, G, regime):
    x = rng.randn(B, H, W, C).astype(np.float32)
    if regime == "zero":
        off = np.zeros((B, H, W, G * 18), np.float32)
    else:
        off = rng.uniform(-6, 6, (B, H, W, G * 18)).astype(np.float32)
    return x, off


@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("C,G", [(32, 2), (64, 4)])
@pytest.mark.parametrize("CG", [4, 8])
def test_group_major_col_matches_jax_col_g(rng, CG, C, G, dilation):
    x, off = _inputs(rng, 2, 5, 7, C, G, "random")
    want = _jax_col_g(G, dilation, CG)(jnp.asarray(x), jnp.asarray(off))
    kw = dict(num_groups=G, kernel_size=3, dilation=dilation, conv_groups=CG)
    got = tdeform.deform_im2col(torch.from_numpy(x), torch.from_numpy(off),
                                **kw)
    assert tuple(got.shape) == tdeform.col_shape(x.shape, 3, CG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    assert torch.equal(got, tdeform.deform_im2col_plain(
        torch.from_numpy(x), torch.from_numpy(off), **kw))


@pytest.mark.parametrize("regime", ["zero", "border"])
@pytest.mark.parametrize("CG", [4, 8])
def test_group_major_bwd_matches_jax_vjp(rng, CG, regime):
    B, H, W, C, G, d = 2, 6, 9, 32, 2, 2
    x, off = _inputs(rng, B, H, W, C, G, regime)
    gcol = rng.randn(CG, B * H * W, 9 * C // CG).astype(np.float32)
    _, vjp = jax.vjp(_jax_col_g(G, d, CG), jnp.asarray(x), jnp.asarray(off))
    want_gx, want_goff = vjp(jnp.asarray(gcol))
    gx, goff = tdeform.deform_im2col_bwd(
        torch.from_numpy(x), torch.from_numpy(off), torch.from_numpy(gcol),
        num_groups=G, kernel_size=3, dilation=d, conv_groups=CG)
    _close(gx, want_gx, name="gx")
    _close(goff, want_goff, name="goff")
    if regime == "border":  # the clamp zeroes some positional gradients
        assert (goff == 0).any()


@pytest.mark.parametrize("regime", ["small", "border"])
@pytest.mark.parametrize("CG", [4, 8, 16])
def test_grouped_deformable_conv_grads_match_jax_at_wider_groups(rng, CG,
                                                                 regime):
    B, H, W, Cin, Cout, G = 1, 6, 8, 64, 32, 4
    x = rng.randn(B, H, W, Cin).astype(np.float32)
    scale = 0.45 if regime == "small" else 6.0
    off = rng.uniform(-scale, scale, (B, H, W, G * 18)).astype(np.float32)
    k = (rng.randn(3, 3, Cin // CG, Cout) * 0.2).astype(np.float32)
    gout = rng.randn(B, H, W, Cout).astype(np.float32)
    kw = dict(num_groups=G, dilation=2, conv_groups=CG)

    def loss(x, off, k):
        return jnp.sum(jdeform.deformable_conv(x, off, k, **kw) * gout)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(k))
    tx = torch.from_numpy(x).requires_grad_()
    toff = torch.from_numpy(off).requires_grad_()
    tk = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_()
    y = tdeform.deformable_conv(tx, toff, tk, **kw)
    (y * torch.from_numpy(gout)).sum().backward()
    _close(tx.grad, want[0], name="dx")
    _close(toff.grad, want[1], name="doffsets")
    _close(tk.grad.permute(2, 3, 1, 0), want[2], name="dweight")
