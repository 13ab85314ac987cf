"""The grouped deformable conv of the port (ResNeXt's C5) against the JAX
package, on the CPU in fp32.

``deformable_conv(conv_groups=CG)`` at CG 1, 4 and 8, dilation 1 and 2,
against sniper_tpu.ops.deform.deformable_conv: forward (close_to_scale:
rtol 1e-4, atol 1e-4 of max|want|) and the gradients of x, the offsets and
the weight against jax.grad (within 2e-5 * max|ref|, as
tests/test_torch_deform_bwd.py), at random offsets and at zero offsets
(every sample on an integer, the kinks). On the card (``cuda``): the
grouped conv's kernel path against its CPU result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sniper_tpu.ops import deform as jdeform
from sniper_tpu_torch.ops import deform as tdeform
from torch_port import close_to_scale, cuda_or_skip


def _close(got, want, rel=2e-5, name=""):
    want = np.asarray(want)
    tol = rel * max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol, rtol=0,
                               err_msg=name)


@pytest.mark.parametrize("regime", ["random", "zero"])
@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("CG", [1, 4, 8])
def test_grouped_deformable_conv_matches_jax(rng, CG, dilation, regime):
    B, H, W, Cin, Cout, G = 2, 7, 9, 16, 24, 4
    x = rng.randn(B, H, W, Cin).astype(np.float32)
    if regime == "zero":
        off = np.zeros((B, H, W, G * 18), np.float32)
    else:
        off = rng.uniform(-3, 3, (B, H, W, G * 18)).astype(np.float32)
    k = (rng.randn(3, 3, Cin // CG, Cout) * 0.2).astype(np.float32)
    gout = rng.randn(B, H, W, Cout).astype(np.float32)
    kw = dict(num_groups=G, dilation=dilation, conv_groups=CG)

    def loss(x, off, k):
        return jnp.sum(jdeform.deformable_conv(x, off, k, **kw) * gout)

    args = (jnp.asarray(x), jnp.asarray(off), jnp.asarray(k))
    want = jdeform.deformable_conv(*args, **kw)
    gwant = jax.grad(loss, argnums=(0, 1, 2))(*args)
    tx = torch.from_numpy(x).requires_grad_()
    toff = torch.from_numpy(off).requires_grad_()
    tk = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_()
    y = tdeform.deformable_conv(tx, toff, tk, **kw)
    close_to_scale(y.detach(), want)
    (y * torch.from_numpy(gout)).sum().backward()
    _close(tx.grad, gwant[0], name="dx")
    _close(toff.grad, gwant[1], name="doffsets")
    _close(tk.grad.permute(2, 3, 1, 0), gwant[2], name="dweight")


def test_grouped_deformable_conv_keeps_ungrouped_product(rng):
    """conv_groups=1 is the one matmul over [K*K*Cin, Cout] it was; a
    block-diagonal weight gives the grouped result."""
    B, H, W, Cin, Cout, CG = 1, 5, 6, 8, 8, 4
    x = torch.from_numpy(rng.randn(B, H, W, Cin).astype(np.float32))
    off = torch.from_numpy(rng.uniform(-2, 2, (B, H, W, 72))
                           .astype(np.float32))
    wg = torch.from_numpy(rng.randn(Cout, Cin // CG, 3, 3)
                          .astype(np.float32))
    dense = torch.zeros(Cout, Cin, 3, 3)
    co, ci = Cout // CG, Cin // CG
    for g in range(CG):
        dense[g * co:(g + 1) * co, g * ci:(g + 1) * ci] = wg[g * co:
                                                            (g + 1) * co]
    col = tdeform.deform_im2col(x, off, num_groups=4, dilation=2)
    one = torch.matmul(col.reshape(B, H, W, -1),
                       dense.permute(2, 3, 1, 0).reshape(9 * Cin, Cout))
    assert torch.equal(tdeform.deformable_conv(x, off, dense), one)
    got = tdeform.deformable_conv(x, off, wg, conv_groups=CG)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_deformable_conv_on_the_card_matches_cpu(rng, dtype):
    """X101's C5 conv (2048 channels, 4 deformable groups of 512, 64 conv
    groups, dilation 2) through the im2col kernels and the grouped product
    on the card, against the same conv on the CPU through the plain
    versions: forward and the gradients of x, the offsets and the weight.
    TF32 off; fp32 within close_to_scale of the CPU result (the product
    and the kernels' atomics sum in another order), bf16 within 2e-2 of
    max|ref| (bf16 roundings of the col and of the gradients, taken in
    another order)."""
    dev = cuda_or_skip()
    B, H, W, C, G, CG = 1, 6, 9, 2048, 4, 64
    x = rng.randn(B, H, W, C).astype(np.float32)
    off = rng.uniform(-3, 3, (B, H, W, G * 18)).astype(np.float32)
    k = (rng.randn(C, C // CG, 3, 3) * 0.05).astype(np.float32)
    gout = rng.randn(B, H, W, C).astype(np.float32)
    kw = dict(num_groups=G, dilation=2, conv_groups=CG)

    def run(device, dt):
        tx = torch.from_numpy(x).to(device, dt).requires_grad_()
        toff = torch.from_numpy(off).to(device).requires_grad_()
        tk = torch.from_numpy(k).to(device).requires_grad_()
        y = tdeform.deformable_conv(tx, toff, tk, **kw)
        (y.float() * torch.from_numpy(gout).to(device)).sum().backward()
        return [t.detach().float().cpu().numpy()
                for t in (y, tx.grad, toff.grad, tk.grad)]

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = run(dev, dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    want = run("cpu", dtype)
    for name, g, w in zip(("y", "dx", "doffsets", "dweight"), got, want):
        if dtype == torch.float32:
            close_to_scale(g, w)
        else:
            np.testing.assert_allclose(
                g, w, rtol=0, atol=2e-2 * float(np.abs(w).max()),
                err_msg=name)
