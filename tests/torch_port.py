"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py).

Whether a card is present is decided inside the tests (``cuda_or_skip``),
never while a module is imported, so that every pytest-xdist worker
collects the same tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def cuda_or_skip() -> torch.device:
    """The CUDA device, or skip: the test runs a hand-written kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def close_to_scale(got, want, rtol=1e-4):
    """assert_allclose with rtol and an atol of 1e-4 of want's largest
    magnitude (fp32 layers summing in another order)."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=1e-4 * scale)


# DCN im2col edge cases, (B, H, W, C, G, dilation, offsets): the kernels'
# pixel tile is 16 wide and their vector 8 bf16 or 4 fp32 channels
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
    # the smallest map the kernels take
    "tiny": (1, 2, 2, 8, 1, 1, "random"),
    # the C5 map of AutoFocus's smallest FocusChip tier (256x320 canvas) at
    # dilation 2: the border clamp touches most taps
    "focus_tier": (2, 16, 20, 128, 4, 2, "random"),
    # ResNeXt-101's C5 width: 512 channels per deformable group, where the
    # backward leaves its warp-reduced route (L = C/G/V > 32) for the
    # shared-memory sums
    "x101_c5": (1, 6, 9, 2048, 4, 2, "random"),
}


# group-major im2col cases, (an IM2COL_EDGES case or its own shape, conv
# groups): the col written [CG, B*H*W, K*K*C/CG] for a grouped product
IM2COL_GROUPED = {
    # ResNeXt-101's C5: 64 conv groups of 32 channels (4 bf16 vectors)
    "x101_c5_cg64": ("x101_c5", 64),
    # 4 conv groups of 16 over 64 channels, on the ragged tile
    "ragged_cg4": ("ragged", 4),
    # 8 conv groups of 3 over 24 channels: no whole vector, width 1
    "c24_cg8": ((1, 6, 11, 24, 2, 2, "random"), 8),
}


def im2col_edge(rng, case):
    """x [B,H,W,C] and offsets [B,H,W,G*18] fp32 of an IM2COL_EDGES or
    IM2COL_GROUPED case, and the im2col's keyword arguments (with
    ``conv_groups`` for a grouped case)."""
    if case in IM2COL_GROUPED:
        spec, CG = IM2COL_GROUPED[case]
        x, off, kw = _im2col_inputs(rng, IM2COL_EDGES.get(spec, spec))
        return x, off, dict(kw, conv_groups=CG)
    return _im2col_inputs(rng, IM2COL_EDGES[case])


def _im2col_inputs(rng, spec):
    B, H, W, C, G, d, kind = spec
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


def whole_map_rois(rng, B, rpi, H, W):
    """Random image-contiguous rois [B*rpi, 5], the first two of each image
    covering the whole H x W map at stride 16 (and past it), so that their
    footprint is the map."""
    span = 16 * max(H, W)
    R = B * rpi
    rois = np.zeros((R, 5), np.float32)
    rois[:, 0] = np.repeat(np.arange(B), rpi)
    rois[:, 1] = rng.uniform(-40, span, R)
    rois[:, 2] = rng.uniform(-40, span, R)
    rois[:, 3] = rois[:, 1] + rng.uniform(3, span, R)
    rois[:, 4] = rois[:, 2] + rng.uniform(3, span, R)
    for b in range(B):
        rois[b * rpi] = [b, -40, -40, 16 * W + 40, 16 * H + 40]
        rois[b * rpi + 1] = [b, 0, 0, 16 * W - 1, 16 * H - 1]
    return rois


TINY = dict(num_classes=5, num_anchors=9, anchor_scales=(2, 4, 7),
            anchor_ratios=(0.5, 1, 2), units=(1, 1, 1, 1),
            pre_nms_top_n=200, post_nms_top_n=16)


def synth_image_loader(path):
    """A deterministic uint8 BGR image for a roidb entry named
    'img<i>:<h>x<w>'."""
    i, hw = path.split(":")
    h, w = (int(v) for v in hw.split("x"))
    rng = np.random.RandomState(int(i.removeprefix("img")))
    return rng.randint(0, 255, (h, w, 3)).astype(np.uint8)


def tiny_jax_detector(key=0, **overrides):
    """A tiny fp32 flax detector (tests/test_detector.py's shape) and its
    inference variables as NumPy."""
    from sniper_tpu.models.detector import SNIPERDetector

    kw = dict(TINY, dtype=jnp.float32, num_rois=TINY["post_nms_top_n"])
    kw.update(overrides)
    model = SNIPERDetector(**kw)
    data = jnp.zeros((1, 64, 64, 3), jnp.float32)
    info = jnp.asarray([[64.0, 64.0, 1.0]], jnp.float32)
    variables = model.init({"params": jax.random.PRNGKey(key)}, data, info,
                           train=False)
    return model, jax.tree.map(np.asarray, variables)


def tiny_torch_detector(variables=None, **overrides):
    """The port's counterpart of tiny_jax_detector, fp32, with the flax
    variables converted in when given."""
    from sniper_tpu_torch.convert import load_flax_variables
    from sniper_tpu_torch.models.detector import SNIPERDetector

    kw = dict(TINY, dtype=torch.float32)
    kw.update(overrides)
    model = SNIPERDetector(**kw).eval()
    if variables is not None:
        load_flax_variables(model, variables)
    return model


# the model zoo's tiny detectors: TINY with the trunk of each JAX registry
# symbol (X101: full widths and 64 groups at units (1,1,1,1); MobileNetV2:
# full width, stride 32)
ZOO = {
    "resnext": dict(trunk_type="resnext"),
    "mobilenetv2": dict(trunk_type="mobilenetv2", head_fc_dim=512,
                        feat_stride=32),
}
# the JAX detector's ResNeXt takes its group count (default 1) from the
# registry; the port's ResNeXtTrunk has 64
ZOO_JAX = {"resnext": dict(num_trunk_groups=64), "mobilenetv2": {}}


def flax_shapes(module, *args, **kwargs):
    """The variable tree of ``module.init(key, *args, **kwargs)`` as shapes,
    traced and not run (a flax init at full width costs tens of seconds of
    op-by-op compiles here)."""
    return jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))


def port_to_flax(shapes, model):
    """``model``'s state_dict as flax variables of the tree ``shapes``: the
    inverse of convert for convs, grouped ones included, and Dense layers
    (no transposed conv). Every leaf of the tree must have a port tensor of
    the converted shape."""
    from sniper_tpu_torch.convert import _LEAF

    state = model.state_dict()

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            key = ".".join(path[1:] + (_LEAF[path[0], k],))
            t = state[key].detach().numpy()
            if k in ("kernel", "conv2_kernel") and t.ndim == 4:
                t = t.transpose(2, 3, 1, 0)  # OIHW -> HWIO
            elif k == "kernel":
                t = t.T
            assert t.shape == tuple(v.shape), (key, t.shape, v.shape)
            out[k] = np.ascontiguousarray(t, np.float32)
        return out

    return {c: walk(dict(t), (c,)) for c, t in shapes.items()}


def zoo_jax_detector(kind, **overrides):
    """The tiny fp32 flax detector of ZOO[kind]."""
    from sniper_tpu.models.detector import SNIPERDetector

    kw = dict(TINY, dtype=jnp.float32, num_rois=TINY["post_nms_top_n"],
              **ZOO[kind], **ZOO_JAX[kind])
    kw.update(overrides)
    return SNIPERDetector(**kw)


def zoo_variables(kind, seed=0, perturb=None, **overrides):
    """Flax variables (NumPy) of ZOO[kind]'s tiny detector: the port's
    seeded init (models/init.py, the flax initialisers' distributions)
    written into the flax tree, then ``perturb(variables)`` when given."""
    from sniper_tpu_torch.models.init import init_detector

    shapes = flax_shapes(zoo_jax_detector(kind, **overrides),
                         jnp.zeros((1, 64, 64, 3), jnp.float32),
                         jnp.asarray([[64.0, 64.0, 1.0]], jnp.float32),
                         train=False)
    model = init_detector(tiny_torch_detector(**ZOO[kind], **overrides),
                          seed=seed)
    variables = port_to_flax(shapes, model)
    return perturb(variables) if perturb else variables
