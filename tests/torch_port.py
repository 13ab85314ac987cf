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
