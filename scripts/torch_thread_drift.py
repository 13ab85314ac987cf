"""How far the port's MobileNetV2 trunk in training mode drifts from flax,
and from itself in float64, at each torch thread count on the CPU.

The inputs and weights are tests/test_torch_zoo.py's
(``test_trunk_matches_flax[mobilenetv2-True]``: full width, 2 x 128 x 128,
seeded perturbed variables). The port runs in fp32 at each count of
``--threads``, then again with only its training BatchNorms in float64; the
reference is the port in float64. The check's bound is its atol, 1e-4 of
flax's largest magnitude (tests/torch_port.py:close_to_scale).

    JAX_PLATFORMS=cpu python scripts/torch_thread_drift.py
"""

import argparse
import copy
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "tests"), str(ROOT)]


def port_c4(tm, x, threads, dtype, bn64=False):
    """The port's c4 [N,H,W,C] as float64 at ``threads`` torch threads, the
    trunk in ``dtype`` (its BatchNorms' statistics and output in float64
    with ``bn64``)."""
    import torch

    from sniper_tpu_torch.models.norm import TrainBatchNorm

    torch.set_num_threads(threads)
    m = copy.deepcopy(tm).to(dtype).train()
    for mod in m.modules():
        if getattr(mod, "dtype", None) is not None:
            mod.dtype = dtype
    if bn64:
        for mod in m.modules():
            if isinstance(mod, TrainBatchNorm):
                mod.forward = lambda h, bn=mod: torch.native_batch_norm(
                    h.double(), bn.weight.double(), bn.bias.double(), None,
                    None, True, 0.0, bn.eps)[0].to(h.dtype)
    with torch.no_grad():
        c4, _ = m(torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2))
    return c4.permute(0, 2, 3, 1).double().numpy()


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4, 8])
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    import test_torch_zoo

    jm, variables, tm, x = test_torch_zoo._trunks(
        "mobilenetv2", np.random.RandomState(0))
    (jc4, _), _ = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats", "intermediates"]))(
            variables, jnp.asarray(x))
    jc4 = np.asarray(jc4, np.float64)
    atol = 1e-4 * np.abs(jc4).max()
    ref = port_c4(tm, x, max(args.threads), torch.float64)
    print(f"bound (atol) {atol:.4g}; flax fp32 from the port in float64 "
          f"{np.abs(jc4 - ref).max():.4g}")
    for t in args.threads:
        for bn64 in (False, True):
            got = port_c4(tm, x, t, torch.float32, bn64)
            over = np.abs(got - jc4) > atol + 1e-4 * np.abs(jc4)
            print(f"threads {t}{', BatchNorms float64' if bn64 else ''}: "
                  f"from float64 {np.abs(got - ref).max():.4g}, from flax "
                  f"{np.abs(got - jc4).max():.4g}, {int(over.sum())} of "
                  f"{over.size} over the bound")


if __name__ == "__main__":
    main()
