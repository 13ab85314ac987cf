"""The system under test: the port's detector, built from a benchmark
configuration and loaded with the benchmark's weights.

This module is the harness's one door into ``sniper_tpu_torch``: the
config tree, the registry, and the kernel library's build state. The
drivers reach the port's entries (``make_forward``, the Tester,
``make_train_step``, ``make_optimizer``) themselves.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.core.weights import make_weights
from benchmark.reference.model import Detector


def program_cfg(config: dict):
    """The port's config tree: its defaults, then the configuration's
    ``yml`` section by section as the port's yml loader merges a file,
    then its ``symbol``."""
    from sniper_tpu_torch.config import AttrDict, default_config

    cfg = default_config()
    for k, v in config["yml"].items():
        if isinstance(v, dict):
            for vk, vv in v.items():
                if vk == "PIXEL_MEANS":
                    vv = np.array(vv, dtype=np.float64)
                cfg[k][vk] = AttrDict(vv) if isinstance(vv, dict) else vv
        else:
            cfg[k] = v
    cfg.symbol = config["symbol"]
    return cfg


def reference_model(config: dict, device="meta") -> Detector:
    """The reference detector of the configuration (fp32)."""
    with torch.device(device):
        return Detector(config["yml"], trunk=config["trunk"],
                        units=tuple(config.get("units", (3, 4, 23, 3))))


def seeded_weights(config: dict, seed: int, device) -> dict:
    return make_weights(reference_model(config), seed, device)


def program_model(config: dict, seed: int, device):
    """(cfg, the port's registry detector with the seed's weights), built
    on ``device`` itself: its modules' own initializers run there rather
    than on the host, and are then overwritten."""
    from sniper_tpu_torch.models.registry import get_model

    cfg = program_cfg(config)
    overrides = {}
    if "units" in config:
        overrides["units"] = tuple(config["units"])
    with torch.device(device):
        model = get_model(cfg, **overrides)
    weights = seeded_weights(config, seed, device)
    missing, unexpected = model.load_state_dict(weights, strict=False)
    if unexpected or missing:
        raise KeyError(f"weights do not fit the program: missing "
                       f"{missing[:5]}, unexpected {unexpected[:5]}")
    del weights
    return cfg, model


def kernels_built() -> bool:
    """Whether the port's kernel library for these sources exists yet."""
    from sniper_tpu_torch.ops import cuda

    return cuda.library_path().exists()

