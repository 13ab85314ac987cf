"""The training run's logger (the reference's utils.create_logger,
utils.py:120-142; sniper_tpu/utils/logger.py): to stdout and to
``<output_path>/<cfg_name>/<image_set>/<cfg_name>_<time>.log``."""

from __future__ import annotations

import logging
import os
import time


def create_logger(output_path: str, cfg_name: str, image_set: str):
    """Returns (the logger, its directory)."""
    out_dir = os.path.join(output_path, cfg_name, image_set)
    os.makedirs(out_dir, exist_ok=True)
    ts = time.strftime("%Y-%m-%d-%H-%M")
    logger = logging.getLogger(f"sniper_tpu_torch.{cfg_name}")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(message)s")
    for h in (logging.FileHandler(os.path.join(out_dir,
                                               f"{cfg_name}_{ts}.log")),
              logging.StreamHandler()):
        h.setFormatter(fmt)
        logger.addHandler(h)
    logger.propagate = False
    return logger, out_dir
