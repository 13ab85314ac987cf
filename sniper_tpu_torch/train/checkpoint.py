"""Checkpoints: one ``torch.save`` file per epoch.

Port of sniper_tpu/train/checkpoint.py (orbax there): the model's
state_dict, the optimizer's and the lr scheduler's state and the step
count, written to ``<ckpt_dir>/epoch_<n>.pt`` after epoch n-1 ends (the
JAX package's numbering), so ``TRAIN.begin_epoch = n`` resumes from it.
The file is written under a temporary name and renamed, so a cut run never
leaves a truncated checkpoint under the final name.

``restore_inference_state`` is the inference CLI's restore
(checkpoint.py:50-98 ``restore_inference_variables``): the run's own
checkpoint, else ``network.pretrained``, else the seeded init.
"""

from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"^epoch_(\d+)\.pt$")


def checkpoint_path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"epoch_{epoch:04d}.pt")


def save_checkpoint(ckpt_dir: str, epoch: int, model, optimizer=None,
                    scheduler=None, step: int = 0) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, epoch)
    state = {"model": model.state_dict(), "step": int(step),
             "epoch": int(epoch)}
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()
    if scheduler is not None:
        state["scheduler"] = scheduler.state_dict()
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def latest_epoch(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    epochs = [int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir))
              if m]
    return max(epochs) if epochs else None


def load_checkpoint(ckpt_dir: str, model, optimizer=None, scheduler=None,
                    epoch: int | None = None) -> int:
    """Restore the epoch's checkpoint (the latest when None) into the given
    objects; returns the step count it was saved at."""
    if epoch is None:
        epoch = latest_epoch(ckpt_dir)
    if epoch is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    state = torch.load(checkpoint_path(ckpt_dir, epoch), map_location="cpu",
                       weights_only=True)
    model.load_state_dict(state["model"])
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    if scheduler is not None:
        scheduler.load_state_dict(state["scheduler"])
    return state["step"]


def restore_inference_state(cfg, model, cfg_name: str, log=print) -> str:
    """Fill ``model`` for inference by priority, as the JAX CLI does:

    1. ``<output_path>/<cfg_name>/<dataset.image_set>/checkpoints/`` holds
       checkpoints: the one of epoch TEST.TEST_EPOCH (the latest when 0).
       Its state_dict loads strictly, so a checkpoint of another topology
       (an RPN-only one into a full detector) raises;
    2. else ``network.pretrained`` (train/pretrained.py:load_pretrained);
    3. else the seeded init (models/init.py, seed 0 as the JAX CLI's key).

    Returns which of "checkpoint", "pretrained" and "init" it took."""
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.train.pretrained import load_pretrained

    init_detector(model, seed=0)
    ckpt_dir = os.path.join(cfg.output_path or "./output", cfg_name,
                            str(cfg.dataset.image_set), "checkpoints")
    if os.path.isdir(ckpt_dir):
        epoch = int(cfg.TEST.TEST_EPOCH) or None
        load_checkpoint(ckpt_dir, model, epoch=epoch)
        log(f"restored checkpoint from {ckpt_dir} (epoch "
            f"{epoch or latest_epoch(ckpt_dir)})")
        return "checkpoint"
    if load_pretrained(cfg, model, log) is not None:
        return "pretrained"
    log("no checkpoint found; using random init")
    return "init"
