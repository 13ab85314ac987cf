"""Optimizer and learning-rate schedule of the reference training recipe.

Port of sniper_tpu/train/optimizer.py:21-86. The optax chain there is,
in order: weight decay added to the gradient (masked to the trainable
parameters), momentum as a trace (``t = g + 0.9 t``, not Nesterov), the
learning rate ``schedule(count)`` at the step count *before* the step, and
a zero update for the frozen parameters. ``torch.optim.SGD(momentum,
weight_decay, dampening=0)`` applies the same order: ``d = g + wd p``,
``t = 0.9 t + d``, ``p -= lr t``. Its ``LambdaLR`` reads the count the same
way: step k runs at ``schedule(k)`` (a base lr of 1 times the lambda).

Frozen parameters (``network.FIXED_PARAMS``, prefix matching on every
component of the parameter's name, so ``stage1`` freezes every
``stage1_unit*``) are left out of the optimizer and get
``requires_grad=False``: no update and no weight decay.
"""

from __future__ import annotations

import numpy as np
import torch


def warmup_multistep(base_lr, warmup_lr, warmup_step, steps, factor=0.1):
    """Linear warmup then step decay; ``steps`` are absolute iterations.
    Computed in fp32, as the JAX schedule is."""
    f32 = np.float32

    def schedule(count):
        count = f32(count)
        frac = np.clip(count / f32(max(warmup_step, 1)), f32(0), f32(1))
        lr = f32(warmup_lr) + (f32(base_lr) - f32(warmup_lr)) * frac
        if count < warmup_step:
            return float(lr)
        n_decays = sum(1 for s in steps if count >= s)
        return float(f32(base_lr) * f32(factor) ** f32(n_decays))

    return schedule


def lr_step_iters(lr_step: str, epoch_size: int) -> list[int]:
    """'5.33' or '4,6' epoch fractions -> absolute iteration counts."""
    if not lr_step:
        return []
    return [int(float(s) * epoch_size) for s in str(lr_step).split(",")]


def is_fixed(name: str, fixed_prefixes) -> bool:
    """True when a component of the dotted parameter name starts with one
    of the FIXED_PARAMS prefixes."""
    prefixes = tuple(fixed_prefixes or ())
    return any(part.startswith(prefixes) for part in name.split("."))


def make_optimizer(cfg, epoch_size: int, model: torch.nn.Module):
    """SGD + LambdaLR reproducing the reference recipe on ``model``'s
    trainable parameters (the frozen ones get requires_grad=False).
    Returns (optimizer, lr scheduler, schedule)."""
    steps = lr_step_iters(cfg.TRAIN.lr_step, epoch_size)
    schedule = warmup_multistep(
        cfg.TRAIN.lr,
        cfg.TRAIN.warmup_lr if cfg.TRAIN.warmup else cfg.TRAIN.lr,
        cfg.TRAIN.warmup_step if cfg.TRAIN.warmup else 0,
        steps,
        cfg.TRAIN.lr_factor,
    )
    params = []
    for name, p in model.named_parameters():
        if is_fixed(name, cfg.network.FIXED_PARAMS):
            p.requires_grad_(False)
        else:
            params.append(p)
    opt = torch.optim.SGD(params, lr=1.0, momentum=cfg.TRAIN.momentum,
                          dampening=0.0, weight_decay=cfg.TRAIN.wd,
                          nesterov=False)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule), schedule
