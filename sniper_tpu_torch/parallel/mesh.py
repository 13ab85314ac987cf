"""Where the model lives under data parallelism: DDP for training, replicas
for inference.

Port of sniper_tpu/parallel/mesh.py. The JAX package lays a 1-D mesh over
its devices (``make_mesh``), splits each batch along dim 0 over it
(``shard_batch``), replicates the variables (``replicate``) and lets XLA's
partitioner insert the gradient all-reduce. Here each card is a rank of
its own process (parallel/distributed.py):

- ``make_mesh``'s counterpart is the process group, one card per rank
  (``cuda:LOCAL_RANK``, or ``cuda:<rank>`` under ``distributed.launch``);
- ``shard_batch``'s is the rank's own loader over its roidb slice, which
  fills that rank's card alone (main_train);
- training's ``replicate`` is ``data_parallel``: DDP broadcasts rank 0's
  parameters when it wraps the model and all-reduces the gradients;
- inference's ``replicate`` is ``replicate``: a copy of the eval model on
  each device of a list, over which main_test.make_forward splits a batch.
"""

from __future__ import annotations

import copy

import torch
from torch.nn.parallel import DistributedDataParallel


def data_parallel(model: torch.nn.Module, device) -> DistributedDataParallel:
    """``model`` (on ``device``, its frozen parameters already marked with
    requires_grad=False) wrapped for the process group's training step.

    - ``broadcast_buffers=False``: the BatchNorms' running statistics come
      out equal on every rank by construction, from the all-reduced batch
      statistics in "sync" mode and from the all-reduced mean of the
      ranks' statistics in "local" mode (models/norm.py). DDP's default
      would overwrite them with rank 0's at every forward, which in "local"
      mode is not the JAX package's update.
    - ``find_unused_parameters=False``: every trainable parameter gets a
      gradient at every step of box, RPN-only, mask and AutoFocus training
      (tests/test_torch_dp_step.py holds this), so DDP need not walk the
      graph after each forward.

    What the wrapper costs a rank's step: scripts/profile_torch_ddp.py.
    """
    device = torch.device(device)
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False, find_unused_parameters=False)


def replicate(model: torch.nn.Module, devices) -> list:
    """One eval replica of ``model`` per entry of ``devices``: ``model``
    itself moved to the first, a copy on each of the others (several may
    name the same device)."""
    devices = [torch.device(d) for d in devices]
    model.to(devices[0]).eval()
    return [model] + [copy.deepcopy(model).to(d).eval() for d in devices[1:]]
