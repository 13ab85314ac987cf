"""The training step, on one device or one rank of a process group.

Port of sniper_tpu/train/trainer.py:82-182: uint8 batches
are mean-subtracted on the device over each chip's ``data_extent``, then
the detector's training forward, ``total_loss``, the backward, one SGD
step and the lr scheduler's step. The BatchNorms of stages 2-4 update their
running statistics in the forward (models/norm.py:TrainBatchNorm), as the
JAX step's mutated ``batch_stats`` do.

The step returns its metrics as 0-d device tensors and never waits for the
device: the losses, ``rcnn_acc``, ``rcnn_fg_frac``, the head's offset
telemetry and the trunk's ``dcn_offset_max`` (with ``rpn_only``, the RPN
losses and the trunk's telemetry only, as trainer.py:128-145; with the
model's AutoFocus head and a batch with ``scale_label``, also
``focus_loss``; with the model's mask branch, also ``mask_loss``; under
OHEM, ``rcnn_acc`` and ``rcnn_fg_frac`` over the sampled rois, as JAX's,
which count before the selection). The
batch's uint8 ``gt_masks`` go to the model as they are: it casts them
where it crop-resizes. The caller reads them when it logs. The sampler draws from an explicit
``torch.Generator`` on the device.

Data parallel (parallel/): the model is DDP-wrapped, each rank steps on its
own shard of the global batch, and ``batch_images`` is the global batch
(BATCH_IMAGES x ranks), which the box losses divide by, as JAX's
``batch_images_global``. Each rank's loss is its share of the global loss
(models/losses.py), and its metrics are shares too: the losses,
``rcnn_acc`` and ``rcnn_fg_frac`` (their denominator is the global valid
roi count) add up over the ranks, the ``*_max`` telemetry takes the ranks'
maximum and the rest their mean. ``reduce_metrics`` does that at a log
boundary, so the step itself never waits for the other ranks' metrics.

Under a profiler the step's layers are spans (utils/profiler.span): the
detector's own, then ``loss`` (the losses and the accuracy metrics),
``backward`` and ``optimizer`` (zero_grad, then the SGD and scheduler
steps after the backward).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from sniper_tpu_torch.infer.tester import device_normalize
from sniper_tpu_torch.models.losses import total_loss
from sniper_tpu_torch.parallel.distributed import (
    global_count,
    is_distributed,
    world_size,
)
from sniper_tpu_torch.utils.profiler import span


def make_train_step(model, optimizer, scheduler, batch_images: int, *,
                    rpn_batch_size: int = 256, pixel_means=None,
                    generator: torch.Generator | None = None,
                    rpn_only: bool = False, ohem_rois: int = 0):
    """Returns step(batch, priorities=None) -> metrics. ``batch`` is a dict
    of tensors on the model's device (the chip loader's keys);
    ``priorities`` replace the sampler's draws from ``generator`` (see
    ops/proposals.multi_proposal_target). ``batch_images`` is the global
    batch under data parallelism (module doc). ``ohem_rois`` > 0 trains
    the R-CNN terms on each image's hardest rois only (models/losses.py,
    TRAIN.BATCH_ROIS_OHEM under TRAIN.ENABLE_OHEM)."""
    # DDP averages the ranks' gradients, and each rank's loss is its share
    # of the one global loss: scaled by the world size, the average is the
    # sum, the gradient of the global loss (x 1 without a group)
    world = world_size()

    def step(batch, priorities=None):
        data = batch["data"]
        if data.dtype == torch.uint8:
            if pixel_means is None:
                # zero means would silently train on raw pixels
                raise ValueError(
                    "uint8 batch but make_train_step got no pixel_means: "
                    "pass cfg.network.PIXEL_MEANS")
            data = device_normalize(data, batch["data_extent"], pixel_means)
        model.train()
        out = model(data, batch["im_info"], batch["gt_boxes"],
                    batch["valid_ranges"], gt_masks=batch.get("gt_masks"),
                    train=True, generator=generator, priorities=priorities)
        with span("loss"):
            loss, metrics = total_loss(out, batch, batch_images,
                                       rpn_batch_size, rpn_only=rpn_only,
                                       ohem_rois=ohem_rois)
            if not rpn_only:
                labels = out["rcnn_labels"]
                pred = out["cls_score"].detach().argmax(-1)
                valid = labels >= 0
                n_valid = global_count(valid.sum()).clamp_min(1)
                metrics["rcnn_acc"] = (((pred == labels) & valid).sum()
                                       / n_valid)
                metrics["rcnn_fg_frac"] = (labels > 0).sum() / n_valid
            metrics.update(out["stats"])
        with span("optimizer"):
            optimizer.zero_grad(set_to_none=True)
        with span("backward"):
            (loss * world).backward()
        with span("optimizer"):
            optimizer.step()
            scheduler.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step


def _is_share(name: str) -> bool:
    return name.endswith("loss") or name in ("rcnn_acc", "rcnn_fg_frac")


def reduce_metrics(steps: list) -> list:
    """The global metrics of a list of steps' metric dicts (0-d device
    tensors, the same keys in each) over the ranks of a process group: the
    shares summed, ``*_max`` the maximum, the rest the mean (module doc).
    Two all-reduces for the whole list; a collective, so every rank calls
    it at the same step. Without a group the dicts are returned as they
    are."""
    if not steps or not is_distributed():
        return steps
    keys = sorted(steps[0])
    t = torch.stack([torch.stack([m[k].float() for k in keys])
                     for m in steps])
    top = t.clone()
    dist.all_reduce(t)
    dist.all_reduce(top, op=dist.ReduceOp.MAX)
    world = dist.get_world_size()
    out = []
    for row, row_max in zip(t, top):
        out.append({k: (row_max[i] if k.endswith("_max") else
                        row[i] if _is_share(k) else row[i] / world)
                    for i, k in enumerate(keys)})
    return out


def to_device(batch: dict, device) -> dict:
    """NumPy batch -> tensors on ``device``; on a CUDA device through
    pinned memory with non-blocking copies (the transfer overlaps the
    step before it)."""
    cuda = torch.device(device).type == "cuda"
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if cuda:
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=cuda)
    return out
