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

On one CUDA card the step replays a CUDA graph, so that the host no longer
pays for each of the step's launches (R101's: ~3,300). The step's forward,
losses, metrics and backward are captured once per batch signature (the
keys, shapes, dtypes and devices of the batch, and the priorities' or the
sampler's generator: ``batch_signature``) into one graph, and every later
step of that signature copies its batch into the graph's static inputs and
replays it. ``optimizer.step()`` and ``scheduler.step()`` stay eager: the
scheduler sets the lr as a Python float every step, which a capture would
freeze. A step replays only where ``eager_reason`` finds nothing against
it: the batch on a CUDA device, no process group (DDP's hooks and the
BatchNorms' collectives), no hook on the model's modules or parameters (a
replay runs no Python) and GRAPH_WARMUP eager steps of its signature
already taken (cuDNN's first calls, the allocator, the anchors' cache), as
torch asks before a capture. Otherwise the step runs eagerly as above; a
new signature warms up and captures its own graph, which keeps its own
memory pool.

A replayed step:

- leaves the gradients in the graph's tensors (the capture's backward
  assigns each ``.grad`` in the graph's pool, since the gradients are set
  to None before it; the replay overwrites them in place);
- hands back a copy of the metric scalars, so that a later step does not
  overwrite them;
- registers the sampler's ``generator`` with the graph (without
  priorities), so that each replay draws anew;
- has ``eager_reason`` None, as the capturing step has. It runs no
  Python, so the hand kernels' own counters (``Kernel.launches``) count
  its capture and not its replays; a device trace holds a replay's
  launches (``cuda.traced_launches``);
- runs inside the span ``graph``: the layer spans inside it do not open,
  and their split comes from the eager steps.

A capture that fails raises; nothing falls back to eager.
"""

from __future__ import annotations

import collections

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

# eager steps of a batch signature before the step captures it
GRAPH_WARMUP = 3


def eager_reason(on_cuda: bool, in_group: bool, hooked: bool,
                 eager_steps: int) -> str | None:
    """Why a step runs eagerly, or None where it replays its signature's
    graph (module doc): ``on_cuda``, every tensor of the batch and the
    priorities on a CUDA device; ``in_group``, a process group is
    initialised; ``hooked``, the model has hooks; ``eager_steps``, the
    eager steps its batch signature has taken."""
    if not on_cuda:
        return "the batch is not on a CUDA device"
    if in_group:
        return "a process group (DDP's hooks, the BatchNorms' collectives)"
    if hooked:
        return "hooks on the model"
    if eager_steps < GRAPH_WARMUP:
        return (f"warm-up: {eager_steps} of {GRAPH_WARMUP} eager steps of "
                f"the batch signature")
    return None


def batch_signature(batch: dict, priorities) -> tuple:
    """What a captured step is specific to: each batch entry's key, shape,
    dtype and device, and the priorities' shapes, dtypes and devices (None
    where the sampler draws from its generator)."""
    def of(t):
        return ((tuple(t.shape), t.dtype, t.device)
                if isinstance(t, torch.Tensor) else type(t))

    return (tuple((k, of(v)) for k, v in sorted(batch.items())),
            None if priorities is None else tuple(of(p) for p in priorities))


def _on_cuda(batch: dict, priorities) -> bool:
    return all(isinstance(t, torch.Tensor) and t.is_cuda
               for t in (*batch.values(), *(priorities or ())))


def _hooked(modules, params=()) -> bool:
    """Whether a hook would run in the forward or backward of ``modules``
    (a model's, listed): their own forward and backward hooks, the global
    ones, or the tensor hooks of ``params``."""
    g = torch.nn.modules.module
    if (g._global_forward_hooks or g._global_forward_pre_hooks
            or g._global_backward_hooks or g._global_backward_pre_hooks):
        return True
    return (any(m._forward_hooks or m._forward_pre_hooks or m._backward_hooks
                or m._backward_pre_hooks for m in modules)
            or any(p._backward_hooks or p._post_accumulate_grad_hooks
                   for p in params))


class _StepGraph:
    """One batch signature's forward, losses, metrics and backward as a
    CUDA graph: its static inputs, its metrics and the gradient tensors
    its backward writes."""

    def __init__(self, forward_backward, batch, priorities, generator,
                 params):
        self.inputs = {k: v.clone() for k, v in batch.items()}
        self.priorities = (None if priorities is None
                           else tuple(p.clone() for p in priorities))
        self.graph = torch.cuda.CUDAGraph()
        if priorities is None and generator is not None:
            self.graph.register_generator_state(generator)
        # thread_local: the chip loader's threads keep uploading batches
        # (pinned copies on the default stream) while the step captures
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.metrics = {k: v.detach() for k, v in forward_backward(
                self.inputs, self.priorities).items()}
        self.params = params
        self.grads = [p.grad for p in params]

    def load(self, batch, priorities):
        for k, v in batch.items():
            self.inputs[k].copy_(v)
        for dst, src in zip(self.priorities or (), priorities or ()):
            dst.copy_(src)

    def bind_grads(self):
        for p, g in zip(self.params, self.grads):
            p.grad = g


class TrainStep:
    """The step of ``make_train_step``: ``step(batch, priorities=None) ->
    metrics`` (module doc). ``graphs`` maps each captured batch signature
    to its graph; ``eager_reason`` is why the last step ran eagerly (None
    where it replayed)."""

    def __init__(self, model, optimizer, scheduler, batch_images, *,
                 rpn_batch_size, pixel_means, generator, rpn_only,
                 ohem_rois):
        self.model, self.optimizer, self.scheduler = (model, optimizer,
                                                      scheduler)
        self.batch_images, self.rpn_batch_size = batch_images, rpn_batch_size
        self.pixel_means, self.generator = pixel_means, generator
        self.rpn_only, self.ohem_rois = rpn_only, ohem_rois
        # DDP averages the ranks' gradients, and each rank's loss is its
        # share of the one global loss: scaled by the world size, the
        # average is the sum, the gradient of the global loss (x 1 without
        # a group)
        self.world = world_size()
        # listed once: walking the tree costs the host more than the check
        self.modules = list(model.modules())
        self.params = list(model.parameters())
        self.graphs: dict = {}
        self.eager_steps = collections.Counter()
        self.eager_reason: str | None = None
        self._bound = None  # the graph whose gradients the parameters hold

    def __call__(self, batch, priorities=None):
        sig = batch_signature(batch, priorities)
        self.eager_reason = eager_reason(
            _on_cuda(batch, priorities), is_distributed(),
            _hooked(self.modules, self.params),
            self.eager_steps[sig])
        if self.eager_reason is None:
            return self._replay(sig, batch, priorities)
        self.eager_steps[sig] += 1
        self._bound = None
        loss, metrics = self._forward(batch, priorities)
        with span("optimizer"):
            self.optimizer.zero_grad(set_to_none=True)
        with span("backward"):
            (loss * self.world).backward()
        self._update()
        return {k: v.detach() for k, v in metrics.items()}

    def _forward(self, batch, priorities):
        data = batch["data"]
        if data.dtype == torch.uint8:
            if self.pixel_means is None:
                # zero means would silently train on raw pixels
                raise ValueError(
                    "uint8 batch but make_train_step got no pixel_means: "
                    "pass cfg.network.PIXEL_MEANS")
            data = device_normalize(data, batch["data_extent"],
                                    self.pixel_means)
        self.model.train()
        out = self.model(data, batch["im_info"], batch["gt_boxes"],
                         batch["valid_ranges"], gt_masks=batch.get("gt_masks"),
                         train=True, generator=self.generator,
                         priorities=priorities)
        with span("loss"):
            loss, metrics = total_loss(out, batch, self.batch_images,
                                       self.rpn_batch_size,
                                       rpn_only=self.rpn_only,
                                       ohem_rois=self.ohem_rois)
            if not self.rpn_only:
                labels = out["rcnn_labels"]
                pred = out["cls_score"].detach().argmax(-1)
                valid = labels >= 0
                n_valid = global_count(valid.sum()).clamp_min(1)
                metrics["rcnn_acc"] = (((pred == labels) & valid).sum()
                                       / n_valid)
                metrics["rcnn_fg_frac"] = (labels > 0).sum() / n_valid
            metrics.update(out["stats"])
        return loss, metrics

    def _forward_backward(self, batch, priorities):
        loss, metrics = self._forward(batch, priorities)
        with span("backward"):
            (loss * self.world).backward()
        return metrics

    def _update(self):
        with span("optimizer"):
            self.optimizer.step()
            self.scheduler.step()

    def _replay(self, sig, batch, priorities):
        g = self.graphs.get(sig)
        fresh = g is None
        if fresh:
            # the capture's backward assigns each gradient in the graph's
            # pool
            self.optimizer.zero_grad(set_to_none=True)
            params = [p for group in self.optimizer.param_groups
                      for p in group["params"]]
            g = self.graphs[sig] = _StepGraph(
                self._forward_backward, batch, priorities, self.generator,
                params)
            self._bound = g
        with span("graph"):
            if not fresh:
                if self._bound is not g:
                    g.bind_grads()
                    self._bound = g
                g.load(batch, priorities)
            g.graph.replay()
            metrics = {k: v.clone() for k, v in g.metrics.items()}
        self._update()
        return metrics


def make_train_step(model, optimizer, scheduler, batch_images: int, *,
                    rpn_batch_size: int = 256, pixel_means=None,
                    generator: torch.Generator | None = None,
                    rpn_only: bool = False, ohem_rois: int = 0) -> TrainStep:
    """Returns step(batch, priorities=None) -> metrics. ``batch`` is a dict
    of tensors on the model's device (the chip loader's keys);
    ``priorities`` replace the sampler's draws from ``generator`` (see
    ops/proposals.multi_proposal_target). ``batch_images`` is the global
    batch under data parallelism (module doc). ``ohem_rois`` > 0 trains
    the R-CNN terms on each image's hardest rois only (models/losses.py,
    TRAIN.BATCH_ROIS_OHEM under TRAIN.ENABLE_OHEM)."""
    return TrainStep(model, optimizer, scheduler, batch_images,
                     rpn_batch_size=rpn_batch_size, pixel_means=pixel_means,
                     generator=generator, rpn_only=rpn_only,
                     ohem_rois=ohem_rois)


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
