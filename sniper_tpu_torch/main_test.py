"""SNIPER inference / evaluation CLI on one CUDA device, or data-parallel
over several.

Port of main_test.py:52-341 (``make_forward``, ``_scale_post_nms``,
``_test_num_devices``, ``run_detection``, ``run_proposal_extraction``):
multi-scale detection over TEST.SCALES with the
per-scale post-NMS roi counts of a list-valued TEST.N_PROPOSAL_PER_SCALE,
aggregation with per-scale valid ranges and soft-NMS, then the dataset's
evaluation. A detector with the
mask branch (configs/sniper_res101_e2e_mask.yml) also carries each
detection's mask through aggregation, and the dataset scores both boxes
and masks. With TEST.AUTO_FOCUS (configs/sniper_res101_e2e_autofocus.yml)
the scales run coarse to fine: after every scale but the last, the
FocusPixel maps of its chips become the next scale's FocusChips
(chips/autofocus.add_chips), which the test iterator bins into the
smallest canvas tier that holds them. The model zoo serves the same way:
ResNeXt-101 with ``--set symbol resnext_mx_101`` on the flagship yml,
MobileNetV2 with configs/sniper_mobilenetv2_e2e.yml (stride 32).

  python -m sniper_tpu_torch.main_test --cfg configs/sniper_res101_e2e.yml \\
      [--weights model.pt] [--set TEST.EXTRACT_PROPOSALS True ...]

``--weights`` is a ``torch.save``d state_dict of the port's detector (for a
flax checkpoint: ``sniper_tpu_torch.convert.convert``). Without it,
``train.checkpoint.restore_inference_state`` restores the training run's
checkpoint of epoch TEST.TEST_EPOCH, else ``network.pretrained``, else the
seeded init. TEST.EXTRACT_PROPOSALS (with TRAIN.ONLY_PROPOSAL) runs the
RPN over ``dataset.test_image_set`` at every TEST.SCALES entry and writes
``<TEST.PROPOSAL_SAVE_PATH>/<dataset name>_rpn.pkl``, the proposals that
training's negative-chip mining reads.

``--set parallel.num_devices N`` (N > 1; an explicit opt-in, -1 is one
device, as in the JAX CLI) serves data-parallel: each batch splits along
dim 0 over eval replicas on the cards 0..N-1 (N replicas on the CPU), and
every scale's TEST.BATCH_IMAGES must then be a multiple of N.

On one CUDA card the forward of ``make_forward`` replays a CUDA graph, so
that the host no longer launches each batch's kernels one by one (R101's
~650 a batch). ``device_normalize`` and the detector's inference forward
are captured once per input signature (``forward_signature``: the data's
shape, dtype and device, im_info's shape and dtype; the post-NMS count is
the forward's own), on the signature's second call, and every later call
of that signature copies its batch into the graph's static inputs and
replays it. A call runs eagerly where ``eager_reason`` finds something
against a replay: the forward's device not a CUDA card, several replicas
(the batch splits and joins), a hook on the model's modules or a global
one (a replay runs no Python, so no hook would fire), or the signature's
first call (cuDNN's first calls, the anchors' cache, the means, the
allocator). A capture that fails raises; nothing falls back to eager.

A replayed call:

- copies ``data`` and ``im_info`` into the graph's static inputs (a host
  batch through pinned memory, outside the graph) and returns clones of
  the captured outputs, which the next replay leaves alone;
- shares one memory pool with the forward's other graphs: the replays run
  one at a time on one stream, and each one's outputs are cloned before
  the next one runs;
- sets ``models/detector.MASK_ROIS`` to the count its capture left (the
  same B x N rois the graph's mask branch runs on);
- runs no kernel wrapper, so the hand kernels' counters
  (``Kernel.launches``) count the eager calls and the captures and not the
  replays, whose launches a device trace holds
  (``ops/cuda.traced_launches``);
- runs inside the span ``graph``: the layer spans ``trunk``, ``rpn``,
  ``head`` and ``mask`` open in eager and capturing calls only; a no-op
  hook on the model keeps the forward eager where the layers' split is
  wanted.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import pickle

import numpy as np
import torch

from sniper_tpu_torch.chips.autofocus import add_chips
from sniper_tpu_torch.data.test_loader import (
    TestChipIterator,
    init_inference_crops,
)
from sniper_tpu_torch.infer.tester import Tester, device_normalize
from sniper_tpu_torch.models import detector
from sniper_tpu_torch.parallel.mesh import replicate
from sniper_tpu_torch.train.trainer import _hooked
from sniper_tpu_torch.utils.profiler import span


def forward_signature(data: torch.Tensor, im_info: torch.Tensor) -> tuple:
    """What a captured forward is specific to (module doc): the data's
    shape, dtype and device, and im_info's shape and dtype."""
    return (tuple(data.shape), data.dtype, data.device,
            tuple(im_info.shape), im_info.dtype)


def eager_reason(on_cuda: bool, replicas: int, hooked: bool,
                 seen: bool) -> str | None:
    """Why a forward call runs eagerly, or None where it replays its input
    signature's graph, capturing it first where it has none (module doc):
    ``on_cuda``, the forward runs on a CUDA device; ``replicas``, how many
    the batch splits over; ``hooked``, the model has hooks; ``seen``, an
    earlier call had the input signature."""
    if not on_cuda:
        return "the forward's device is not a CUDA device"
    if replicas > 1:
        return f"{replicas} replicas (the batch splits and joins)"
    if hooked:
        return "hooks on the model"
    if not seen:
        return "the first call of the input signature"
    return None


class _ForwardGraph:
    """One input signature's ``device_normalize`` and detector forward as
    a CUDA graph: its static inputs, its outputs and the mask roi count
    (``detector.MASK_ROIS``) that its capture left."""

    def __init__(self, run, data, im_info, device, pool):
        self.data = torch.empty(data.shape, dtype=data.dtype, device=device)
        self.im_info = torch.empty(im_info.shape, dtype=im_info.dtype,
                                   device=device)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the Tester's prefetch thread keeps assembling host
        # batches while the forward captures
        with torch.cuda.graph(self.graph, pool=pool,
                              capture_error_mode="thread_local"):
            self.outputs = run(self.data, self.im_info)
        self.mask_rois = detector.MASK_ROIS

    def load(self, data, im_info):
        self.data.copy_(data, non_blocking=True)
        self.im_info.copy_(im_info)

    def replay(self, data, im_info) -> dict:
        self.load(data, im_info)
        self.graph.replay()
        detector.MASK_ROIS = self.mask_rois
        return {k: v.clone() for k, v in self.outputs.items()}


class Forward:
    """The forward of ``make_forward``: ``forward(data, im_info) -> the
    detector's outputs``. ``graphs`` maps each captured input signature to
    its graph; ``eager_reason`` is why the last call ran eagerly (None
    where it replayed, the capturing call's included)."""

    def __init__(self, replicas, devices, pixel_means, post_nms_top_n):
        self.replicas, self.devices = replicas, devices
        self.pixel_means, self.post_nms_top_n = pixel_means, post_nms_top_n
        # listed once: walking the tree costs the host more than the check
        self.modules = list(replicas[0].modules())
        self.graphs: dict = {}
        self.seen: set = set()
        self.pool = None  # the graphs' memory pool, made at the first capture
        self.eager_reason: str | None = None

    def _run(self, replica, device, data, im_info):
        cuda = device.type == "cuda"
        # the kernels launch on the current card's stream
        with torch.cuda.device(device) if cuda else contextlib.nullcontext():
            if cuda and not data.is_cuda:
                data = data.pin_memory()
            data = data.to(device, non_blocking=True)
            im_info = im_info.to(device)
            data = device_normalize(data, im_info, self.pixel_means)
            return replica(data, im_info, post_nms_top_n=self.post_nms_top_n)

    @torch.inference_mode()
    def __call__(self, data, im_info):
        data = torch.as_tensor(data)
        im_info = torch.as_tensor(im_info, dtype=torch.float32)
        n = len(self.replicas)
        sig = forward_signature(data, im_info)
        self.eager_reason = eager_reason(
            self.devices[0].type == "cuda", n, _hooked(self.modules),
            sig in self.seen)
        if self.eager_reason is None:
            return self._replay(sig, data, im_info)
        self.seen.add(sig)
        if n == 1:
            return self._run(self.replicas[0], self.devices[0], data, im_info)
        if data.shape[0] % n:
            raise ValueError(
                f"test batch {data.shape[0]} not divisible by {n} devices "
                "(set TEST.BATCH_IMAGES to a multiple of "
                "parallel.num_devices)")
        outs = [self._run(r, d, x, i) for r, d, x, i in zip(
            self.replicas, self.devices, data.chunk(n), im_info.chunk(n))]
        joined = {k: torch.cat([o[k].to(self.devices[0]) for o in outs])
                  for k in outs[0]}
        # each replica numbers its images from 0
        shard = data.shape[0] // n
        first = torch.arange(0, data.shape[0], shard, device=self.devices[0])
        joined["rois"][..., 0] += first.repeat_interleave(shard)[:, None]
        return joined

    def _replay(self, sig, data, im_info):
        device = self.devices[0]
        if not data.is_cuda:
            data = data.pin_memory()
        with torch.cuda.device(device):
            g = self.graphs.get(sig)
            if g is None:
                if self.pool is None:
                    self.pool = torch.cuda.graph_pool_handle()
                g = self.graphs[sig] = _ForwardGraph(
                    functools.partial(self._run, self.replicas[0], device),
                    data, im_info, device, self.pool)
            with span("graph"):
                return g.replay(data, im_info)


def make_forward(model, state, devices, pixel_means,
                 post_nms_top_n=None) -> Forward:
    """Inference forward on ``devices``: one device, or a list of them with
    one eval replica each (parallel/mesh.replicate; several may name the
    same device). ``state`` (a state_dict, or None when ``model`` already
    holds its weights) is loaded first. Batches arrive as uint8 RGB
    canvases and are mean-subtracted on the device (device_normalize); fp32
    input passes through; batches already on the card are not copied. Over
    N replicas a batch splits along dim 0 into N
    equal shards (ValueError when it does not divide), each replica runs
    its shard, and the outputs are joined on the first device, the rois'
    batch-index column made global (each replica numbers its images from
    0), as main_test.py:94-130. Returns the ``Forward``, whose call
    returns the detector's output dict of device tensors (launches are
    asynchronous: the Tester copies them to the host one batch later). On
    one CUDA card a signature's calls after its first replay a CUDA graph
    (module doc)."""
    if state is not None:
        model.load_state_dict(state)
    if not isinstance(devices, (list, tuple)):
        devices = [devices]
    devices = [torch.device(d) for d in devices]
    return Forward(replicate(model, devices), devices, pixel_means,
                   post_nms_top_n)


def _test_num_devices(cfg) -> int:
    """parallel.num_devices for inference (main_test.py:166-171): an
    explicit opt-in, unlike training, where -1 is every device: each
    scale's batch must divide the count, so fanning out silently would
    break small-batch runs."""
    n = int(cfg.parallel.num_devices)
    return n if n > 1 else 1


def inference_devices(cfg, device) -> list:
    """The devices of the replicas that serve ``cfg`` on ``device``'s kind:
    ``device`` alone, or under parallel.num_devices N > 1 the cards 0..N-1
    (ValueError when fewer are visible), N times the CPU."""
    device = torch.device(device)
    n = _test_num_devices(cfg)
    if n == 1:
        return [device]
    if device.type != "cuda":
        return [device] * n
    visible = torch.cuda.device_count()
    if n > visible:
        raise ValueError(f"parallel.num_devices {n} but {visible} CUDA "
                         "devices are visible")
    return [torch.device("cuda", i) for i in range(n)]


def _scale_post_nms(cfg, s, model):
    """Per-scale post-NMS roi count for test scale ``s``: a list-valued
    TEST.N_PROPOSAL_PER_SCALE gives one count per scale (finest ->
    coarsest); a scalar keeps the model's global count."""
    n = getattr(cfg.TEST, "N_PROPOSAL_PER_SCALE", None)
    if isinstance(n, (list, tuple)):
        if len(n) <= s:
            raise ValueError(
                f"TEST.N_PROPOSAL_PER_SCALE has {len(n)} entries but "
                f"scale index {s} was requested — list it once per "
                "TEST.SCALES entry (finest->coarsest)"
            )
        return int(n[s])
    return int(model.post_nms_top_n)


def _per_scale(value, s):
    return value[s] if isinstance(value, (list, tuple)) else value


def run_detection(cfg, model, state, roidb, dataset, out_dir, device,
                  image_loader=None):
    """Detect at every TEST.SCALES entry, aggregate, evaluate. Returns
    ``dataset.evaluate_detections``'s result, or with the mask branch
    {"bbox": that, "segm": ``dataset.evaluate_segmentations``'s}.
    Under TEST.AUTO_FOCUS every scale but the last keeps its chips'
    FocusPixel maps, and ``add_chips`` replaces each image's
    ``inference_crops`` with the next scale's FocusChips. A scale's
    ``dets_scale{s}.pkl`` keeps its maps, so a run resumed from it makes
    the same chips. ``image_loader`` replaces cv2.imread (tests and
    synthetic runs inject one). Under parallel.num_devices N > 1 the
    forward runs on N replicas (``inference_devices``)."""
    init_inference_crops(roidb)
    if state is not None:
        model.load_state_dict(state)
    with_masks = bool(model.with_mask)
    devices = inference_devices(cfg, device)
    testers: dict = {}

    def get_tester(post_nms):
        if post_nms not in testers:
            testers[post_nms] = Tester(
                make_forward(model, None, devices, cfg.network.PIXEL_MEANS,
                             post_nms_top_n=post_nms),
                cfg, dataset.num_classes,
            )
        return testers[post_nms]

    loader_kw = {} if image_loader is None else {"image_loader": image_loader}
    n_scales = len(cfg.TEST.SCALES)
    scale_dets, scale_masks = [], []
    for s in range(n_scales):
        autofocus = bool(cfg.TEST.AUTO_FOCUS) and s < n_scales - 1
        cache_file = os.path.join(out_dir, f"dets_scale{s}.pkl")
        if _per_scale(cfg.TEST.USE_CACHE, s) and os.path.exists(cache_file):
            with open(cache_file, "rb") as f:
                cached = pickle.load(f)
            all_boxes, all_maps = cached["dets"], cached.get("maps")
            all_masks = cached.get("masks")
            print(f"scale {s}: loaded from cache {cache_file}")
        else:
            tester = get_tester(_scale_post_nms(cfg, s, model))
            batches = TestChipIterator(
                roidb, cfg, s, _per_scale(cfg.TEST.BATCH_IMAGES, s),
                **loader_kw)
            all_boxes, all_maps, all_masks = tester.get_detections(
                iter(batches), roidb,
                do_pruning=bool(_per_scale(cfg.TEST.DO_PRUNING, s)),
                autofocus=autofocus, with_masks=with_masks)
            print(f"scale {s}: done")
            # atomic: USE_CACHE treats existence as "scale done"
            tmp = f"{cache_file}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump({"dets": all_boxes, "maps": all_maps,
                             "masks": all_masks}, f)
            os.replace(tmp, cache_file)
        scale_dets.append(all_boxes)
        scale_masks.append(all_masks)
        if autofocus:
            add_chips(roidb, all_maps, s, cfg)

    tester = (next(iter(testers.values())) if testers
              else Tester(None, cfg, dataset.num_classes))
    if not with_masks:
        final = tester.aggregate(scale_dets, len(roidb))
        return dataset.evaluate_detections(final, roidb)
    final, final_masks = tester.aggregate(
        scale_dets, len(roidb), scale_cls_masks=scale_masks,
        mask_size=model.mask_size)
    return {"bbox": dataset.evaluate_detections(final, roidb),
            "segm": dataset.evaluate_segmentations(final_masks, roidb)}


def run_proposal_extraction(cfg, model, state, roidb, dataset, device,
                            image_loader=None) -> str:
    """RPN proposals of every image at every TEST.SCALES entry, stacked
    per image ([N,5] boxes and score in the image's coordinates), pickled
    as {"boxes": [...]} to TEST.PROPOSAL_SAVE_PATH/<dataset.name>_rpn.pkl
    under a temporary name and renamed (existence means "done"). ``model``
    is an RPN-only detector; ``state`` and parallel.num_devices as in
    run_detection. Returns the file's path."""
    init_inference_crops(roidb)
    forward = make_forward(model, state, inference_devices(cfg, device),
                           cfg.network.PIXEL_MEANS)
    tester = Tester(forward, cfg, dataset.num_classes)
    loader_kw = {} if image_loader is None else {"image_loader": image_loader}
    agg = None
    for s in range(len(cfg.TEST.SCALES)):
        batches = TestChipIterator(
            roidb, cfg, s, _per_scale(cfg.TEST.BATCH_IMAGES, s), **loader_kw)
        boxes, scores = tester.extract_proposals(iter(batches), roidb)
        dets = [np.hstack([b, sc]) for b, sc in zip(boxes, scores)]
        agg = dets if agg is None else [np.vstack([a, d])
                                        for a, d in zip(agg, dets)]
    os.makedirs(cfg.TEST.PROPOSAL_SAVE_PATH, exist_ok=True)
    out = os.path.join(cfg.TEST.PROPOSAL_SAVE_PATH, f"{dataset.name}_rpn.pkl")
    tmp = f"{out}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump({"boxes": agg}, f)
    os.replace(tmp, out)
    print(f"saved proposals to {out}")
    return out


def build_test_dataset(cfg):
    name = cfg.dataset.dataset
    if name == "coco":
        from sniper_tpu_torch.data.coco import COCODataset

        # a mask config's test roidb carries gt_masks, cached under the
        # mask key, as the JAX CLI's does
        return COCODataset(str(cfg.dataset.test_image_set),
                           cfg.dataset.root_path, cfg.dataset.dataset_path,
                           load_mask=bool(cfg.TRAIN.WITH_MASK))
    if name == "PascalVOC":
        from sniper_tpu_torch.data.pascal_voc import PascalVOC

        return PascalVOC(str(cfg.dataset.test_image_set),
                         cfg.dataset.root_path, cfg.dataset.dataset_path)
    raise KeyError(f"unknown dataset {name!r}")


def main(argv=None):
    from sniper_tpu_torch.config import config_name, load_config
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.train.checkpoint import restore_inference_state

    p = argparse.ArgumentParser(description="Test a SNIPER detector (torch)")
    p.add_argument("--cfg", required=True)
    p.add_argument("--weights", default=None,
                   help="torch.save'd state_dict of the port's detector "
                        "(default: the training run's checkpoint, else "
                        "network.pretrained)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", dest="overrides", nargs="*", default=[])
    args = p.parse_args(argv)

    cfg = load_config(args.cfg, args.overrides)
    name = config_name(args.cfg)
    out_dir = os.path.join(cfg.output_path or "./output", name,
                           str(cfg.dataset.test_image_set))
    os.makedirs(out_dir, exist_ok=True)
    dataset = build_test_dataset(cfg)
    roidb = dataset.gt_roidb()
    model = get_model(cfg)
    if args.weights:
        model.load_state_dict(torch.load(args.weights, map_location="cpu"))
    else:
        restore_inference_state(cfg, model, name)
    device = torch.device(args.device)
    if cfg.TEST.EXTRACT_PROPOSALS:
        run_proposal_extraction(cfg, model, None, roidb, dataset, device)
        return
    stats = run_detection(cfg, model, None, roidb, dataset, out_dir, device)
    print(f"evaluation: {stats}")


if __name__ == "__main__":
    main()
