"""SNIPER training CLI, on one CUDA device or data-parallel over several.

Port of main_train.py:19-346: config -> roidb (flips,
filtering, RPN proposals for negative-chip mining, regression-target
statistics) -> chip loader (in this process, or in a spawned one with
TRAIN.LOADER_PROCESS) -> detector with seeded random weights, then the
pretrained backbone of ``network.pretrained`` imported over them -> the
epoch loop of ``run_training``:

  python -m sniper_tpu_torch.main_train --cfg configs/sniper_res101_e2e.yml \\
      [--set TRAIN.lr 0.01 ...]

TRAIN.ONLY_PROPOSAL trains the RPN alone (the recipe's first phase, whose
checkpoint main_test's TEST.EXTRACT_PROPOSALS reads); TRAIN.WITH_MASK
(configs/sniper_res101_e2e_mask.yml) adds the mask branch and its loss,
with the GT polygons rasterized by the chip loader; TRAIN.AUTO_FOCUS
(configs/sniper_res101_e2e_autofocus.yml) adds the FocusPixel head and
``focus_loss`` against the chip loader's FocusPixel labels. The model zoo
trains the same way: ResNeXt-101 with ``--set symbol resnext_mx_101`` on
the flagship yml, MobileNetV2 with configs/sniper_mobilenetv2_e2e.yml.
configs/sniper_res101_e2e_mask_autofocus.yml trains the mask branch and the
FocusPixel head together (all six losses). TRAIN.ENABLE_OHEM trains the
R-CNN terms on the TRAIN.BATCH_ROIS_OHEM hardest sampled rois of each chip
(ops/ohem.py). TRAIN.VISUALIZE renders every TRAIN.visualization_freq-th
training chip with its GT boxes (data/loader.py) and, every
visualization_freq steps, the detector's predictions on the last assembled
batch (train/vis_dump.py), both under TRAIN.visualization_path.
Each epoch re-rolls
the chips, assembles batches in a background thread and uploads them
(pinned memory, non-blocking copies) in a second one, so both overlap the
device's steps; the step's metrics stay on the device until a log line
reads them. A checkpoint per epoch goes to
``<output_path>/<cfg name>/<image_set>/checkpoints/epoch_<n>.pt``, and
``TRAIN.begin_epoch = n`` resumes from it.

Data parallelism (parallel/), as the JAX CLI's multi-process convention
(main_train.py:129-156,229-232), one card per rank:
- ``--set parallel.num_devices N`` (N > 1, or -1 with several visible
  cards) starts one worker process per card from this one; more cards
  than the machine shows raise ValueError;
- under torchrun (or ``parallel.num_processes`` with
  ``parallel.coordinator_address`` and ``parallel.process_id``, or their
  SNIPER_* variables) each process is one rank and joins the group.
Each rank trains on ``shard_roidb``'s slice with its own loader of
TRAIN.BATCH_IMAGES chips seeded TRAIN.seed + rank, and every rank runs
``global_min_steps`` steps an epoch; the global batch is BATCH_IMAGES x
ranks. Only rank 0 logs and writes checkpoints, which hold the unwrapped
model's state_dict (a one-process model loads them), and only rank 0
writes TRAIN.VISUALIZE's chip renderings and prediction dumps, which the
ranks would otherwise overwrite under the same names. A rank that fails
ends the run with an error.
"""

from __future__ import annotations

import argparse
import copy
import os
import shutil
import tempfile

import torch

from sniper_tpu_torch.data.loader import ChipLoader, Prefetcher
from sniper_tpu_torch.parallel import distributed
from sniper_tpu_torch.parallel.mesh import data_parallel
from sniper_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from sniper_tpu_torch.train.metrics import MetricTracker
from sniper_tpu_torch.train.optimizer import make_optimizer
from sniper_tpu_torch.train.trainer import (
    make_train_step,
    reduce_metrics,
    to_device,
)
from sniper_tpu_torch.train.vis_dump import PredictionDumper
from sniper_tpu_torch.utils.logger import create_logger

LOG_EVERY = 20  # steps between progress lines (the JAX CLI's)


def build_dataset(cfg):
    name = cfg.dataset.dataset
    sets = str(cfg.dataset.image_set).split("+")
    if name == "coco":
        from sniper_tpu_torch.data.coco import COCODataset

        return [COCODataset(s, cfg.dataset.root_path,
                            cfg.dataset.dataset_path,
                            load_mask=cfg.TRAIN.WITH_MASK) for s in sets]
    if name == "PascalVOC":
        from sniper_tpu_torch.data.pascal_voc import PascalVOC

        return [PascalVOC(s, cfg.dataset.root_path, cfg.dataset.dataset_path)
                for s in sets]
    raise KeyError(f"unknown dataset {name!r}")


def build_roidb(cfg, log=print, datasets=None):
    """The training roidb (main_train.py:49-106): GT roidbs, RPN proposals
    for negative-chip mining when TRAIN.USE_NEG_CHIPS, flipped copies,
    filtering, then the regression-target statistics, which replace
    TRAIN.BBOX_MEANS / BBOX_STDS unless BBOX_NORMALIZATION_PRECOMPUTED."""
    from sniper_tpu_torch.data.bbox_regression import (
        add_bbox_regression_targets,
    )
    from sniper_tpu_torch.data.roidb import (
        append_flipped_images,
        filter_roidb,
        load_rpn_proposals,
    )

    roidb = []
    for ds in datasets if datasets is not None else build_dataset(cfg):
        r = ds.gt_roidb()
        if cfg.TRAIN.USE_NEG_CHIPS:
            pkl = os.path.join(cfg.proposal_path, f"{ds.name}_rpn.pkl")
            if os.path.exists(pkl):
                r = load_rpn_proposals(pkl, r, cfg.dataset.NUM_CLASSES)
            else:
                log(f"proposals {pkl} not found: neg-chip mining will only "
                    "see GT boxes")
        roidb += r
    if cfg.TRAIN.FLIP:
        roidb = append_flipped_images(roidb)
    roidb = filter_roidb(roidb, cfg.TRAIN.FG_THRESH, cfg.TRAIN.BG_THRESH_HI,
                         cfg.TRAIN.BG_THRESH_LO)
    log(f"roidb: {len(roidb)} images")
    means, stds = add_bbox_regression_targets(roidb, cfg)
    if not cfg.TRAIN.BBOX_NORMALIZATION_PRECOMPUTED:
        # class-agnostic: row 1 is the shared fg row; else average them
        m = means.reshape(-1, 4)[1:].mean(axis=0)
        s = stds.reshape(-1, 4)[1:].mean(axis=0)
        if (s > 1e-3).all():
            cfg.TRAIN.BBOX_MEANS = tuple(float(v) for v in m)
            cfg.TRAIN.BBOX_STDS = tuple(float(v) for v in s)
            log(f"empirical bbox means={cfg.TRAIN.BBOX_MEANS} "
                f"stds={cfg.TRAIN.BBOX_STDS}")
        else:
            # a GT-only roidb has all-zero targets: dividing by ~0 stds
            # would blow up the in-graph normalization
            log(f"empirical bbox stds degenerate ({s}); keeping config "
                f"constants {cfg.TRAIN.BBOX_STDS}")
    return roidb


def num_devices(cfg, device) -> int:
    """parallel.num_devices as the JAX CLI reads it: -1 is every visible
    device, which is every visible card for a CUDA ``device`` and one
    for the CPU."""
    n = int(cfg.parallel.num_devices)
    if n != -1:
        return n
    return torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1


def check_devices(cfg, device):
    """Raise ValueError for a device count the run cannot have: more cards
    than the machine shows for a CUDA ``device``, or, in a process group,
    an explicit parallel.num_devices other than its size."""
    n = int(cfg.parallel.num_devices)
    if distributed.is_distributed():
        if n != -1 and n != distributed.world_size():
            raise ValueError(
                f"parallel.num_devices {n} but the process group has "
                f"{distributed.world_size()} ranks")
        return
    n = num_devices(cfg, device)
    visible = torch.cuda.device_count()
    if torch.device(device).type == "cuda" and n > visible:
        raise ValueError(f"parallel.num_devices {n} but {visible} CUDA "
                         "devices are visible")


def _epoch_telemetry(em: dict, cfg, log):
    """The epoch-end offset telemetry lines of the JAX CLI: the head's
    offsets against the HEAD_MARGIN_BINS clamp, the trunk's DCN reach."""
    if "offset_max" in em:
        margin = int(getattr(cfg.network, "HEAD_MARGIN_BINS", 1))
        thr = em.get("offset_clamp_thr", margin / (0.1 * 7))
        frac = em.get("offset_clamp_frac", 0.0)
        msg = (f"head offsets max |trans|={em['offset_max']:.3f} vs clamp "
               f"{thr:.3f} (margin {margin}), clamp_frac={frac:.2e}")
        if frac > 0 or em["offset_max"] > 0.8 * thr:
            msg += (f" - near or over the clamp: raise "
                    f"network.HEAD_MARGIN_BINS to {margin + 1}")
        log(msg)
    if "dcn_offset_max" in em:
        log(f"trunk DCN offsets max |off|={em['dcn_offset_max']:.3f} "
            "feature px")


def run_training(cfg, model, loader, device, *, out_dir=None, log=print,
                 max_steps=None, step_hook=None):
    """Train ``model`` on ``device`` over TRAIN.begin_epoch..end_epoch of
    ``loader`` (a ChipLoader or ProcessChipLoader), with the recipe's SGD,
    and checkpoint each epoch under ``out_dir`` when given. ``max_steps``
    ends the run after that many steps (an epoch cut short that way leaves
    a ProcessChipLoader's child to be respawned); ``step_hook(step,
    metrics)`` runs after every step (metrics are 0-d device tensors, under
    data parallelism the rank's shares: trainer.py's module doc).

    In a process group (parallel/distributed.py) this is one rank's part:
    ``loader`` holds its shard, the model is DDP-wrapped, the global batch
    is BATCH_IMAGES x ranks, every rank runs the global minimum of the
    ranks' steps, the metrics are reduced over the ranks at each log line,
    the sampler's generator is seeded TRAIN.seed + rank, and only rank 0
    logs, checkpoints and dumps predictions.

    TRAIN.ENABLE_OHEM trains on the TRAIN.BATCH_ROIS_OHEM hardest rois per
    chip. TRAIN.VISUALIZE (not for TRAIN.ONLY_PROPOSAL, which has no
    detection head) dumps the predictions of the unwrapped model on the
    last batch the loader assembled after every visualization_freq-th step
    (train/vis_dump.py; that batch may run ahead of the step by the
    prefetch depth, and the dump records its own sequence number). Returns
    the last epoch's metric means (global), the step count and why the
    last step ran eagerly (None where it replayed the step's CUDA graph:
    train/trainer.py)."""
    check_devices(cfg, device)
    rank, world = distributed.rank(), distributed.world_size()
    if rank != 0:
        log = _quiet
    model.to(device)
    n_chips = loader.reset()
    log(f"epoch {cfg.TRAIN.begin_epoch}: {n_chips} chips"
        + (f" on rank 0 of {world}" if distributed.is_distributed() else ""))
    epoch_size = max(distributed.global_min_steps(len(loader)), 1)
    opt, sched, schedule = make_optimizer(cfg, epoch_size, model)
    gen = torch.Generator(device=device).manual_seed(
        int(cfg.TRAIN.seed) + rank)
    net = data_parallel(model, device) if distributed.is_distributed() \
        else model
    batch_images = cfg.TRAIN.BATCH_IMAGES * world
    step_fn = make_train_step(
        net, opt, sched, batch_images,
        rpn_batch_size=cfg.TRAIN.RPN_BATCH_SIZE,
        pixel_means=cfg.network.PIXEL_MEANS, generator=gen,
        rpn_only=bool(cfg.TRAIN.ONLY_PROPOSAL),
        ohem_rois=(int(cfg.TRAIN.BATCH_ROIS_OHEM)
                   if cfg.TRAIN.ENABLE_OHEM else 0))
    dumper = (PredictionDumper(model, cfg)
              if bool(cfg.TRAIN.VISUALIZE) and rank == 0
              and not cfg.TRAIN.ONLY_PROPOSAL else None)
    last_host: list = []  # [(sequence number, host batch)]
    ckpt_dir = os.path.join(out_dir, "checkpoints") if out_dir else None
    step = 0
    if cfg.TRAIN.begin_epoch > 0:
        step = load_checkpoint(ckpt_dir, model, opt, sched,
                               cfg.TRAIN.begin_epoch)
        log(f"resumed from epoch {cfg.TRAIN.begin_epoch} at step {step}")
    means: dict = {}
    start = step
    for epoch in range(cfg.TRAIN.begin_epoch, cfg.TRAIN.end_epoch):
        if epoch > cfg.TRAIN.begin_epoch:
            log(f"epoch {epoch}: {loader.reset()} chips")
        n = distributed.global_min_steps(len(loader))
        if max_steps is not None:
            n = min(n, max_steps - (step - start))
        tracker = MetricTracker()
        pending: list = []

        def flush():
            for m in reduce_metrics(pending):
                tracker.update(m, batch_images)
            pending.clear()

        # two stages, each in its own thread: batch assembly on the host,
        # then the upload. The loader is told the epoch's step count, so a
        # loader process closes the cut epoch itself and keeps its rng
        host = Prefetcher(loader.batches(n))
        if dumper is not None:
            host = _tap(host, last_host)
        for batch in Prefetcher(to_device(b, device) for b in host):
            metrics = step_fn(batch)
            pending.append(metrics)
            step += 1
            if step_hook is not None:
                step_hook(step, metrics)
            if dumper is not None:
                seq, b = last_host[0]
                p = dumper.maybe_dump(b, step, batch_seq=seq)
                if p:
                    log(f"dumped predictions to {p}")
            if step % LOG_EVERY == 0:
                flush()
                log(tracker.format(epoch, step)
                    + f"  lr={schedule(step):.6f}")
        flush()
        means = tracker.means()
        _epoch_telemetry(means, cfg, log)
        if ckpt_dir is not None and rank == 0:
            path = save_checkpoint(ckpt_dir, epoch + 1, model, opt, sched,
                                   step)
            log(f"saved checkpoint {path}")
        if max_steps is not None and step - start >= max_steps:
            break
    return {"step": step, "means": means,
            "eager_reason": step_fn.eager_reason}


def _tap(batches, last: list):
    """Pass the host batches through, keeping the latest with its sequence
    number over the run in ``last[0]`` (one tuple, replaced whole: the
    upload thread writes it while the step loop reads it)."""
    start = last[0][0] + 1 if last else 0
    for seq, b in enumerate(batches, start):
        last[:] = [(seq, b)]
        yield b


def _quiet(*_):
    pass


def make_loader(roidb, cfg, seed, image_loader=None):
    """The chip loader of TRAIN.BATCH_IMAGES: a ProcessChipLoader with
    TRAIN.LOADER_PROCESS (main_train.py:149-160), else a ChipLoader.
    ``image_loader`` replaces cv2.imread (a module-level function for the
    loader process). Under TRAIN.VISUALIZE only rank 0's loader renders
    chips."""
    kw = {} if image_loader is None else {"image_loader": image_loader}
    if bool(cfg.TRAIN.VISUALIZE) and distributed.rank() != 0:
        cfg = copy.deepcopy(cfg)
        cfg.TRAIN.VISUALIZE = False
    if bool(getattr(cfg.TRAIN, "LOADER_PROCESS", False)):
        from sniper_tpu_torch.data.shm_loader import ProcessChipLoader

        return ProcessChipLoader(roidb, cfg, cfg.TRAIN.BATCH_IMAGES,
                                 seed=seed, **kw)
    return ChipLoader(roidb, cfg, cfg.TRAIN.BATCH_IMAGES, seed=seed, **kw)


def train(cfg, cfg_file: str, device):
    """One run of the CLI on ``device``: the whole run in one process, or
    one rank's part of it in a process group (module doc)."""
    from sniper_tpu_torch.config import config_name
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.train.pretrained import load_pretrained

    rank, world = distributed.rank(), distributed.world_size()
    output_path = cfg.output_path or "./output"
    name, image_set = config_name(cfg_file), str(cfg.dataset.image_set)
    out_dir = os.path.join(output_path, name, image_set)
    log = (create_logger(output_path, name, image_set)[0].info if rank == 0
           else _quiet)
    # every rank measures the regression statistics on the whole roidb,
    # then keeps its slice
    roidb = distributed.shard_roidb(build_roidb(cfg, log), rank, world)
    if world > 1:
        log(f"rank 0 of {world}: {len(roidb)} roidb images, global batch "
            f"{cfg.TRAIN.BATCH_IMAGES * world}")
    # the bbox means/stds may have been measured on the roidb: build the
    # model after build_roidb; the import comes before the optimizer
    model = init_detector(get_model(cfg), seed=int(cfg.TRAIN.seed))
    load_pretrained(cfg, model, log)
    loader = make_loader(roidb, cfg, int(cfg.TRAIN.seed) + rank)
    try:
        return run_training(cfg, model, loader, torch.device(device),
                            out_dir=out_dir, log=log)
    finally:
        loader.close()


def _train_rank(rank, device, cfg, cfg_file):
    if device.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // distributed.world_size()))
    train(cfg, cfg_file, device)


def launch_training(cfg, cfg_file: str, device):
    """The CLI's run: in this process on one device; one spawned rank per
    device when parallel.num_devices resolves to more than one (the CUDA
    cards 0..N-1, or N gloo ranks on the CPU); or, when this process is one
    rank of a run started from outside, that rank's part."""
    device = torch.device(device)
    if distributed.num_processes(cfg) > 1:
        distributed.maybe_init_distributed(cfg, device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        ok = False
        try:
            check_devices(cfg, device)
            train(cfg, cfg_file, device)
            ok = True
        finally:
            distributed.leave_group(ok)
        return
    check_devices(cfg, device)
    n = num_devices(cfg, device)
    if n <= 1:
        train(cfg, cfg_file, device)
        return
    devices = ([torch.device("cuda", i) for i in range(n)]
               if device.type == "cuda" else [device] * n)
    store = tempfile.mkdtemp(prefix="sniper_dp_")
    try:
        distributed.launch(_train_rank, devices,
                           f"file://{os.path.join(store, 'rendezvous')}",
                           args=(cfg, cfg_file))
    finally:
        shutil.rmtree(store, ignore_errors=True)


def main(argv=None):
    from sniper_tpu_torch.config import load_config

    p = argparse.ArgumentParser(description="Train a SNIPER detector (torch)")
    p.add_argument("--cfg", required=True, help="experiment yaml")
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", dest="overrides", nargs="*", default=[],
                   help="config overrides: key value ...")
    args = p.parse_args(argv)
    cfg = load_config(args.cfg, args.overrides)
    launch_training(cfg, args.cfg, args.device)


if __name__ == "__main__":
    main()
