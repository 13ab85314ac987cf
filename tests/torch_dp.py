"""Helpers of the data-parallel tests (tests/test_torch_dp_*.py) and of
scripts/gen_torch_dp_golden.py: the spawned ranks' functions, the tiny
detector and its batch.

This module imports no jax: each spawned rank imports it (and
sniper_tpu_torch) afresh. The ranks meet through a ``file://`` store under
the test's temporary directory, never a fixed port (the suite runs in
several workers), and every launch has a time limit, so a hung rank fails
its test.
"""

import os

import numpy as np
import torch

from sniper_tpu_torch.parallel import distributed

LAUNCH_TIMEOUT_S = 300.0
# how long left_early_rank's rank 1 gives rank 0 to leave the group
LEAVE_GRACE_S = 1.0

# the tiny detector of __graft_entry__.py:62-73 (dryrun_multichip's): full
# width, units (1,1,1,1), 81 classes, 21 anchors, fp32; its training branch
# keeps the JAX detector's defaults (train_pre_nms 6000, train_post_nms
# 300, fg_fraction 0.25), so the sampler's draws decide which rois train
GRAFT_TINY = dict(num_classes=81, num_anchors=21,
                  anchor_scales=(2, 4, 7, 10, 13, 16, 24),
                  anchor_ratios=(0.5, 1, 2), units=(1, 1, 1, 1),
                  pre_nms_top_n=512, post_nms_top_n=32, num_rois=32)
B_GLOBAL, H, W = 4, 64, 64  # two chips per rank on two ranks
G = 4  # GT rows per chip, the last one padding
N_CAND = 300 + G  # the sampler's candidates: train_post_nms + GT rows
INIT_SEED = 5
OFFSET_STD = 1e-3  # offsets off zero: no sample starts on a kink
FIXED = ["conv0", "bn0", "stage1", "bn_data"]


def launch(fn, world, tmp_path, *args, timeout_s=LAUNCH_TIMEOUT_S):
    """``fn(rank, device, *args)`` on ``world`` gloo ranks on the CPU."""
    store = os.path.join(str(tmp_path), f"store_{fn.__name__}")
    distributed.launch(fn, [torch.device("cpu")] * world, f"file://{store}",
                       args=args, timeout_s=timeout_s)


def make_cfg():
    """gen_torch_train_golden's recipe without the warm-up (lr 0.01 from
    the first step, so that one step moves every leaf well above fp32
    rounding), on the port's config tree."""
    from sniper_tpu_torch.config import default_config

    cfg = default_config()
    cfg.TRAIN.lr = 0.01
    cfg.TRAIN.warmup = False
    cfg.TRAIN.lr_step = "1.0"
    cfg.TRAIN.wd = 0.0005
    cfg.network.FIXED_PARAMS = list(FIXED)
    return cfg


def make_batch():
    """B_GLOBAL unit-noise chips with GT boxes of three sizes and sparse
    RPN targets. The ranks' halves differ in their valid label counts:
    chips 0-1 (rank 0) keep 60 of 64 sampled anchors, chips 2-3 (rank 1)
    16, and the chips have 3 / 3 / 2 / 1 GT boxes, so their R-CNN labels
    differ too."""
    rng = np.random.RandomState(41)
    n = GRAFT_TINY["num_anchors"] * (H // 16) * (W // 16)
    gt = np.full((B_GLOBAL, G, 5), -1.0, np.float32)
    gt[0, :3] = [[4, 6, 40, 44, 1], [20, 10, 60, 30, 2], [8, 30, 24, 50, 3]]
    gt[1, :3] = [[10, 12, 50, 58, 4], [2, 2, 22, 20, 1], [30, 20, 62, 40, 2]]
    gt[2, :2] = [[6, 4, 30, 36, 7], [28, 30, 60, 62, 12]]
    gt[3, :1] = [[12, 14, 52, 48, 3]]
    S, F = 64, 8
    pids = np.stack([rng.permutation(n)[:S] for _ in range(B_GLOBAL)])
    pids[:2, -4:] = -1
    pids[2:, 16:] = -1
    fg = np.stack([rng.permutation(n)[:F] for _ in range(B_GLOBAL)])
    fg[:, -2:] = -1
    return {
        "data": rng.randn(B_GLOBAL, H, W, 3).astype(np.float32),
        "im_info": np.array([[H, W, 1.0], [H - 8, W - 4, 1.0],
                             [H, W - 12, 1.0], [H - 4, W, 1.0]], np.float32),
        "gt_boxes": gt,
        "valid_ranges": np.array([[0.0, 1e5], [0.0, 40.0], [0.0, 1e5],
                                  [10.0, 1e5]], np.float32),
        "rpn_pids": pids.astype(np.int32),
        "rpn_label_vals": rng.choice([0.0, 1.0], (B_GLOBAL, S), p=[0.7, 0.3])
        .astype(np.float32),
        "fg_pids": fg.astype(np.int32),
        "fg_targets": (rng.randn(B_GLOBAL, F, 4) * 0.2).astype(np.float32),
    }


def tiny_detector(bn_mode="sync"):
    """GRAFT_TINY in the port, fp32, seeded (init_detector, INIT_SEED)."""
    from sniper_tpu_torch.models.detector import SNIPERDetector
    from sniper_tpu_torch.models.init import init_detector

    model = SNIPERDetector(**GRAFT_TINY, dtype=torch.float32,
                           bn_mode=bn_mode)
    return init_detector(model, seed=INIT_SEED, offset_std=OFFSET_STD)


def train_steps(bn_mode, priorities, rank=0, world=1, ohem_rois=0):
    """len(priorities) steps of make_train_step on this rank's shard of
    make_batch (all of it for one process), DDP-wrapped in a process group;
    ``priorities`` is one (fg, bg) pair of [B_GLOBAL, N_CAND] arrays per
    step, of which the rank takes its rows; ``ohem_rois`` as
    make_train_step's. Returns (the steps' global metrics as floats, the
    model's state_dict)."""
    from sniper_tpu_torch.parallel.mesh import data_parallel
    from sniper_tpu_torch.train.optimizer import make_optimizer
    from sniper_tpu_torch.train.trainer import make_train_step, reduce_metrics

    model = tiny_detector(bn_mode)
    opt, sched, _ = make_optimizer(make_cfg(), 100, model)
    net = data_parallel(model, "cpu") if distributed.is_distributed() \
        else model
    step = make_train_step(net, opt, sched, B_GLOBAL,
                           pixel_means=(0.0, 0.0, 0.0), ohem_rois=ohem_rois)
    b = B_GLOBAL // world
    rows = slice(rank * b, (rank + 1) * b)
    batch = {k: torch.from_numpy(v[rows]) for k, v in make_batch().items()}
    metrics = []
    for fg, bg in priorities:
        m = step(batch, priorities=(torch.from_numpy(fg[rows]),
                                    torch.from_numpy(bg[rows])))
        metrics.append({k: float(v) for k, v in reduce_metrics([m])[0]
                        .items()})
    return metrics, model.state_dict()


def train_rank(rank, device, world, runs, out_dir):
    """For each (name, bn_mode, priorities[, ohem_rois]) of ``runs``:
    train_steps on this rank, its metrics and state_dict saved to
    <out_dir>/<name>_rank<rank>.pt."""
    torch.set_num_threads(1)
    for name, bn_mode, priorities, *ohem in runs:
        metrics, state = train_steps(bn_mode, priorities, rank, world,
                                     *ohem)
        torch.save({"metrics": metrics, "state": state},
                   os.path.join(out_dir, f"{name}_rank{rank}.pt"))


def batchnorm_rank(rank, device, world, cases, out_dir):
    """For each (name, mode, x, g, split) of ``cases``: a TrainBatchNorm(C)
    in ``mode`` with the weight and bias of ``batchnorm``, on this
    rank's rows of x [N,C,H,W] (``split`` rows per rank), the backward of
    sum(y * g) over those rows; saves y, the input gradient, the parameter
    gradients summed over the ranks and the running statistics to
    <out_dir>/<name>_rank<rank>.pt."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    for name, mode, x, g, split in cases:
        lo = sum(split[:rank])
        rows = slice(lo, lo + split[rank])
        bn = batchnorm(x.shape[1], mode)
        xr = torch.from_numpy(x[rows]).requires_grad_(True)
        y = bn(xr)
        (y * torch.from_numpy(g[rows])).sum().backward()
        grads = torch.cat([bn.weight.grad, bn.bias.grad])
        dist.all_reduce(grads)
        torch.save({"y": y.detach(), "dx": xr.grad, "grads": grads,
                    "mean": bn.running_mean, "var": bn.running_var},
                   os.path.join(out_dir, f"{name}_rank{rank}.pt"))


def batchnorm(c, mode="sync"):
    """A training-mode TrainBatchNorm(c) with seeded weight and bias."""
    from sniper_tpu_torch.models.norm import TrainBatchNorm

    bn = TrainBatchNorm(c).train()
    bn.mode = mode
    rng = np.random.RandomState(3)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(
            rng.uniform(0.5, 1.5, c).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.randn(c).astype(np.float32)))
    return bn


def min_steps_rank(rank, device, counts, out_dir):
    """global_min_steps of counts[rank], and shard_roidb's slice under the
    group's defaults, saved as text."""
    got = distributed.global_min_steps(counts[rank])
    part = distributed.shard_roidb(list(range(10)))
    with open(os.path.join(out_dir, f"min_rank{rank}.txt"), "w") as f:
        f.write(f"{got} {part}")


def failing_rank(rank, device):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")


def left_early_rank(rank, device, out_dir, fail):
    """Rank 0 returns at once. Rank 1 waits until it has, gives it
    LEAVE_GRACE_S to leave the group, writes to <out_dir>/rank1.txt whether
    it did, then raises (``fail``) or returns. A rank must stay in the group
    until every rank has returned or one has failed."""
    import time

    import torch.distributed as dist

    store = dist.distributed_c10d._get_default_store()
    left = os.path.join(out_dir, "rank0_left")
    if rank == 0:
        destroy = dist.destroy_process_group

        def spy(*args, **kwargs):
            open(left, "w").close()
            destroy(*args, **kwargs)

        dist.destroy_process_group = spy
        store.set("rank0_returns", "")
        return
    store.wait(["rank0_returns"])
    time.sleep(LEAVE_GRACE_S)
    with open(os.path.join(out_dir, "rank1.txt"), "w") as f:
        f.write(f"rank 0 left early: {os.path.exists(left)}")
    if fail:
        raise RuntimeError("rank 1 fails on purpose after rank 0 returned")


def threads_rank(rank, device, out_dir):
    """Writes this rank's OMP_NUM_THREADS, MKL_NUM_THREADS and torch thread
    count to <out_dir>/threads_rank<rank>.txt."""
    with open(os.path.join(out_dir, f"threads_rank{rank}.txt"), "w") as f:
        f.write(f"{os.environ.get('OMP_NUM_THREADS')} "
                f"{os.environ.get('MKL_NUM_THREADS')} "
                f"{torch.get_num_threads()}")


def hanging_rank(rank, device):
    """Rank 0 waits in a collective that rank 1 never joins."""
    import time

    import torch.distributed as dist

    if rank == 0:
        dist.all_reduce(torch.zeros(1))
    else:
        time.sleep(600)


class RecordingLoader:
    """A chip loader that passes everything through and records a digest of
    every batch it yields, one list per epoch."""

    def __init__(self, loader):
        self.loader = loader
        self.epochs: list = []

    def reset(self):
        return self.loader.reset()

    def __len__(self):
        return len(self.loader)

    def batches(self, limit=None):
        import hashlib

        digests = []
        self.epochs.append(digests)
        for batch in self.loader.batches(limit):
            h = hashlib.sha256()
            for k in sorted(batch):
                h.update(np.ascontiguousarray(batch[k]).tobytes())
            digests.append(h.hexdigest())
            yield batch

    def close(self):
        self.loader.close()


def loader_epochs_rank(rank, device, cfg_path, out_dir):
    """main_train.train of ``cfg_path`` on this rank, once with
    TRAIN.LOADER_PROCESS and once with the thread loader, each loader
    recorded (RecordingLoader); the digests per epoch are saved to
    <out_dir>/epochs_rank<rank>.pt as {"process": ..., "thread": ...}. The
    registry builds the detector with one unit per stage."""
    import functools

    from sniper_tpu_torch import main_train
    from sniper_tpu_torch.config import load_config
    from sniper_tpu_torch.models import registry

    torch.set_num_threads(1)
    registry.get_model = functools.partial(registry.get_model,
                                           units=(1, 1, 1, 1))
    make_loader, recorded = main_train.make_loader, {}

    def recording(roidb, cfg, seed, image_loader=None):
        loader = RecordingLoader(make_loader(roidb, cfg, seed, image_loader))
        recorded[bool(cfg.TRAIN.LOADER_PROCESS)] = loader.epochs
        return loader

    main_train.make_loader = recording
    for process in (True, False):
        cfg = load_config(cfg_path, [
            "TRAIN.LOADER_PROCESS", str(process), "output_path",
            os.path.join(out_dir, f"output_{process}")])
        main_train.train(cfg, cfg_path, device)
    torch.save({"process": recorded[True], "thread": recorded[False]},
               os.path.join(out_dir, f"epochs_rank{rank}.pt"))
