#!/usr/bin/env python3
"""What DDP costs one rank's training step of the port.

Runs make_train_step of configs/sniper_res101_e2e.yml's detector (full
width, seeded random weights, the recipe's bf16 trunk) on chip_smoke.py's
synthetic batch of 16 chips of 512x512, already on the device, with the
same sampler priorities at every step, as the one rank of an NCCL process
group (parallel/distributed.py), in three forms taken in turns: the model
unwrapped ("one process": no group work at all) and wrapped by
parallel/mesh.py:data_parallel ("DDP", what run_training uses), and the DDP
form with every training BatchNorm made to take the path of a group of
several ranks ("DDP, sync BatchNorm": models/norm.py's sync statistics, two
all-reduces per layer, here over a group of one, so that what the path
computes is timed without any wait for another rank). For each it prints
the median and range of the host clock per step over the timed steps (each
step ends in a synchronize), the peak memory and the loss at the first,
second and last step (the forms start from the same weights: the bf16
losses agree to rounding), then profiles a few steps with torch.profiler:
the host's CPU time in operations and the device's kernel time per step
(the kernels' own events: not the CPU ops' copies of them), and the
host-side operations whose time differs most between DDP and one process,
between the sync BatchNorm path and DDP. User ranges such as DDP's
"DistributedDataParallel.forward" are left out of the host's sums: the
profiler books under such a range the Python time of the model's forward,
which without DDP is booked nowhere. A group of one has no other rank to
wait for, so the differences are the work of DDP and of the sync path
themselves.
Needs one CUDA device.

    python3 scripts/profile_torch_ddp.py [--steps 20] [--warmup 3] [--reps 3]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


SYNC = "DDP, sync BatchNorm"


def forms(device):
    from sniper_tpu_torch.parallel.mesh import data_parallel

    return {"one process": lambda m: m,
            "DDP": lambda m: data_parallel(m, device),
            SYNC: lambda m: data_parallel(m, device)}


@contextlib.contextmanager
def sync_batchnorm_path():
    """Inside: every training BatchNorm sees a world of 2 and takes the
    sync path (its collectives run over the real group of one)."""
    from sniper_tpu_torch.models import norm

    inner = norm.world_size
    norm.world_size = lambda: 2
    try:
        yield
    finally:
        norm.world_size = inner


def annotation(e) -> bool:
    """A user range, such as DDP's "DistributedDataParallel.forward": the
    profiler books under it the Python time of everything it spans that is
    not an operation, which without the range is booked nowhere."""
    return bool(getattr(e, "is_user_annotation", False))


def host_ops(prof, steps):
    """CPU self time per step by operation name, in ms, user ranges left
    out."""
    out = collections.Counter()
    for e in prof.key_averages():
        if not annotation(e):
            out[e.key] += e.self_cpu_time_total / 1e3 / steps
    return out


def main():
    import chip_smoke as cs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sniper_tpu_torch.config import load_config
    from sniper_tpu_torch.models.init import init_detector
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.ops import cuda
    from sniper_tpu_torch.parallel import distributed
    from sniper_tpu_torch.train.optimizer import make_optimizer
    from sniper_tpu_torch.train.trainer import make_train_step

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--profiled", type=int, default=3)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_ddp: needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    cuda.build()
    cuda.library()
    cfg = cs.train_cfg(load_config(os.path.join(ROOT, cs.CONFIG)))
    store = tempfile.mkdtemp(prefix="profile_ddp_")
    distributed.init_group(f"file://{store}/rendezvous", 1, 0, dev,
                           backend="nccl")
    base = init_detector(get_model(cfg), seed=0)
    batch, pri = cs.step_batch(cfg, base, 16, 512)
    batch = {k: v.to(dev) for k, v in batch.items()}
    pri = tuple(t.to(dev) for t in pri)
    wraps = forms(dev)

    def stepper(name):
        model = copy.deepcopy(base).to(dev)
        opt, sched, _ = make_optimizer(cfg, 100, model)
        step = make_train_step(wraps[name](model), opt, sched,
                               cfg.TRAIN.BATCH_IMAGES,
                               rpn_batch_size=cfg.TRAIN.RPN_BATCH_SIZE)

        def run():
            with (sync_batchnorm_path() if name == SYNC
                  else contextlib.nullcontext()):
                return step(batch, priorities=pri)
        return run

    medians = {n: [] for n in wraps}
    peaks = {n: [] for n in wraps}
    for rep in range(args.reps):
        order = list(wraps) if rep % 2 == 0 else list(wraps)[::-1]
        for name in order:
            run = stepper(name)
            times, losses = [], []
            torch.cuda.reset_peak_memory_stats(dev)
            for _ in range(args.warmup + args.steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(run()["loss"])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            t = sorted(times[args.warmup:])
            medians[name].append(t[len(t) // 2])
            peaks[name].append(torch.cuda.max_memory_allocated(dev) / 2**30)
            print(f"{name}, pass {rep + 1}: median {t[len(t) // 2]:.2f} ms "
                  f"per step (min {t[0]:.2f}, max {t[-1]:.2f}, "
                  f"{args.steps} steps after {args.warmup}), peak "
                  f"{peaks[name][-1]:.2f} GiB; loss at steps 1 / 2 / "
                  f"{len(losses)}: {float(losses[0]):.6f} / "
                  f"{float(losses[1]):.6f} / {float(losses[-1]):.6f}")
            del run
            torch.cuda.empty_cache()

    per_step = {}
    ops = {}
    for name in wraps:
        run = stepper(name)
        for _ in range(args.warmup):
            run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.profiled):
                run()
            torch.cuda.synchronize()
        ops[name] = host_ops(prof, args.profiled)
        # the kernels themselves: a CPU op's device time repeats its
        # kernels', and a user annotation's spans them
        dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and not annotation(e)) / 1e3 / args.profiled
        per_step[name] = {"host_ops_cpu_ms": sum(ops[name].values()),
                          "device_ms": dev_ms}
        del run
        torch.cuda.empty_cache()
    for a, b in (("DDP", "one process"), (SYNC, "DDP")):
        diff = ops[a].copy()
        diff.subtract(ops[b])
        top = sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:8]
        print(f"{a} against {b}, host CPU ms per step by operation: "
              + ", ".join(f"{k} {v:+.2f}" for k, v in top))
    torch.distributed.destroy_process_group()
    print(json.dumps({"card": cs.card_line(), "median_ms": medians,
                      "peak_gib": peaks, "per_step": per_step}))


if __name__ == "__main__":
    main()
