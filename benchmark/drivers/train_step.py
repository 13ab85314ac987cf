"""SNIPER training steps, back to back on batches resident on the card.

Set-up builds the registry's detector with the seed's weights,
``train.optimizer.make_optimizer`` on it (the yml's SGD: momentum, weight
decay, the warm-up schedule, FIXED_PARAMS) and
``train.trainer.make_train_step``, makes the pool of ``n_batches``
distinct batches of chips with their RPN targets and sampler priorities,
and drives that one step object through its first ``TRAIN_STEPS`` steps on
batches 0, 1, 2: the window's own call and feed. After step 1 it keeps the
first gradient as the optimizer got it (its momentum buffer less the
weight decay of the initial weights), after step 3 the parameters. Those
steps also build the kernels and run every shape of the cell.

The window: steps on batch k mod ``n_batches`` with its priorities; every
``read_every`` steps the loss reaches the host, as a training log reads
it. A CUDA event is recorded on the stream at each step's start and read
at the end, so that the host never waits mid-window. The window closes
after the first step that starts past ``seconds``, at a synchronise.

Afterwards the reference repeats the first three steps (reference/
compare.py).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.core import harness, traffic as gen
from benchmark.core.program import program_model, reference_model, \
    seeded_weights
from benchmark.reference import compare
from benchmark.yardstick import flops as yflops
from benchmark.yardstick import kernels as yk


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Marks:
    """Step-start marks: CUDA events on the card, the host clock on the
    CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def gaps_s(self):
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) * 1e-3 for a, b in zip(m, m[1:])]
        return [b - a for a, b in zip(m, m[1:])]


class Trainer:
    def __init__(self, ctx):
        from sniper_tpu_torch.train.optimizer import make_optimizer
        from sniper_tpu_torch.train.trainer import make_train_step

        self.device = dev = ctx.device
        self.config, tr = ctx.cell["config"], ctx.cell["traffic"]
        self.traffic = tr
        self.cfg, self.model = program_model(self.config, ctx.seed, dev)
        ctx.note(f"set-up: program built at {ctx.clock() - ctx.t_start:.2f} s")
        yml_tr = self.config["yml"]["TRAIN"]
        if int(tr["batch"]) != int(yml_tr["BATCH_IMAGES"]):
            raise ValueError("the traffic's batch is not TRAIN.BATCH_IMAGES")
        self.opt, sched, _ = make_optimizer(self.cfg, int(tr["epoch_size"]),
                                            self.model)
        self.step_fn = make_train_step(
            self.model, self.opt, sched, int(tr["batch"]),
            rpn_batch_size=self.cfg.TRAIN.RPN_BATCH_SIZE,
            pixel_means=self.cfg.network.PIXEL_MEANS)
        self.batches, self.priorities = gen.chip_pool(tr, self.config["yml"],
                                                      ctx.seed, dev)
        ctx.note(f"set-up: traffic made at {ctx.clock() - ctx.t_start:.2f} s")
        self.k = 0
        self.spans = {"dispatch": []}

    def step(self, spans=False):
        i = self.k % len(self.batches)
        self.k += 1
        t = time.perf_counter()
        metrics = self.step_fn(self.batches[i], self.priorities[i])
        if spans:
            self.spans["dispatch"].append(time.perf_counter() - t)
        return metrics

    def trainable(self):
        return [(n, p) for n, p in self.model.named_parameters()
                if p.requires_grad]

    def first_steps(self):
        """Steps 1-3 with what the comparison reads: (losses, the first
        gradient, the parameters after step 3, each step's sample of rois
        as the detector's output hands it to the losses), kept on the
        card."""
        wd = float(self.cfg.TRAIN.wd)
        before = {n: p.detach().clone() for n, p in self.trainable()}
        losses, grad1, samples = [], {}, []

        def keep(_module, _args, out):
            samples.append(tuple(out[k].detach().clone() for k in (
                "rois", "rcnn_labels", "rcnn_bbox_targets",
                "rcnn_bbox_weights")))

        hook = self.model.register_forward_hook(keep)
        try:
            for k in range(compare.TRAIN_STEPS):
                losses.append(self.step()["loss"])
                if k == 0:
                    grad1 = {n: self.opt.state[p]["momentum_buffer"].detach()
                             - wd * before[n] for n, p in self.trainable()}
        finally:
            hook.remove()
        del before
        after = {n: p.detach().clone() for n, p in self.trainable()}
        return losses, grad1, after, samples

    def loop(self, *, seconds=None, steps=None, spans=False, marks=None):
        """Steps until one starts past ``seconds`` (or ``steps`` of them),
        the loss read every read_every steps; ends at a synchronise.
        Returns (steps, seconds)."""
        every = int(self.traffic["read_every"])
        t0 = time.perf_counter()
        n = 0
        while (n < steps if steps is not None
               else time.perf_counter() - t0 < seconds):
            if marks is not None:
                marks.mark()
            metrics = self.step(spans)
            n += 1
            if n % every == 0:
                float(metrics["loss"])
        if marks is not None:
            marks.mark()
        _sync(self.device)
        return n, time.perf_counter() - t0

    def step_flops(self):
        ref = reference_model(self.config)
        tr = self.traffic
        return sum(yflops.detector_flops(
            ref, int(tr["batch"]), (int(tr["chip"]),) * 2,
            int(self.config["yml"]["TRAIN"]["RPN_POST_NMS_TOP_N"]),
            train=True,
            fixed_params=self.config["yml"]["network"]["FIXED_PARAMS"]))

    def kernel_bounds(self, steps):
        """Summed least seconds of X1 and X2 (three C5 units each), P1/P2
        and P3 over ``steps`` steps."""
        ref = reference_model(self.config)
        c5 = ref.trunk.stage4_unit1.conv2_weight.shape[0]
        tr = self.traffic
        B, f = int(tr["batch"]), int(tr["chip"]) // 16
        R = B * int(self.config["yml"]["TRAIN"]["RPN_POST_NMS_TOP_N"])
        return {"deform_im2col": steps * 3 * yk.im2col(B, f, f, c5),
                "deform_im2col_bwd": steps * 3 * yk.im2col_bwd(B, f, f, c5),
                "fused_pool": steps * yk.pool(B, f, f, 256, R),
                "fused_pool_bwd": steps * yk.pool_bwd(B, f, f, 256, R)}


def run(ctx):
    tn = Trainer(ctx)
    losses, grad1, after, samples = tn.first_steps()
    _sync(tn.device)
    setup_s = ctx.clock() - ctx.t_start
    ctx.window_starts()
    marks = _Marks(tn.device)
    steps, window_s = tn.loop(seconds=ctx.seconds, spans=True, marks=marks)
    B = int(tn.traffic["batch"])
    gaps = marks.gaps_s()
    rec = dict(window_s=window_s, steps=steps, units=steps, spans=tn.spans,
               step_flops=tn.step_flops())
    ctx.window_ends(rec)
    if ctx.trace:
        n = int(tn.traffic["traced_steps"])
        with harness.Profiled() as prof:
            with prof.slice():
                tn.loop(steps=n)
        rec["trace"] = prof.summary(yk.group_of)
        rec["slice_units"] = n
        rec["bounds"] = tn.kernel_bounds(n)
    e2e = {"train_chips_per_s": steps * B / window_s,
           "train_step_p95_ms": harness.p95(gaps) * 1e3,
           "setup_s": setup_s}
    q = np.percentile(gaps, [50, 90, 95, 99, 100]) * 1e3
    ctx.note(f"{steps} steps; step ms p50/p90/p95/p99/max "
             + "/".join(f"{v:.2f}" for v in q) + "; first losses "
             + ", ".join(f"{float(v):.6f}" for v in losses))
    side = ([float(v) for v in losses], grad1,
            {n: p - w for (n, p), w in zip(
                after.items(), _initial(ctx, after).values())}, samples)
    batches = [tn.batches[k] for k in range(compare.TRAIN_STEPS)]
    priorities = [tn.priorities[k] for k in range(compare.TRAIN_STEPS)]
    del tn, after
    ctx.free()
    return dict(e2e=e2e, record=rec, attempted=steps * B, failed=0,
                checks=judge(ctx, side, batches, priorities))


def _initial(ctx, names):
    """The initial weights of the named leaves, made again from the
    seed."""
    w = seeded_weights(ctx.cell["config"], ctx.seed, ctx.device)
    return {n: w[n] for n in names}


def judge(ctx, side, batches, priorities):
    """The first three steps of the reference, and the compared numbers of
    ``side`` (losses, first gradient, change) against them."""
    config = ctx.cell["config"]
    ref = reference_model(config, ctx.device)
    weights = seeded_weights(config, ctx.seed, ctx.device)
    with ctx.fp32():
        ref_run = compare.reference_steps(
            ref, config["yml"], batches, priorities, weights,
            config["yml"]["network"]["FIXED_PARAMS"], given=side[3])
    nums = compare.compare_training(side, ref_run, *sample_args(config,
                                                                 batches))
    ctx.look = compare.worst_leaves(side, ref_run)
    return [(k, nums[k], lim) for k, lim in ctx.cell["limits"].items()]


def sample_args(config, batches):
    """compare_training's GT boxes of step 1 and its two thresholds."""
    yml = config["yml"]
    return (batches[0]["gt_boxes"], float(yml["TRAIN"]["FG_THRESH"]),
            float(yml["TRAIN"]["RPN_NMS_THRESH"]))
