"""SNIPER training steps, back to back on batches resident on the card.

Set-up builds the registry's detector with the seed's weights,
``train.optimizer.make_optimizer`` on it (the yml's SGD: momentum, weight
decay, the warm-up schedule, FIXED_PARAMS) and
``train.trainer.make_train_step``, makes the pool of ``n_batches``
distinct batches of chips with their RPN targets and sampler priorities,
and drives that one step object through its first ``TRAIN_STEPS`` steps on
batches 0, 1, 2: the window's own call and feed. A forward hook reads each
step's sample of rois, which keeps those steps eager (the port replays no
hooked model). After step 1 it keeps the first gradient as the optimizer
got it (its momentum buffer less the weight decay of the initial weights),
after step 3 the parameters. Those steps also build the kernels and run
every shape of the cell.

Then the state from before step 1 is put back in place (``copy_``, so that
the tensors a CUDA graph is captured on stay those of the window): the
parameters and the BatchNorms' running statistics, the momentum (none
before step 1: zeroed, which SGD's next step then sets to the gradient,
as it does with none) and the scheduler. The hook removed, the same step
object takes batches 0, 1, 2 again: on one CUDA card the first of them
captures the step's graph and all three replay it, as every step of the
window does, so the capture falls in set-up. Those replayed steps are
compared too; on the CPU nothing replays, and they repeat the eager ones.
The card's peak memory over them (``step_peak_bytes``) is kept apart: a
replay allocates nothing, so the window's own peak leaves out the step's
activations, which the capture allocated.

The window: steps on batch k mod ``n_batches`` with its priorities, from
batch 3; every ``read_every`` steps the loss reaches the host, as a
training log reads it. A CUDA event is recorded on the stream at each
step's start and read at the end, so that the host never waits
mid-window. The window closes after the first step that starts past
``seconds``, at a synchronise.

A traced run then takes ``drained_steps`` steps each with the card
drained before it, and keeps the seconds of each step's call
(``dispatch``): the host's own work, since a call that finds the launch
queue empty never waits in it. In the window the host runs ahead until
the queue is full, and then spins in the call until there is room, which
the thread's CPU clock counts as well as the wall clock does; a thread's
CPU clock may also tick too coarsely (every 10 ms on some hosts) for a
call of a few milliseconds. Then the profiled slice: ``traced_steps``
steps as the window takes them.

Afterwards the reference repeats the first three steps twice (reference/
compare.py): once following the eager steps' sample of rois, once the
replayed steps', and each side is held to the run that follows it.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from benchmark.core import harness, traffic as gen
from benchmark.core.program import program_model, reference_model, \
    seeded_weights
from benchmark.reference import compare
from benchmark.yardstick import flops as yflops
from benchmark.yardstick import kernels as yk

# the detector's outputs that make a step's sample of rois
SAMPLE_KEYS = ("rois", "rcnn_labels", "rcnn_bbox_targets",
               "rcnn_bbox_weights")


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
        # the port replays a step's graph only on a CUDA card
        self.on_card = dev.type == "cuda"
        self.config, tr = ctx.cell["config"], ctx.cell["traffic"]
        self.traffic = tr
        self.cfg, self.model = program_model(self.config, ctx.seed, dev)
        ctx.note(f"set-up: program built at {ctx.clock() - ctx.t_start:.2f} s")
        yml_tr = self.config["yml"]["TRAIN"]
        if int(tr["batch"]) != int(yml_tr["BATCH_IMAGES"]):
            raise ValueError("the traffic's batch is not TRAIN.BATCH_IMAGES")
        self.opt, self.sched, _ = make_optimizer(
            self.cfg, int(tr["epoch_size"]), self.model)
        self.step_fn = make_train_step(
            self.model, self.opt, self.sched, int(tr["batch"]),
            rpn_batch_size=self.cfg.TRAIN.RPN_BATCH_SIZE,
            pixel_means=self.cfg.network.PIXEL_MEANS)
        self.batches, self.priorities = gen.chip_pool(tr, self.config["yml"],
                                                      ctx.seed, dev)
        ctx.note(f"set-up: traffic made at {ctx.clock() - ctx.t_start:.2f} s")
        self.k = 0
        self.spans = {"dispatch": []}

    def step(self):
        i = self.k % len(self.batches)
        self.k += 1
        return self.step_fn(self.batches[i], self.priorities[i])

    def trainable(self):
        return [(n, p) for n, p in self.model.named_parameters()
                if p.requires_grad]

    def state(self):
        """The training state, copied: the model's parameters and buffers
        (the BatchNorms' running statistics), the learning rates and the
        scheduler's state. The momentum is not kept: ``restore`` puts back
        the state from before step 1, which has none."""
        return ({k: v.clone() for k, v in self.model.state_dict().items()},
                [g["lr"] for g in self.opt.param_groups],
                copy.deepcopy(self.sched.state_dict()))

    @torch.no_grad()
    def restore(self, state):
        """Put back ``state`` (from before step 1) in place, momentum
        zeroed, so that every tensor a captured graph reads stays valid;
        the next step takes batch 0."""
        tensors, lrs, sched = state
        for k, v in self.model.state_dict().items():
            v.copy_(tensors[k])
        for g, lr in zip(self.opt.param_groups, lrs):
            g["lr"] = lr
            for p in g["params"]:
                buf = self.opt.state.get(p, {}).get("momentum_buffer")
                if buf is not None:
                    buf.zero_()
        self.sched.load_state_dict(sched)
        self.k = 0

    def first_steps(self, start):
        """Steps 1-3 from the state ``start`` with what the comparison
        reads: (losses, the first gradient, the parameters after step 3,
        each step's sample of rois as the detector's output hands it to
        the losses), kept on the card."""
        wd = float(self.cfg.TRAIN.wd)
        losses, grad1, samples = [], {}, []

        def keep(_module, _args, out):
            samples.append(tuple(out[k].detach().clone()
                                 for k in SAMPLE_KEYS))

        hook = self.model.register_forward_hook(keep)
        try:
            for k in range(compare.TRAIN_STEPS):
                losses.append(self.step()["loss"])
                if k == 0:
                    grad1 = {n: self.opt.state[p]["momentum_buffer"].detach()
                             - wd * start[0][n] for n, p in self.trainable()}
        finally:
            hook.remove()
        return losses, grad1, self.trained(), samples

    def replayed_steps(self, start):
        """Steps 1-3 again, from the state ``start`` put back in place and
        with no hook: on one CUDA card the first captures the step's graph
        and all three replay it. (losses, the parameters after step 3,
        each step's sample of rois, the steps that ran eagerly where the
        port replays.)

        The sample is read where the losses get the detector's output
        (``trainer.total_loss``, wrapped for these steps): the wrapper
        keeps the output's tensors, which a capture allocates in its
        graph's memory and every replay then writes, and each step's
        sample is copied from them after the step. The wrapper runs where
        the step runs Python, in the capture and not in a replay, and
        launches nothing."""
        from sniper_tpu_torch.train import trainer

        self.restore(start)
        loss_fn = trainer.total_loss
        out = []

        def keep(model_out, *args, **kwargs):
            out[:] = [model_out[k].detach() for k in SAMPLE_KEYS]
            return loss_fn(model_out, *args, **kwargs)

        losses, samples, eager = [], [], 0
        trainer.total_loss = keep
        try:
            for _ in range(compare.TRAIN_STEPS):
                losses.append(self.step()["loss"])
                samples.append(tuple(t.clone() for t in out))
                if self.on_card and self.step_fn.eager_reason is not None:
                    eager += 1
        finally:
            trainer.total_loss = loss_fn
        return losses, self.trained(), samples, eager

    def trained(self):
        return {n: p.detach().clone() for n, p in self.trainable()}

    def drained(self, steps):
        """``steps`` steps, each after a synchronise, with the seconds of
        each call kept under ``dispatch``."""
        for _ in range(steps):
            _sync(self.device)
            t = time.perf_counter()
            self.step()
            self.spans["dispatch"].append(time.perf_counter() - t)
        _sync(self.device)

    def loop(self, *, seconds=None, steps=None, marks=None):
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
            metrics = self.step()
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


def _peak(device, reset=False):
    """The card's peak allocated bytes since the last reset (0 on the
    CPU), the peak then reset where ``reset``."""
    if device.type != "cuda":
        return 0
    v = torch.cuda.max_memory_allocated(device)
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return v


def run(ctx):
    tn = Trainer(ctx)
    start = tn.state()
    losses, grad1, after, samples = tn.first_steps(start)
    _sync(tn.device)
    ctx.note(f"set-up: eager steps at {ctx.clock() - ctx.t_start:.2f} s")
    eager_peak = _peak(tn.device, reset=True)
    r_losses, r_after, r_samples, eager = tn.replayed_steps(start)
    del start
    _sync(tn.device)
    # the capture's and the replays' peak: a replay allocates nothing, so
    # the window's own peak leaves out the step's activations
    step_peak = _peak(tn.device)
    ctx.note(f"set-up: replayed steps at {ctx.clock() - ctx.t_start:.2f} s")
    setup_s = ctx.clock() - ctx.t_start
    ctx.window_starts()
    marks = _Marks(tn.device)
    steps, window_s = tn.loop(seconds=ctx.seconds, marks=marks)
    B = int(tn.traffic["batch"])
    gaps = marks.gaps_s()
    rec = dict(window_s=window_s, steps=steps, units=steps, spans=tn.spans,
               step_flops=tn.step_flops(), step_peak_bytes=step_peak)
    ctx.window_ends(rec)
    rec["memory_peak_bytes"] = max(rec.get("memory_peak_bytes", 0),
                                   eager_peak)
    if ctx.trace:
        n = int(tn.traffic["traced_steps"])
        tn.drained(int(tn.traffic["drained_steps"]))
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
             + ", ".join(f"{float(v):.6f}" for v in losses) + "; replayed "
             + ", ".join(f"{float(v):.6f}" for v in r_losses))
    initial = _initial(ctx, after)
    side = ([float(v) for v in losses], grad1,
            {n: p - initial[n] for n, p in after.items()}, samples)
    replayed = ([float(v) for v in r_losses], None,
                {n: p - initial[n] for n, p in r_after.items()}, r_samples)
    batches = [tn.batches[k] for k in range(compare.TRAIN_STEPS)]
    priorities = [tn.priorities[k] for k in range(compare.TRAIN_STEPS)]
    del tn, after, r_after, initial
    ctx.free()
    return dict(e2e=e2e, record=rec, attempted=steps * B, failed=0,
                checks=judge(ctx, side, batches, priorities, replayed,
                             eager))


def _initial(ctx, names):
    """The initial weights of the named leaves, made again from the
    seed."""
    w = seeded_weights(ctx.cell["config"], ctx.seed, ctx.device)
    return {n: w[n] for n in names}


def judge(ctx, side, batches, priorities, replayed, eager):
    """The first three steps of the reference, once following the sample
    of ``side`` (the eager steps: losses, first gradient, change, samples)
    and once that of ``replayed`` (the replayed steps, likewise, with no
    first gradient), and the compared numbers of each against the run
    that follows it; ``eager`` is ``eager_in_replay``."""
    config = ctx.cell["config"]
    ref = reference_model(config, ctx.device)
    weights = seeded_weights(config, ctx.seed, ctx.device)
    args = sample_args(config, batches)
    runs = []
    with ctx.fp32():
        for s in (side, replayed):
            runs.append(compare.reference_steps(
                ref, config["yml"], batches, priorities, weights,
                config["yml"]["network"]["FIXED_PARAMS"], given=s[3]))
    nums = compare.with_replay(
        compare.compare_training(side, runs[0], *args),
        compare.compare_training(replayed, runs[1], *args))
    nums["eager_in_replay"] = eager
    ctx.look = compare.worst_leaves(side, runs[0])
    return [(k, nums[k], lim) for k, lim in ctx.cell["limits"].items()]


def sample_args(config, batches):
    """compare_training's GT boxes of each step and its two thresholds."""
    yml = config["yml"]
    return ([b["gt_boxes"] for b in batches],
            float(yml["TRAIN"]["FG_THRESH"]),
            float(yml["TRAIN"]["RPN_NMS_THRESH"]))
