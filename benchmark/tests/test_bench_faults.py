"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have, and the control reads far above the program.

Each case drives the rest of a run (run.py's ``execute``, the look for a
card skipped) at a tiny size on the CPU, under the cells' own limits,
with the port broken where the fault would arise:

- pyramid cells: an answer altered where the detector produces it; half of
  each batch left out, its outputs those of the other half;
- training cells: a step that leaves the parameters as they were; half of
  each batch left out, the losses' means taken over the rest.

The controls' readings on the card set the limits' upper ends
(benchmark/calibrate.py); here the same control, the reference with an
fp8 trunk, is read at the tiny size beside a sound run of the program."""

import time

import pytest
import torch

import tiny
from benchmark.core import harness

SEED = 2**31 + 29


def run(cell):
    mod = harness.load_module(harness.BENCH / "run.py")
    res, _ = mod.execute(cell, SEED, 0.2, False, torch.device("cpu"),
                         t_start=time.time(), peak=989e12)
    return res


@pytest.fixture
def detector():
    from sniper_tpu_torch.models.detector import SNIPERDetector

    return SNIPERDetector


def altered_answer(monkeypatch, detector):
    forward = detector.forward

    def fwd(self, data, im_info, *a, train=False, **kw):
        out = forward(self, data, im_info, *a, train=train, **kw)
        if not train:
            out["cls_prob"] = out["cls_prob"].clone()
            out["cls_prob"][:, 0, 1] += 0.25
        return out

    monkeypatch.setattr(detector, "forward", fwd)


def half_inference_batch(monkeypatch, detector):
    forward = detector.forward

    def fwd(self, data, im_info, *a, train=False, **kw):
        if train:
            return forward(self, data, im_info, *a, train=train, **kw)
        h = data.shape[0] // 2
        out = forward(self, data[:h], im_info[:h], *a, **kw)
        return {k: torch.cat([v, v]) for k, v in out.items()}

    monkeypatch.setattr(detector, "forward", fwd)


def unchanged_state(monkeypatch, detector):
    from sniper_tpu_torch.train import optimizer

    make = optimizer.make_optimizer

    def make_frozen(cfg, epoch_size, model):
        opt, sched, schedule = make(cfg, epoch_size, model)
        step = opt.step

        def keep_params(*a, **kw):
            saved = [p.detach().clone() for g in opt.param_groups
                     for p in g["params"]]
            out = step(*a, **kw)
            with torch.no_grad():
                for p, s in zip((p for g in opt.param_groups
                                 for p in g["params"]), saved):
                    p.copy_(s)
            return out

        opt.step = keep_params
        return opt, sched, schedule

    monkeypatch.setattr(optimizer, "make_optimizer", make_frozen)


def half_train_batch(monkeypatch, detector):
    from sniper_tpu_torch.train import trainer

    make = trainer.make_train_step

    def make_half(model, opt, sched, batch_images, **kw):
        step = make(model, opt, sched, batch_images // 2, **kw)

        def half(batch, priorities=None):
            h = batch["data"].shape[0] // 2
            return step({k: v[:h] for k, v in batch.items()},
                        tuple(p[:h] for p in priorities))

        return half

    monkeypatch.setattr(trainer, "make_train_step", make_half)


FAULTS = {"r101_pyramid": (altered_answer, half_inference_batch),
          "r101_train": (unchanged_state, half_train_batch)}


@pytest.mark.parametrize("workload", list(FAULTS))
def test_sound_tiny_run_is_correct(workload):
    assert run(tiny.cell(workload))["correct"]


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w, fs in FAULTS.items() for f in fs],
    ids=lambda x: getattr(x, "__name__", x))
def test_fault_comes_out_not_correct(workload, fault, monkeypatch, detector):
    fault(monkeypatch, detector)
    res = run(tiny.cell(workload))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload,number", [("r101_pyramid", "score_gap"),
                                             ("r101_train", "loss_gap")])
def test_control_reads_far_above_the_program(workload, number):
    from benchmark import calibrate, run as bench

    cell = tiny.cell(workload)
    sound = run(cell)["checks"][number]["value"]
    ctx = bench.Context(cell, SEED, 0, False, torch.device("cpu"),
                        time.time(), 989e12)
    rows = []
    if cell["traffic"]["driver"] == "pyramid":
        calibrate.control_detections(ctx, rows.append)
    else:
        calibrate.control_training(ctx, rows.append)
    control = next(r for r in rows if r["kind"] == "control")[number]
    assert control > 3 * sound
