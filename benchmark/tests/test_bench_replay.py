"""drivers/train_step.py's order and its replayed steps' checks, at a tiny
size on the CPU, with the port's step wrapped in a step object whose
``eager_reason`` is scripted (on the card the port sets it: None where a
step replays its CUDA graph).

- the three eager steps run hooked, the three compared replayed steps
  after them unhooked, and only then does the window open;
- on a device that claims to replay (a CUDA card), a compared replayed
  step that ran eagerly makes ``correct`` false;
- the replayed steps' numbers stand in ``checks`` beside their limits,
  and on the CPU, where nothing replays, they repeat the eager steps'
  exactly: the state put back before them is the whole state;
- a replayed step's sample labelled against another batch's GT boxes
  (a replay that read stale boxes) makes ``correct`` false;
- the window's peak memory reading holds the replayed step's."""

import time

import pytest
import torch

import tiny
from benchmark.core import harness

SEED = 2**31 + 41
REPLAY_CHECKS = ("replay_roi_miss", "replay_label_gap", "replay_loss_gap",
                 "replay_delta_gap", "eager_in_replay")


class ScriptedStep:
    """The port's step, with ``eager_reason`` taken from ``reasons`` after
    each call (None once they run out), and each call logged with whether
    the model had a hook."""

    def __init__(self, step, model, reasons, log):
        self.step, self.model = step, model
        self.reasons, self.log = list(reasons), log
        self.eager_reason = None

    def __call__(self, batch, priorities=None):
        self.log.append(("step", bool(self.model._forward_hooks)))
        out = self.step(batch, priorities)
        self.eager_reason = self.reasons.pop(0) if self.reasons else None
        return out


@pytest.fixture
def scripted(monkeypatch):
    """run(reasons, claims_card, trace=False, patch=None) -> (result,
    log): a tiny r101_train run through run.py's ``execute`` with the step
    scripted, the driver's Trainer told that it is on a card where
    ``claims_card``; ``patch(driver module)`` may plant more."""
    from sniper_tpu_torch.train import trainer

    bench = harness.load_module(harness.BENCH / "run.py")
    make, load = trainer.make_train_step, harness.load_module
    log = []

    def run(reasons, claims_card, trace=False, patch=None):
        def make_scripted(model, *a, **kw):
            return ScriptedStep(make(model, *a, **kw), model, reasons, log)

        def load_patched(path):
            mod = load(path)
            if path.stem == "train_step":
                init = mod.Trainer.__init__

                def init_claiming(self, ctx):
                    init(self, ctx)
                    self.on_card = self.on_card or claims_card

                mod.Trainer.__init__ = init_claiming
                if patch is not None:
                    patch(mod)
            return mod

        starts = bench.Context.window_starts

        def window_starts(self):
            log.append(("window", None))
            starts(self)

        monkeypatch.setattr(trainer, "make_train_step", make_scripted)
        monkeypatch.setattr(harness, "load_module", load_patched)
        monkeypatch.setattr(bench.Context, "window_starts", window_starts)
        res, _ = bench.execute(tiny.cell("r101_train"), SEED, 0.2, trace,
                               torch.device("cpu"), t_start=time.time(),
                               peak=989e12)
        return res, log

    return run


WARM = ["warm-up"] * 3


def test_replayed_steps_run_after_the_eager_ones_and_before_the_window(
        scripted):
    res, log = scripted(WARM, claims_card=True)
    opened = log.index(("window", None))
    assert log[:opened] == [("step", True)] * 3 + [("step", False)] * 3
    assert len(log) > opened + 1
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("reasons", [
    [None, "hooks on the model", None],
    ["the batch is not on a CUDA device"] * 3])
def test_an_eager_replayed_step_is_not_correct(scripted, reasons):
    res, _ = scripted(WARM + reasons, claims_card=True)
    eager = sum(r is not None for r in reasons)
    assert res["checks"]["eager_in_replay"] == {"value": eager, "limit": 0}
    assert not res["correct"]


def test_replay_checks_beside_their_limits_repeat_eager_on_the_cpu(scripted):
    res, _ = scripted(WARM + ["the batch is not on a CUDA device"] * 3,
                      claims_card=False)
    limits = harness.load_cell("r101_train")["limits"]
    checks = res["checks"]
    for k in REPLAY_CHECKS:
        assert checks[k]["limit"] == limits[k]
        assert checks[k]["value"] <= checks[k]["limit"]
    assert checks["eager_in_replay"]["value"] == 0
    for k in ("roi_miss", "loss_gap", "delta_gap"):
        assert checks["replay_" + k]["value"] == checks[k]["value"]
    assert checks["replay_label_gap"]["value"] == 0
    assert res["correct"]


def test_a_replayed_sample_from_stale_boxes_is_not_correct(scripted):
    """Every replayed step's sample labelled as batch 0's: steps 2 and 3
    then hold labels that their own GT boxes do not give."""
    def stale(mod):
        replayed = mod.Trainer.replayed_steps

        def first_sample(self, start):
            losses, after, samples, eager = replayed(self, start)
            return losses, after, [samples[0]] * len(samples), eager

        mod.Trainer.replayed_steps = first_sample

    res, _ = scripted(WARM, claims_card=False, patch=stale)
    assert res["checks"]["replay_label_gap"]["value"] > 0
    assert res["checks"]["label_gap"]["value"] == 0
    assert not res["correct"]


def test_peak_memory_reads_the_replayed_steps_peak(scripted):
    """The window's peak alone leaves out what the capture allocated: the
    reader takes the larger of the two."""
    reader = harness.load_module(harness.metric_file("peak_mem_gib.train"))
    assert reader.read({"window_peak_bytes": 2 * 2**30,
                        "step_peak_bytes": 6 * 2**30}) == 6
    assert reader.read({"window_peak_bytes": 3 * 2**30}) == 3
    assert reader.read({}) is None
    res, _ = scripted(WARM, claims_card=False, trace=True)
    assert "peak_mem_gib.train" not in res["metrics"]  # no card: no peak
