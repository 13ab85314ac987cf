"""Multi-scale detection serving: the pyramid of test scales over a closed
loop of rounds, one round dispatched ahead.

Set-up builds the registry's detector with the seed's weights, makes the
pool of distinct images at every scale's canvas on the card, and runs
``warmup_rounds`` rounds through the window's own loop, which builds the
kernels, runs every shape of the cell once and fills the allocator.

The window: a round is ``round_images`` images drawn from the pool, each
through every test scale (``main_test.make_forward`` per scale and batch
on the resident uint8 canvases), then the Tester's host decode
(``Tester.detect_outputs``) of every batch. Round k+1 is dispatched before
round k is decoded, as main_test's loop and PR 14's bench overlap them.
Before decoding a round the host waits for the device's queue to drain,
which the Tester's first copy to the host would wait for anyway, so that
the decode span holds host work alone. The window closes after the first
round that ends past ``seconds``; every round dispatched in it is decoded
in it. Nothing is copied from the host to the card in the window: the
rounds' image indices and each scale's im_info are on the card from
set-up.

Afterwards a sample of the window's batches, drawn from the seed (each
scale's reservoir), is held against the reference (reference/compare.py).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.core import harness, traffic as gen
from benchmark.core.program import program_model, reference_model, \
    seeded_weights
from benchmark.core.weights import subseed
from benchmark.reference import compare
from benchmark.yardstick import flops as yflops
from benchmark.yardstick import kernels as yk

SAMPLES_PER_SCALE = 2
ROUNDS_STAGED = 4096  # round draws on the card; the sequence then repeats


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Pyramid:
    def __init__(self, ctx):
        from sniper_tpu_torch.infer.tester import Tester
        from sniper_tpu_torch.main_test import make_forward

        self.device = dev = ctx.device
        config, tr = ctx.cell["config"], ctx.cell["traffic"]
        self.config, self.traffic = config, tr
        self.cfg, self.model = program_model(config, ctx.seed, dev)
        self.model.eval()
        ctx.note(f"set-up: program built at {ctx.clock() - ctx.t_start:.2f} s")
        self.specs = gen.scale_specs(config["yml"], tr["width"], tr["height"])
        k = tr["round_images"]
        for sp in self.specs:
            if k % sp["batch"]:
                raise ValueError(f"round_images {k} is not a multiple of "
                                 f"the batch {sp['batch']}")
        self.pool = gen.image_pool(tr, self.specs, ctx.seed, dev)
        rounds = gen.Rounds(tr, ctx.seed)
        self.draws = np.stack([rounds.next() for _ in range(ROUNDS_STAGED)])
        self.draws_dev = torch.as_tensor(self.draws, device=dev)
        self.infos = [(torch.as_tensor(np.tile(info, (sp["batch"], 1)),
                                       device=dev),
                       np.tile(info, (sp["batch"], 1)))
                      for sp, (_, info) in zip(self.specs, self.pool)]
        self.next_round = 0
        self.tester = Tester(None, self.cfg, self.model.num_classes)
        ctx.note(f"set-up: traffic made at {ctx.clock() - ctx.t_start:.2f} s")
        self.forwards = [make_forward(self.model, None, dev,
                                      self.cfg.network.PIXEL_MEANS,
                                      post_nms_top_n=sp["post_nms"])
                         for sp in self.specs]
        self.sample_rng = np.random.default_rng(subseed(ctx.seed, "sample"))
        self.reservoir = [[] for _ in self.specs]
        self.seen = [0] * len(self.specs)
        self.spans = {"dispatch": [], "decode": [], "round": [], "late": []}

    def dispatch(self):
        """Enqueue the next round: per scale, its batches of the round's
        images. Returns [(scale, round, first image, out)]."""
        r = self.next_round % ROUNDS_STAGED
        self.next_round += 1
        idx = self.draws_dev[r]
        batches = []
        for s, (sp, fwd, (canvas, _), (info, _)) in enumerate(
                zip(self.specs, self.forwards, self.pool, self.infos)):
            b = sp["batch"]
            for j in range(0, idx.shape[0], b):
                out = fwd(canvas[idx[j:j + b]], info)
                batches.append((s, r, j, out))
        return batches

    def decode(self, batches, keep):
        """Decode every batch of a round once the device's queue has
        drained; returns the host seconds of decoding."""
        _sync(self.device)
        t = time.perf_counter()
        for s, r, j, out in batches:
            sp = self.specs[s]
            scores, boxes, _, _ = self.tester.detect_outputs(
                out, self.infos[s][1], [sp["scale"]] * sp["batch"])
            if keep:
                self._offer(s, r, j, out, scores, boxes)
        return time.perf_counter() - t

    def _offer(self, s, r, j, out, scores, boxes):
        """Reservoir sampling of each scale's decoded batches."""
        self.seen[s] += 1
        res = self.reservoir[s]
        item = dict(scale=s, sel=self.draws[r, j:j + self.specs[s]["batch"]],
                    out=out, scores=scores, boxes=boxes)
        if len(res) < SAMPLES_PER_SCALE:
            res.append(item)
        else:
            k = int(self.sample_rng.integers(self.seen[s]))
            if k < SAMPLES_PER_SCALE:
                res[k] = item

    def loop(self, *, seconds=None, rounds=None, keep=False, spans=False,
             seen=None):
        """Rounds with one dispatched ahead: ``rounds`` of them, or those
        due in ``seconds``. In a closed loop (no ``rounds_per_s`` in the
        traffic) a round is due when the previous one is dispatched, and
        the window closes after the first round that ends past
        ``seconds``. In an open loop round k is due at k / rounds_per_s;
        the host decodes what it has while the next round is not yet due,
        and waits for it only with nothing to decode. A round's latency
        runs from when it was due to its last decode's end. Returns
        (rounds, the seconds from the first due time to the last decode's
        end). ``seen`` collects each decoded batch's (scale, out)."""
        rate = self.traffic.get("rounds_per_s")
        t0 = time.perf_counter()
        pending, n, sent = None, 0, 0

        def finish(batches, due):
            nonlocal n
            spent = self.decode(batches, keep)
            n += 1
            if seen is not None:
                seen.extend((s, out) for s, _, _, out in batches)
            if spans:
                self.spans["decode"].append(spent)
                self.spans["round"].append(time.perf_counter() - due)

        while True:
            now = time.perf_counter()
            due = t0 + sent / rate if rate else now
            more = (sent < rounds if rounds is not None else
                    due - t0 < seconds if rate else
                    pending is None or now - t0 < seconds)
            if pending is not None and (not more or now < due):
                finish(*pending)
                pending = None
            if not more:
                break
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            d0 = time.perf_counter()
            nxt = (self.dispatch(), due)
            sent += 1
            if spans:
                self.spans["dispatch"].append(time.perf_counter() - d0)
                self.spans["late"].append(d0 - due)
            if pending is not None:
                finish(*pending)
            pending = nxt
        return n, time.perf_counter() - t0

    def round_flops(self):
        ref = reference_model(self.config)
        k = self.traffic["round_images"]
        return sum(sum(yflops.detector_flops(ref, sp["batch"], sp["canvas"],
                                             sp["post_nms"]))
                   * (k // sp["batch"]) for sp in self.specs)

    def kernel_bounds(self, seen):
        """Summed least seconds of X1 (three C5 units), P1/P2 and P4 over
        the batches of the traced slice."""
        ref = reference_model(self.config)
        c5 = ref.trunk.stage4_unit1.conv2_weight.shape[0]
        A = ref.rpn.A
        pre = ref.test_kw["pre_nms"]
        b = {"deform_im2col": 0.0, "fused_pool": 0.0, "nms": 0.0}
        for s, out in seen:
            sp = self.specs[s]
            B, (ch, cw) = sp["batch"], sp["canvas"]
            H, W = ch // 16, cw // 16
            b["deform_im2col"] += 3 * yk.im2col(B, H, W, c5)
            b["fused_pool"] += yk.pool(B, H, W, 256, B * sp["post_nms"])
            kept = int(out["roi_valid"].sum())
            b["nms"] += yk.nms(B, min(pre, A * H * W), sp["post_nms"], kept)
        return b

    def samples(self):
        """The reservoirs' batches: inputs and the program's outputs."""
        out = []
        for res in self.reservoir:
            for item in res:
                s = item["scale"]
                canvas, _ = self.pool[s]
                o = item["out"]
                out.append(dict(
                    data=canvas[torch.as_tensor(item["sel"],
                                                device=self.device)],
                    im_info=self.infos[s][1],
                    post_nms=self.specs[s]["post_nms"],
                    rois=o["rois"].cpu().numpy(),
                    roi_valid=o["roi_valid"].cpu().numpy(),
                    scores=item["scores"], boxes=item["boxes"]))
        return out


def run(ctx):
    py = Pyramid(ctx)
    tr = py.traffic
    py.loop(rounds=int(tr["warmup_rounds"]))
    _sync(py.device)
    setup_s = ctx.clock() - ctx.t_start
    ctx.window_starts()
    rounds, window_s = py.loop(seconds=ctx.seconds, keep=True, spans=True)
    _sync(py.device)
    images = rounds * tr["round_images"]
    rec = dict(window_s=window_s, rounds=rounds, units=rounds, images=images,
               spans=py.spans, round_flops=py.round_flops())
    ctx.window_ends(rec)
    if ctx.trace:
        seen = []
        with harness.Profiled() as prof:
            with prof.slice():
                py.loop(rounds=int(tr["traced_rounds"]), seen=seen)
                _sync(py.device)
        rec["trace"] = prof.summary(yk.group_of)
        rec["slice_units"] = int(tr["traced_rounds"])
        rec["bounds"] = py.kernel_bounds(seen)
        del seen
    e2e = {"infer_img_per_s": images / window_s,
           "serve_round_p95_ms": harness.p95(py.spans["round"]) * 1e3,
           "setup_s": setup_s}
    q = np.percentile(py.spans["round"], [50, 90, 95, 99, 100]) * 1e3
    late = np.percentile(py.spans["late"], [95, 100]) * 1e3
    ctx.note(f"{rounds} rounds; round ms p50/p90/p95/p99/max "
             + "/".join(f"{v:.2f}" for v in q)
             + f"; dispatch late p95/max {late[0]:.2f}/{late[1]:.2f} ms")
    samples = py.samples()
    del py
    ctx.free()
    return dict(e2e=e2e, record=rec, checks=judge(ctx, samples),
                attempted=images, failed=0)


def judge(ctx, samples):
    """The compared numbers of the sampled batches, those the cell's
    limits file names: the worst over the samples of each, with its
    limit."""
    config = ctx.cell["config"]
    ref = reference_model(config, ctx.device)
    ref.load_state_dict(seeded_weights(config, ctx.seed, ctx.device))
    ref.eval()
    thresh = float(config["yml"]["TEST"]["RPN_NMS_THRESH"])
    with ctx.fp32():
        rows = [compare.compare_detections(ref, s, thresh) for s in samples]
    worst = compare.worst(rows)
    return [(k, worst[k], lim) for k, lim in ctx.cell["limits"].items()]
