"""The readings that the limits of a cell are set from, on the card.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,... \\
        --control-seeds 101,102,103 [--seconds 3] \\
        [--plant stale_replay] [--out FILE]

For each of ``--seeds``, one run of the cell as run.py makes it (set-up, a
short window, the check against the reference) and its compared numbers.
With ``--plant stale_replay`` those runs are of a faulty program: a replayed
training step that copies no new batch into its graph's inputs
(``_StepGraph.load`` does nothing), so that the compared replayed steps 2
and 3 re-run batch 0.
For each of ``--control-seeds``, the control: the reference with its trunk
in fp8 (reference/model.py) put in the program's place on the same
traffic, compared with the fp32 reference the same way; for training
cells also the fault of half the batch left out (the reference stepping
on the first half of each batch's chips, the losses' means over those),
and the activations' scales that the seeded weights give. One JSON line
per reading on standard output and in ``--out``. The benchmark's runs do
not run this.
"""

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import run as bench  # noqa: E402
from benchmark.core import harness, traffic as gen  # noqa: E402
from benchmark.core.program import reference_model, seeded_weights  # noqa
from benchmark.reference import compare, ops  # noqa: E402


def _ref(config, seed, dev, fp8=False):
    m = reference_model(config, dev)
    m.load_state_dict(seeded_weights(config, seed, dev))
    m.set_fp8(fp8)
    return m


def control_detections(ctx, emit):
    """The fp8 reference's detections on two batches a scale, against the
    fp32 reference."""
    config, tr = ctx.cell["config"], ctx.cell["traffic"]
    dev = ctx.device
    specs = gen.scale_specs(config["yml"], tr["width"], tr["height"])
    pool = gen.image_pool(tr, specs, ctx.seed, dev)
    rounds = gen.Rounds(tr, ctx.seed)
    ref = _ref(config, ctx.seed, dev).eval()
    ctl = _ref(config, ctx.seed, dev, fp8=True).eval()
    thresh = float(config["yml"]["TEST"]["RPN_NMS_THRESH"])
    rows = []
    with ctx.fp32(), torch.no_grad():
        for _ in range(2):
            idx = rounds.next()
            for sp, (canvas, info) in zip(specs, pool):
                b = sp["batch"]
                data = canvas[torch.as_tensor(idx[:b], device=dev)]
                im_info = np.tile(info, (b, 1))
                out = ctl.infer(data, torch.as_tensor(im_info, device=dev),
                                sp["post_nms"])
                cls_prob, bbox = ctl.head(out["roi_map"], out["rois"])
                rois = out["rois"].cpu().numpy()
                valid = out["roi_valid"].cpu().numpy()
                scores, boxes = zip(*(compare._decode(
                    rois[i], cls_prob[i].cpu().numpy(),
                    bbox[i].cpu().numpy(), valid[i], im_info[i],
                    im_info[i][2]) for i in range(b)))
                sample = dict(data=data, im_info=im_info,
                              post_nms=sp["post_nms"], rois=rois,
                              roi_valid=valid, scores=list(scores),
                              boxes=list(boxes))
                rows.append(compare.compare_detections(ref, sample, thresh))
                if len(rows) == 1:
                    emit(dict(kind="scales", **scales(ref, data, im_info)))
    emit(dict(kind="control", **compare.worst(rows)))


def scales(ref, data, im_info):
    """Activation scales of the reference on one batch: the trunk's output
    (rms), the RPN's fg probabilities (percentiles), the C5 offsets (rms,
    largest) and the RPN's box deltas (rms)."""
    offs = []
    conv = ops.deformable_conv

    def recording(x, off, w, **kw):
        offs.append(off.detach().float().flatten())
        return conv(x, off, w, **kw)

    ops.deformable_conv = recording
    try:
        info = torch.as_tensor(im_info, device=data.device)
        feat, cls, bbox, fg, _ = ref.shared(ref.normalize(data, info))
    finally:
        ops.deformable_conv = conv
    q = torch.quantile(fg.flatten()[:1_000_000].float(),
                       torch.tensor([0.01, 0.5, 0.99], device=fg.device))
    off = torch.cat(offs)
    return dict(feat_rms=float(feat.float().pow(2).mean().sqrt()),
                fg_q01_50_99=[float(v) for v in q],
                c5_offset_rms_px=float(off.pow(2).mean().sqrt()),
                c5_offset_absmax_px=float(off.abs().max()),
                rpn_delta_rms=float(bbox.pow(2).mean().sqrt()))


def control_training(ctx, emit):
    """The fp8 reference's first steps, and those of the fp32 reference on
    half of each batch's chips, against the fp32 reference."""
    config, tr = ctx.cell["config"], ctx.cell["traffic"]
    dev = ctx.device
    batches, pri = gen.chip_pool(tr, config["yml"], ctx.seed, dev)
    n = compare.TRAIN_STEPS
    batches, pri = batches[:n], pri[:n]
    fixed = config["yml"]["network"]["FIXED_PARAMS"]
    weights = seeded_weights(config, ctx.seed, dev)
    args = train_driver().sample_args(config, batches)
    h = int(tr["batch"]) // 2
    half_b = [{k: v[:h] for k, v in b.items()} for b in batches]
    half_p = [tuple(p[:h] for p in ps) for ps in pri]

    def side_of(model, bs, ps):
        """A model put in the program's place: its own steps and samples."""
        losses, grad1, delta, _ = compare.reference_steps(
            model, config["yml"], bs, ps, weights, fixed)
        samples = []
        for b, p in zip(bs, ps):
            with torch.no_grad():
                samples.append(model.sample(b, p)[0])
        return losses, grad1, delta, samples

    with ctx.fp32():
        for kind, model, bs, ps in (
                ("control", fp8_model(config, dev), batches, pri),
                ("fault_half_batch", reference_model(config, dev), half_b,
                 half_p)):
            side = side_of(model, bs, ps)
            del model
            ref_run = compare.reference_steps(
                reference_model(config, dev), config["yml"], batches, pri,
                weights, fixed, given=side[3])
            emit(dict(kind=kind, **compare.with_replay(
                compare.compare_training(side, ref_run, *args)),
                      look=compare.worst_leaves(side, ref_run)))


def train_driver():
    return harness.load_module(harness.BENCH / "drivers" / "train_step.py")


def fp8_model(config, dev):
    m = reference_model(config, dev)
    m.set_fp8(True)
    return m


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    p.add_argument("--config", default=None,
                   help="another configuration's file under the cell's "
                        "traffic (a cell the benchmark does not hold)")
    p.add_argument("--fp32-trunk", action="store_true",
                   help="the program with TRAIN.bf16 off: a witness of what "
                        "the trunk's bf16 alone moves")
    p.add_argument("--plant", choices=("stale_replay",), default=None,
                   help="a fault planted in the program for the seeds' runs")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate: no CUDA device")
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    if args.config:
        cell["config"] = harness.load_json(
            harness.BENCH / "configs" / f"{args.config}.json")
    if args.fp32_trunk:
        cell["config"]["yml"]["TRAIN"]["bf16"] = False
    peak = bench.peak_bf16(torch.cuda.get_device_name(dev))
    out = open(args.out, "a") if args.out else None

    def emit(row):
        row = dict(workload=args.workload, config=cell["config"]["name"],
                   fp32_trunk=args.fp32_trunk, **row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    if args.plant == "stale_replay":
        from sniper_tpu_torch.train import trainer

        trainer._StepGraph.load = lambda self, batch, priorities: None
    for s in filter(None, args.seeds.split(",")):
        t = time.time()
        with contextlib.redirect_stdout(sys.stderr):
            res, checks = bench.execute(cell, int(s), args.seconds, False,
                                        dev, t_start=t, peak=peak)
        emit(dict(kind=f"fault_{args.plant}" if args.plant else "program",
                  seed=int(s), s=time.time() - t,
                  look=res.get("look"),
                  metrics={k: v["value"] for k, v in res["metrics"].items()},
                  memory_peak_bytes=res["device"]["memory_peak_bytes"],
                  **{k: v for k, v, _ in checks}))
        torch.cuda.empty_cache()
    for s in filter(None, args.control_seeds.split(",")):
        ctx = bench.Context(cell, int(s), 0, False, dev, time.time(), peak)
        t = time.time()
        if cell["traffic"]["driver"] == "pyramid":
            control_detections(ctx, lambda r: emit(dict(seed=int(s), **r)))
        else:
            control_training(ctx, lambda r: emit(dict(seed=int(s), **r)))
        emit(dict(kind="control_s", seed=int(s), s=time.time() - t))
        torch.cuda.empty_cache()
    if out:
        out.close()


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    main()
