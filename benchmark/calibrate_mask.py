"""The readings that r101_mask_pyramid's limits are set from, on the card.

    python3 benchmark/calibrate_mask.py --seeds 1,2,... \\
        --control-seeds 101,102,103 [--seconds 3] [--out FILE]

For each of ``--seeds``, one run of the cell as run.py makes it (set-up, a
short window, the check against the reference) and its compared numbers.
For each of ``--control-seeds``, two controls put in the program's place
on the same traffic (two batches a scale) and compared with the fp32
reference the same way: ``control`` the reference with its trunk in fp8
(reference/model.py), ``control_mask_bf16`` the reference with its mask
branch one precision below the configuration's (reference/mask.py,
``mask_precision`` "bf16"). One JSON line per reading on standard output
and in ``--out``. The benchmark's runs do not run this.
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
from benchmark.core.masks import mask_reference_model, \
    mask_seeded_weights  # noqa: E402
from benchmark.drivers import mask_pyramid  # noqa: E402
from benchmark.reference import compare  # noqa: E402

WORKLOAD = "r101_mask_pyramid"


def _ref(config, seed, dev, fp8=False, mask_bf16=False):
    m = mask_reference_model(config, dev)
    m.load_state_dict(mask_seeded_weights(config, seed, dev))
    m.set_fp8(fp8)
    m.mask_precision = "bf16" if mask_bf16 else "fp32"
    return m.eval()


def control_masks(ctx, kind, emit):
    """A control's detections and masks on two batches a scale, against
    the fp32 reference."""
    config, tr = ctx.cell["config"], ctx.cell["traffic"]
    dev = ctx.device
    specs = gen.scale_specs(config["yml"], tr["width"], tr["height"])
    pool = gen.image_pool(tr, specs, ctx.seed, dev)
    rounds = gen.Rounds(tr, ctx.seed)
    ref = _ref(config, ctx.seed, dev)
    ctl = _ref(config, ctx.seed, dev, fp8=kind == "control",
               mask_bf16=kind == "control_mask_bf16")
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
                cid = cls_prob[..., 1:].argmax(-1)
                pooled = ctl.mask_pool(out["roi_map"], out["rois"])
                masks = ctl.mask_from_pooled(pooled, cid)
                rois = out["rois"].cpu().numpy()
                valid = out["roi_valid"].cpu().numpy()
                scores, boxes = zip(*(compare._decode(
                    rois[i], cls_prob[i].cpu().numpy(),
                    bbox[i].cpu().numpy(), valid[i], im_info[i],
                    im_info[i][2]) for i in range(b)))
                sample = dict(data=data, im_info=im_info,
                              post_nms=sp["post_nms"], rois=rois,
                              roi_valid=valid, scores=list(scores),
                              boxes=list(boxes),
                              masks=list(masks.cpu().numpy()),
                              head_pooled=pooled, head_masks=masks,
                              head_cls=cid, head_valid=out["roi_valid"])
                rows.append(mask_pyramid.compare_masks(ref, sample, thresh))
    emit(dict(kind=kind, **compare.worst(rows)))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate_mask: no CUDA device")
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(WORKLOAD)
    peak = bench.peak_bf16(torch.cuda.get_device_name(dev))
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(dict(workload=WORKLOAD, **row))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for s in filter(None, args.seeds.split(",")):
        t = time.time()
        with contextlib.redirect_stdout(sys.stderr):
            res, checks = bench.execute(cell, int(s), args.seconds, False,
                                        dev, t_start=t, peak=peak)
        emit(dict(kind="program", seed=int(s), s=time.time() - t,
                  metrics={k: v["value"] for k, v in res["metrics"].items()},
                  memory_peak_bytes=res["device"]["memory_peak_bytes"],
                  **{k: v for k, v, _ in checks}))
        torch.cuda.empty_cache()
    for s in filter(None, args.control_seeds.split(",")):
        ctx = bench.Context(cell, int(s), 0, False, dev, time.time(), peak)
        for kind in ("control", "control_mask_bf16"):
            t = time.time()
            control_masks(ctx, kind, lambda r: emit(dict(seed=int(s), **r)))
            emit(dict(kind=f"{kind}_s", seed=int(s), s=time.time() - t))
            torch.cuda.empty_cache()
    if out:
        out.close()


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    main()
