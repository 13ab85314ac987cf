#!/usr/bin/env python3
"""Planted faults against the data-parallel step gate of chip_smoke.py (d1).

Runs (d1)'s 2-rank step (two gloo ranks sharing the card, 8 + 8 of 16
chips of 512x512, configs/sniper_res101_e2e.yml at full width and depth,
fp32 trunk, sync BatchNorm, rank 1's chips sampling fewer anchors) once
sound and once with each of chip_smoke.DP_FAULTS planted into both ranks:
"local" BatchNorm in place of "sync", each rank's own valid count, the
world-size scale of the loss dropped, and both of the last two (the mean of
the ranks' own mean losses). Each run is held against the one-process step
on the 16 joined chips by dp_compare, under two noise models for the
tolerances: pool noise alone (train_step_check's) and pool and BatchNorm
noise ((d1)'s). Prints every reading beside its tolerance and whether each
gate passes each run; the last line is a JSON object of which gates pass,
and every reading goes to --out as JSON. Needs one CUDA device.

    python3 scripts/dp_step_controls.py [--faults local count ...]
        [--out build/dp_step_controls.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import chip_smoke as cs

    from sniper_tpu_torch.config import load_config
    from sniper_tpu_torch.ops import cuda

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--faults", nargs="*", default=list(cs.DP_FAULTS),
                   choices=cs.DP_FAULTS)
    p.add_argument("--out", default=os.path.join(ROOT, "build",
                                                 "dp_step_controls.json"))
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dp_step_controls: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card)
    cuda.build()
    cuda.library()
    cfg = cs.train_cfg(load_config(os.path.join(ROOT, cs.CONFIG)))
    refs = {"pool noise": cs.dp_reference(dev, cfg, noise_bn=False),
            "pool and BatchNorm noise": cs.dp_reference(dev, cfg,
                                                        noise_bn=True)}
    result = {"card": card, "runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for fault in [None] + args.faults:
            name = fault or "sound"
            ranks, secs = cs.dp_ranks(dev, cfg, tmp, fault)
            run = {"seconds": secs, "losses": ranks[0]["metrics"]}
            for gate, ref in refs.items():
                ok, rows = cs.dp_compare(ranks[0], ref)
                worst = max(rows, key=lambda k: rows[k][0] / rows[k][2])
                run[gate] = {"pass": ok, "worst": worst, "rows": rows}
                print(f"{name}, gate with {gate}: "
                      f"{'PASS' if ok else 'FAIL'}; reading / tolerance "
                      f"largest for {worst} "
                      f"({rows[worst][0]:.3e} / {rows[worst][2]:.3e}); "
                      + "; ".join(f"{k} {e:.3e} (spread {s:.3e}, "
                                  f"tolerance {t:.3e})"
                                  for k, (e, s, t) in rows.items()))
            result["runs"][name] = run
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({name: {gate: r[gate]["pass"] for gate in refs}
                      for name, r in result["runs"].items()}))


if __name__ == "__main__":
    main()
