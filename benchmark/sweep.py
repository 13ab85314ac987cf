"""The highest rate a pyramid cell sustains: its traffic in an open loop
at each of ``--rates`` rounds a second, one run each, on the card.

    python3 benchmark/sweep.py --workload r101_pyramid --rates 6,7,8,9 \\
        [--seconds 15] [--seed 1]

For each rate one JSON line: rounds offered and done, images a second,
the rounds' latency median and p95 (from when each was due), and how late
the host dispatched them (p95 and max). Above the rate the card sustains
the lateness grows through the window. The serving cell's fixed rate is
about four fifths of the highest sustained one. The benchmark's runs do
not run this."""

import argparse
import contextlib
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import run as bench  # noqa: E402
from benchmark.core import harness  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep: no CUDA device")
    dev = torch.device("cuda", 0)
    base = harness.load_cell(args.workload)
    peak = bench.peak_bf16(torch.cuda.get_device_name(dev))
    driver = harness.load_module(harness.BENCH / "drivers" / "pyramid.py")
    for rate in (float(r) for r in args.rates.split(",")):
        cell = copy.deepcopy(base)
        cell["traffic"]["rounds_per_s"] = rate
        ctx = bench.Context(cell, args.seed, args.seconds, False, dev,
                            time.time(), peak)
        with contextlib.redirect_stdout(sys.stderr):
            out = driver.run(ctx)
        rec = out["record"]
        lat = np.array(rec["spans"]["round"]) * 1e3
        late = np.array(rec["spans"]["late"]) * 1e3
        print(json.dumps(dict(
            rate=rate, offered=int(rate * args.seconds), done=len(lat),
            img_per_s=rec["images"] / rec["window_s"],
            p50_ms=float(np.median(lat)), p95_ms=float(np.percentile(lat, 95)),
            late_p95_ms=float(np.percentile(late, 95)),
            late_max_ms=float(late.max()),
            correct=all(v <= lim for _, v, lim in out["checks"]))),
            flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
