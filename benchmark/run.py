"""Run one cell of the benchmark once, on the CUDA card(s) of this machine.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell is an entry of BENCHMARK.json's
``workloads``; its configuration, traffic, limits and per-layer readers are
files under benchmark/ found by name (benchmark/core/harness.py). The run
builds the cell's detector through the port's registry with weights made
from ``--seed`` on the card, makes the traffic from the seed, warms up the
cell's shapes (set-up, ``setup_s``: from this process's start to the first
timed unit), measures for ``--seconds``, and checks what the timed path
produced against the plain fp32 reference (benchmark/reference/).

Standard output's last line is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics, read in a profiled slice after the
window), ``device``, with ``--trace 1`` ``breakdown``, then ``checks``:
each compared number beside its limit, which are also standard error's
last lines. With no CUDA card, fewer cards than the cell asks for, or
JAX or the JAX package loaded, it exits non-zero and prints no result.

The port builds its kernels into build/sniper_tpu_torch/ of the checkout
(sniper_tpu_torch/ops/cuda.py); Triton's and CUDA's caches are pinned to
build/ as well, so that only a checkout's first run compiles.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"
os.environ.setdefault("OMP_NUM_THREADS", "4")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.core import harness  # noqa: E402
from benchmark.yardstick.kernels import peak_bf16  # noqa: E402


class Context:
    """What a driver gets: the cell, the run's arguments, the device, the
    clock from the process's start, and the window's bookkeeping."""

    def __init__(self, cell, seed, seconds, trace, device, t_start, peak):
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.t_start = t_start
        self.peak = peak
        self.setup_peak = 0

    @staticmethod
    def clock():
        return time.time()

    @staticmethod
    def note(line):
        print(line, file=sys.stderr, flush=True)

    def window_starts(self):
        if self.device.type == "cuda":
            self.setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def window_ends(self, rec):
        rec["peak_flops"] = self.peak
        if self.device.type == "cuda":
            rec["window_peak_bytes"] = torch.cuda.max_memory_allocated(
                self.device)
            rec["memory_peak_bytes"] = max(self.setup_peak,
                                           rec["window_peak_bytes"])
        found = harness.forbidden_modules()
        if found:
            raise SystemExit(f"benchmark: the process holds {found} after "
                             "the window; no result")

    def free(self):
        """Release the program's state before the reference runs."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @contextlib.contextmanager
    def fp32(self):
        """True fp32 for the reference: TF32 off in matmuls and convs."""
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out[0].strip() if out else None


def execute(cell, seed, seconds, trace, device, *, t_start=None, peak=None):
    """One run of ``cell``; returns (the result object, the checks)."""
    from benchmark.core.program import kernels_built

    ctx = Context(cell, seed, seconds, trace, device,
                  T_START if t_start is None else t_start, peak)
    built = device.type == "cuda" and not kernels_built()
    driver = harness.load_module(
        harness.BENCH / "drivers" / f"{cell['traffic']['driver']}.py")
    out = driver.run(ctx)
    rec = out["record"]
    if trace:
        metrics = {}
        for m in cell["per_layer"]:
            reader = harness.load_module(harness.metric_file(m["name"]))
            v = reader.read(rec)
            if harness.finite(v):
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(harness.e2e_value(out["e2e"],
                                                                m["name"])),
                               "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    checks = out["checks"]
    correct = all(harness.finite(v) and v <= lim for _, v, lim in checks)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell["entry"]["chips"]),
           "memory_peak_bytes": int(rec.get("memory_peak_bytes", 0))}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    if trace:
        tr = rec.get("trace", {})
        dev["busy_s"] = float(tr.get("busy_s", 0.0))
        dev["window_s"] = float(tr.get("window_s", 0.0))
        result["breakdown"] = harness.breakdown(tr)
    result["kernels_built_in_this_run"] = built
    if getattr(ctx, "look", None):
        result["look"] = ctx.look
    result["checks"] = {k: {"value": float(v), "limit": float(lim)}
                        for k, v, lim in checks}
    return result, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device (torch.cuda.is_available() is "
              "False); the benchmark measures the card and has no CPU mode",
              file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    chips = int(cell["entry"]["chips"])
    if torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(device)
    print(f"benchmark: {args.workload} seed {args.seed} on {name}, power "
          f"limit {power_limit()}", file=sys.stderr, flush=True)
    # the program's progress lines go to stderr: the result is stdout's last
    with contextlib.redirect_stdout(sys.stderr):
        result, checks = execute(cell, args.seed, args.seconds,
                                 bool(args.trace), device,
                                 peak=peak_bf16(name))
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the process holds {found}; no result",
              file=sys.stderr)
        return 3
    for k, v, lim in checks:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
