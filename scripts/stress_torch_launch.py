"""Run tests/test_torch_dp_distributed.py::test_a_failing_rank_fails_the_launch
many times on an oversubscribed CPU, and count how often the launch raised
the failing rank's own error.

The failure this hunts needs one spawned rank slower than the other, which
a crowded box gives: ``--load`` CPU-bound torch processes at
``--load-threads`` threads each run beside ``--loops`` concurrent loops of
``--runs`` launches. ``--tree`` is the checkout whose tests and
sniper_tpu_torch are used (a copy of the parent commit, to compare).

    python scripts/stress_torch_launch.py --runs 30
    python scripts/stress_torch_launch.py --tree /path/to/parent --loops 3 --runs 20

Prints one line per launch (PASS, or FAIL with the error's last lines) and
a total per loop. Exits 1 when a launch failed.
"""

import argparse
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent

LOAD = """
import torch
torch.set_num_threads({threads})
a = torch.randn(1500, 1500)
while True:
    a = torch.tanh(a @ a)
"""


def loop(tree: str, runs: int, tag: str) -> int:
    """``runs`` launches of the test in this process; returns the passes."""
    sys.path[:0] = [os.path.join(tree, "tests"), tree]
    os.chdir(tree)
    import pytest
    import test_torch_dp_distributed as t

    passed = 0
    for i in range(runs):
        t0 = time.perf_counter()
        try:
            with tempfile.TemporaryDirectory() as d:
                t.test_a_failing_rank_fails_the_launch(pathlib.Path(d))
        except (Exception, pytest.fail.Exception) as e:
            lines = [m for m in str(e).splitlines() if "Error" in m]
            print(f"{tag} {i} FAIL {time.perf_counter() - t0:.1f} s: "
                  f"{' | '.join(lines)[-300:]}", flush=True)
        else:
            passed += 1
            print(f"{tag} {i} PASS {time.perf_counter() - t0:.1f} s",
                  flush=True)
    print(f"{tag}: {passed} of {runs} passed ({tree})", flush=True)
    return passed


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=str(ROOT))
    p.add_argument("--runs", type=int, default=30)
    p.add_argument("--loops", type=int, default=1)
    p.add_argument("--load", type=int, default=6)
    p.add_argument("--load-threads", type=int, default=8)
    p.add_argument("--loop", help=argparse.SUPPRESS)  # a child's tag
    args = p.parse_args()
    if args.loop is not None:
        sys.exit(0 if loop(args.tree, args.runs, args.loop) == args.runs
                 else 1)
    load = [subprocess.Popen([sys.executable, "-c", LOAD.format(
        threads=args.load_threads)]) for _ in range(args.load)]
    try:
        time.sleep(5)
        loops = [subprocess.Popen(
            [sys.executable, __file__, "--tree", args.tree, "--runs",
             str(args.runs), "--loop", f"loop{k}"])
            for k in range(args.loops)]
        rcs = [q.wait() for q in loops]
    finally:
        for q in load:
            q.kill()
            q.wait()
    sys.exit(max(rcs))


if __name__ == "__main__":
    main()
