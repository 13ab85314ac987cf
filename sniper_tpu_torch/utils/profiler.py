"""Profiling helpers: device traces, layer spans and host stage timers.

Port of sniper_tpu/utils/profiler.py. ``device_trace`` wraps a block in
``torch.profiler`` (the host's operators, and with a CUDA card its kernels
and copies) and writes a Chrome trace into a directory (open it in
Perfetto or chrome://tracing); ``span`` marks a layer of the program
(``sniper/trunk``, ``sniper/rpn``, ...) in such a trace, and costs one
flag check when no profiler records; ``StageTimer`` accumulates named
host-side stage durations, synchronizing the devices of a stage's tensors
before it reads the clock, since CUDA launches return before the card is
done.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """The program's layer ``name`` as the host annotation
    ``sniper/<name>`` while a torch.profiler records (a ``record_function``
    on the profiler's clock, in the same trace as the kernels: the kernels
    the host launches inside it, and the device's idle gaps while the host
    is inside it, fall under its name); otherwise one shared null context,
    behind a single flag check. The program opens spans flat, never one
    inside another: a layer met twice in a forward opens its span twice."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(f"sniper/{name}")
    return _OFF


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with torch.profiler, CUDA activity included when a
    card is present, and export it as a Chrome trace
    ``<log_dir>/trace_<time>_<pid>.json``, also when the block raises.
    Yields the profiler (its
    ``key_averages()`` sum the block by operator and kernel)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:  # a block that raises still leaves its trace, as jax's does
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        stamp = time.strftime("%Y%m%d-%H%M%S")
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{stamp}_{os.getpid()}.json"))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def sync(tree):
    """Wait for the work that produces the tensors of ``tree`` (nested
    dicts, lists and tuples): synchronize each CUDA device they lie on.
    Returns ``tree``."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


class StageTimer:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync_tree=None):
        """Time the block under ``name``; with ``sync_tree``, after its
        devices finish the work (``sync``)."""
        t0 = time.perf_counter()
        yield
        if sync_tree is not None:
            sync(sync_tree)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        """One line per stage, sorted by name: total s, mean ms, count."""
        lines = []
        for k in sorted(self.totals):
            n = self.counts[k]
            lines.append(
                f"{k}: total {self.totals[k]:.3f}s, "
                f"mean {self.totals[k] / max(n, 1) * 1e3:.1f}ms over {n}"
            )
        return "\n".join(lines)
