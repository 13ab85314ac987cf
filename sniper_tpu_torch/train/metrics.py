"""Running training metrics (the reference's metric set).

A copy of sniper_tpu/train/metrics.py: host-side running means of the
per-step scalars, and the Speedometer-style progress line. ``*_max``
metrics (the offset telemetry) keep the running maximum, since a mean
would hide a transient spike into the margin halo.
"""

from __future__ import annotations

import time


class MetricTracker:
    def __init__(self):
        self.reset()

    def reset(self):
        self.sums: dict[str, float] = {}
        self.count = 0
        self._t0 = time.time()
        self._samples = 0

    def update(self, metrics: dict, n_samples: int = 0):
        for k, v in metrics.items():
            if k.endswith("_max"):
                self.sums[k] = max(self.sums.get(k, float("-inf")), float(v))
            else:
                self.sums[k] = self.sums.get(k, 0.0) + float(v)
        self.count += 1
        self._samples += n_samples

    def means(self) -> dict[str, float]:
        return {
            k: (v if k.endswith("_max") else v / max(self.count, 1))
            for k, v in self.sums.items()
        }

    def speed(self) -> float:
        dt = time.time() - self._t0
        return self._samples / dt if dt > 0 else 0.0

    def format(self, epoch: int, step: int) -> str:
        parts = [f"Epoch[{epoch}] Batch [{step}]"]
        parts.append(f"Speed: {self.speed():.2f} samples/sec")
        for k, v in sorted(self.means().items()):
            parts.append(f"{k}={v:.5f}")
        return "  ".join(parts)
