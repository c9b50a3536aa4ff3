"""Named-scope timer registry (rebuild of the reference's ProfilerApp hooks).

The reference instruments ``create_image`` / ``propagate_{ASE,seed}-<method>``
with PROFILE_START/STOP macros (no-ops in the miniapp, src/ProfilerApp.h:1-13;
regions at src/RayTraceImage.cpp:233,294-298,424,433). This registry keeps
the same region names, records wall time per scope, and can emit a summary
table.

Work on a CUDA device runs asynchronously, so a region stopped with a CUDA
``device`` first synchronises that device: the recorded time then covers the
device work the region enqueued, not only the enqueue.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

__all__ = ["Profiler", "profiler"]


class Profiler:
    """Accumulating named-scope wall-clock profiler."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._open: dict[str, float] = {}
        self.enabled = True

    def start(self, name: str) -> None:
        if self.enabled:
            self._open[name] = time.perf_counter()

    def stop(self, name: str, device=None) -> None:
        """Close ``name``; with a CUDA ``device``, synchronise it first."""
        if self.enabled and name in self._open:
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            self.totals[name] += time.perf_counter() - self._open.pop(name)
            self.counts[name] += 1

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self._open.clear()

    def summary(self) -> str:
        lines = [f"{'region':<32s} {'calls':>6s} {'total(s)':>10s} {'avg(ms)':>10s}"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot = self.totals[name]
            cnt = self.counts[name]
            lines.append(f"{name:<32s} {cnt:>6d} {tot:>10.4f} {1e3 * tot / cnt:>10.3f}")
        return "\n".join(lines)


#: process-wide default profiler (the analogue of the global ProfilerApp)
profiler = Profiler()
