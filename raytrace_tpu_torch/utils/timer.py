"""Named-scope timer registry (rebuild of the reference's ProfilerApp hooks).

The reference instruments ``create_image`` / ``propagate_{ASE,seed}-<method>``
with PROFILE_START/STOP macros (no-ops in the miniapp, src/ProfilerApp.h:1-13;
regions at src/RayTraceImage.cpp:233,294-298,424,433). This registry keeps
the same region names, records wall time per scope, and can emit a summary
table. ``profiler.scope(name, annotate=True)`` also opens the region as a
``torch.profiler.record_function`` (and, on a CUDA device, an NVTX range),
so that it shows up in ``torch.profiler`` traces.

``profiler.span(name)`` is the program's own region at a host boundary of a
call (``prepare``, ``pack``, ``dispatch``, ``stage``, ``capture``,
``wait``, ``finalize``): it never synchronises a device, closes when its
body raises, and opens a ``torch.profiler`` annotation only while a
profiler records, so that with none recording it costs that check, two
clock reads and the totals' update.
``profiler.add(name, value)`` records a value measured elsewhere as one
region: a duration (a device interval read from CUDA events,
``mesh.reduce``) or a count (``pack.direct``: 1 for a call's tables packed
straight into a CUDA graph's staging buffer, 0 for a fresh buffer, so that
its total over its count is the share of direct packs; ``pack.bytes``: the
bytes of a call's tables that a pack wrote).

Work on a CUDA device runs asynchronously, so a region stopped with a CUDA
``device`` first synchronises that device: the recorded time then covers the
device work the region enqueued, not only the enqueue.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import ExitStack, contextmanager

import torch

__all__ = ["Profiler", "profiler", "get_time"]

_START = time.perf_counter()


def get_time() -> float:
    """Monotonic seconds since the module was imported (getTime,
    src/CreateImageHelpers.cpp:46-62)."""
    return time.perf_counter() - _START


def _annotation(name: str, device) -> ExitStack:
    """``name`` as a ``torch.profiler`` region, and as an NVTX range when
    ``device`` is a CUDA device."""
    stack = ExitStack()
    stack.enter_context(torch.profiler.record_function(name))
    if device is not None and torch.device(device).type == "cuda":
        stack.enter_context(torch.cuda.nvtx.range(name))
    return stack


class _Span:
    """A :meth:`Profiler.span` region of one name (made once a name and
    reused: spans of one name do not nest). Its start is kept in the
    profiler's ``_open`` while it is open, its annotation, when a profiler
    records, around the region."""

    __slots__ = ("prof", "name", "annotation")

    def __init__(self, prof: "Profiler", name: str):
        self.prof, self.name, self.annotation = prof, name, None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        if self.prof.enabled:
            self.prof._open[self.name] = time.perf_counter()
        return self

    def __exit__(self, *exc):
        prof, name = self.prof, self.name
        t0 = prof._open.pop(name, None)
        if t0 is not None:
            prof.totals[name] += time.perf_counter() - t0
            prof.counts[name] += 1
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
            self.annotation = None
        return False


class Profiler:
    """Accumulating named-scope wall-clock profiler."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._open: dict[str, float] = {}
        self._spans: dict[str, _Span] = {}
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

    @contextmanager
    def scope(self, name: str, annotate: bool = False, device=None):
        """Context-manager scope, stopped with ``device`` (see
        :meth:`stop`); with ``annotate``, also a ``torch.profiler`` region
        (and an NVTX range on a CUDA ``device``). A body that raises leaves
        the region open and unrecorded, as the JAX package's scope does."""
        self.start(name)
        if annotate:
            with _annotation(name, device):
                yield
        else:
            yield
        self.stop(name, device)

    def span(self, name: str) -> _Span:
        """A host span of the program: recorded like :meth:`scope`, also
        when its body raises; it never synchronises a device, and it is a
        ``torch.profiler`` annotation only while a profiler records. Spans
        of one name do not nest."""
        span = self._spans.get(name)
        if span is None:
            span = self._spans[name] = _Span(self, name)
        return span

    def add(self, name: str, value: float) -> None:
        """Record ``value`` measured elsewhere (seconds of device events,
        or a count) as one region of ``name``."""
        if self.enabled:
            self.totals[name] += value
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
