"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a few
steady calls of the window, reduced to what the per-layer metrics read.

The stretch opens after the window's ``skip``-th completed call and closes
after ``calls`` more, inside a ``bench.stretch`` annotation. The profiler's
Chrome trace (a few MB at these lengths, written to ``TMPDIR`` and deleted
once read) gives every device interval (kernels, copies, memsets, with
those replayed from CUDA graphs) and the benchmark's own host spans
(``bench.*`` annotations). :func:`reduce_trace` turns them into:

* ``kernel_s``: each kernel's seconds in the stretch, summed over the
  cards, by name; ``copy_s`` the same of the copies and memsets;
* ``busy_s``: per card, the union of its device intervals inside the
  stretch; ``window_s`` the stretch's length;
* ``gaps``: every idle interval of every card inside the stretch, labelled
  by the innermost ``bench.*`` host span around its midpoint.
"""

from __future__ import annotations

import json
import os
import tempfile

__all__ = ["Capture", "reduce_trace", "union_and_gaps", "short_name",
           "kernel_base"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Capture:
    """Opens the profiler over calls ``skip .. skip+calls-1`` of a window;
    :meth:`tick` is called after each completed call with its ordinal."""

    def __init__(self, skip: int, calls: int, tmpdir: str):
        self.skip, self.calls, self.tmpdir = skip, calls, tmpdir
        self.prof = self.annotation = None
        self.traced_calls = 0
        self.opened_at = None
        self.data = None

    def _open(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.annotation = torch.profiler.record_function("bench.stretch")
        self.annotation.__enter__()

    def warm_up(self, fn) -> None:
        """Profile ``fn()`` once and drop it: the profiler's first start
        (CUPTI's set-up) then falls in set-up, not in the window."""
        self._open()
        fn()
        self.annotation.__exit__(None, None, None)
        self.prof.stop()
        self.prof = self.annotation = None

    def tick(self, done: int) -> None:
        """``done`` calls of the window have completed."""
        if done == self.skip and self.prof is None and self.data is None:
            self.opened_at = done
            self._open()
        elif self.prof is not None and done >= self.skip + self.calls:
            self.close(done)

    def close(self, done: int) -> None:
        """Close the stretch (at the window's end if it is still open)."""
        if self.prof is None:
            return
        self.annotation.__exit__(None, None, None)
        self.prof.stop()
        self.traced_calls = done - self.opened_at
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_",
                                    dir=self.tmpdir)
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.data = json.load(f)
        finally:
            os.unlink(path)
        self.prof = self.annotation = None


def union_and_gaps(intervals, lo: float, hi: float):
    """``(busy, gaps)`` of ``(start, end)`` intervals clipped to
    ``[lo, hi]``: the length of their union and the idle intervals
    between."""
    busy, gaps, cur = 0.0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if cur < hi:
        gaps.append((cur, hi))
    return busy, gaps


def short_name(name: str) -> str:
    """A device operation's name without its argument list and the
    anonymous namespace, at most 96 characters."""
    name = name.replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            cut = i
            break
    return name[:cut][:96]


def reduce_trace(data: dict, devices) -> dict | None:
    """The stretch of a Chrome trace: ``kernel_s``, ``copy_s``, ``busy_s``
    (one entry per card index in ``devices``), ``window_s`` and ``gaps``
    (``(label, seconds)``); None when the trace holds no
    ``bench.stretch``."""
    events = data.get("traceEvents", [])
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("bench.")]
    stretch = [e for e in spans if e["name"] == "bench.stretch"]
    if not stretch:
        return None
    lo = float(stretch[0]["ts"])
    hi = lo + float(stretch[0]["dur"])
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
              e["name"][len("bench."):]) for e in spans
             if e["name"] != "bench.stretch"]
    per_dev = {d: [] for d in devices}
    kernel_s: dict = {}
    copy_s: dict = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = float(e["ts"])
        t = s + float(e.get("dur", 0.0))
        if t <= lo or s >= hi:
            continue
        dev = (e.get("args") or {}).get("device")
        per_dev.setdefault(dev, []).append((s, t))
        name = short_name(str(e.get("name", "")))
        into = kernel_s if e["cat"] == "kernel" else copy_s
        into[name] = into.get(name, 0.0) + (min(t, hi) - max(s, lo)) * 1e-6
    busy, gaps = [], []
    for d in devices:
        b, g = union_and_gaps(per_dev.get(d, []), lo, hi)
        busy.append(b * 1e-6)
        for s, t in g:
            mid = 0.5 * (s + t)
            inner = [sp for sp in spans if sp[0] <= mid <= sp[1]]
            label = (min(inner, key=lambda sp: sp[1] - sp[0])[2] if inner
                     else "outside")
            gaps.append((label, (t - s) * 1e-6))
    return dict(kernel_s=kernel_s, copy_s=copy_s, busy_s=busy,
                window_s=(hi - lo) * 1e-6, gaps=gaps)


def kernel_base(name: str) -> str:
    """A kernel's own name: the last ``::`` part of :func:`short_name`'s,
    without template arguments or a return type."""
    words = name.split("<", 1)[0].rsplit("::", 1)[-1].split()
    return words[-1] if words else name
