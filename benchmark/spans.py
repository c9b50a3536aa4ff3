"""The program's own host spans in the traced stretch: how long the card
sat idle while the host was inside a span of one name.

The program opens each host boundary of a call (``prepare``, ``dispatch``,
``wait``, ``finalize``, ...) as a ``torch.profiler`` annotation of that
name while a profiler records (``raytrace_tpu_torch.utils.timer``), so the
spans land in the stretch's Chrome trace on the clock of the card's
kernels and copies. :func:`idle_under` puts the card's idle time down to
them by length: every idle interval of a card (``devtrace.union_and_gaps``
of its device intervals) is measured against the union of the spans of
the name, both clipped to the ``bench.stretch`` annotation.
"""

from __future__ import annotations

from benchmark import devtrace

__all__ = ["idle_under", "idle_share_reader", "span_ms_reader"]


def _merged(intervals):
    """The union of ``(start, end)`` intervals as disjoint sorted ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b) -> float:
    """The length of the intersection of two sets of disjoint sorted
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_under(data: dict, devices, name: str) -> float | None:
    """The mean over the cards ``devices`` (their indices) of the seconds
    inside ``bench.stretch`` in which the card is idle and the host is
    inside a ``user_annotation`` named ``name``, over the stretch's length,
    in %. None where the trace has no stretch, no device interval inside
    it (the CPU) or no span of ``name`` there; 0.0 where the spans ran and
    the card never idled under them."""
    events = (data or {}).get("traceEvents", [])
    notes = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    stretch = [e for e in notes if e.get("name") == "bench.stretch"]
    if not stretch or not devices:
        return None
    lo = float(stretch[0]["ts"])
    hi = lo + float(stretch[0]["dur"])
    spans = _merged((max(s, lo), min(e, hi)) for s, e in (
        (float(n["ts"]), float(n["ts"]) + float(n["dur"]))
        for n in notes if n.get("name") == name) if min(e, hi) > max(s, lo))
    if not spans:
        return None
    per_dev = {d: [] for d in devices}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in devtrace.DEVICE_CATS:
            continue
        dev = (e.get("args") or {}).get("device")
        if dev in per_dev:
            s = float(e["ts"])
            per_dev[dev].append((s, s + float(e.get("dur", 0.0))))
    if not any(min(t, hi) > max(s, lo)
               for iv in per_dev.values() for s, t in iv):
        return None
    idle = [_overlap(devtrace.union_and_gaps(per_dev[d], lo, hi)[1], spans)
            for d in devices]
    return 100.0 * sum(idle) / len(idle) / (hi - lo)


def idle_share_reader(name: str):
    """The ``read(view)`` of ``<name>.idle_share``: :func:`idle_under` of
    the run's traced stretch (``view["run"].capture.data``) on the run's
    cards; None off the card or in an untraced run."""
    def read(view: dict):
        run = view["run"]
        capture = getattr(run, "capture", None)
        if capture is None or capture.data is None or not run.on_card:
            return None
        return idle_under(capture.data, [d.index for d in run.devices], name)
    return read


def span_ms_reader(name: str):
    """The ``read(view)`` of a ``<layer>.host_ms`` or ``_ms`` metric: the
    program's ``name`` region (``view["timer"]``, over the window), its
    total over its count in ms; None where it never ran in the window."""
    def read(view: dict):
        n = view["timer"]["counts"].get(name, 0)
        return 1e3 * view["timer"]["totals"][name] / n if n > 0 else None
    return read
