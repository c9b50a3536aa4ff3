"""One run of one cell: set-up, warm-up, the measured window, the traced
stretch, the check against the plain reference, and the result line.

Everything a cell is made of is found by name (``benchmark/README.md``):
the cell ``workloads/<cell>.json``, its configuration ``configs/<config>
.json``, its traffic mix ``traffic/<mix>.json``, the driver of the mix's
entry kind ``entries/<kind>.py``, and each metric's reader
``metrics/<metric>.py``. The check's reference is
``reference/plain.py``.
``BENCHMARK.json`` says which metrics a cell reports.

An entry module drives the program's public entry for the window: it has
``warm_up(run, calls)`` and ``window(run, deadline)``, and reports each
completed call through :meth:`Run.done`. :func:`closed_loop` is the loop
of the synchronous entries.

A metric's ``read(view)`` gets a dict: ``run`` (the :class:`Run`: its
``base`` unit, ``rays`` per call, ``attempted``, ``failed``,
``latencies``), ``setup_s``, ``window_s``, ``peak_reserved_bytes``,
``timer`` (the program's ``utils.timer.profiler`` totals and counts over
the window), ``counts`` (the reference's per-call ``steps``, ``cells``,
``rays`` and ``failed``), and in a traced run ``trace``
(:func:`devtrace.reduce_trace` of the stretch) and ``traced_calls``.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np

from benchmark import devtrace, units
from benchmark.reference import plain

__all__ = ["ROOT", "manifest", "load_cell", "Run", "run_cell",
           "closed_loop", "forbidden_modules", "rel_l2", "Reservoir"]

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "raytrace_tpu")
GIB = float(1 << 30)


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """A cell with its configuration, traffic mix and metrics, as
    ``BENCHMARK.json`` and the files it names give them."""
    m = manifest()
    entry = {w["name"]: w for w in m["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = _json(BENCH / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if cell[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json gives {key} "
                             f"{cell[key]!r}, BENCHMARK.json {entry[key]!r}")
    configs = {c["name"]: c for c in m["configs"]}
    cell["name"] = name
    cell["config_spec"] = _json(ROOT / configs[entry["config"]]["file"])
    cell["traffic_spec"] = _json(BENCH / "traffic"
                                 / f"{entry['traffic']}.json")

    def mine(metric):
        return "workloads" not in metric or name in metric["workloads"]

    cell["end_to_end"] = [x for x in m["end_to_end"] if mine(x)]
    cell["per_layer"] = [x for x in m["per_layer"] if mine(x)]
    return cell


def load_reader(metric: str):
    """The module ``benchmark/metrics/<metric>.py``, with its ``read``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def rel_l2(got, want) -> float:
    """``|got - want| / |want|`` in f64 (inf where the shapes differ)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return math.inf
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-300))


class Reservoir:
    """A uniform sample of ``k`` of the window's calls, drawn from the seed
    as they complete (Algorithm R), so no call's output is kept that the
    check will not read."""

    def __init__(self, k: int, seed: int):
        self.k, self.items, self.seen = k, [], 0
        self.rng = np.random.default_rng(
            [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, 0x5A4D])

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.items[j] = item


def _tmpdir() -> str:
    """``TMPDIR`` where it is set, else ``build/benchmark`` in the
    checkout."""
    path = os.environ.get("TMPDIR") or str(ROOT / "build" / "benchmark")
    os.makedirs(path, exist_ok=True)
    return path


def process_start() -> float:
    """``time.perf_counter()`` reading of this process's start (from
    ``/proc/self/stat``; the import of this module where that is not
    readable)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        ago = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return time.perf_counter() - ago
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.perf_counter()


class Run:
    """The state of one run of a cell: its inputs, the program's devices,
    the window's records, the sample the check reads, the traced stretch."""

    def __init__(self, cell: dict, seed: int, trace: bool, device: str):
        import torch

        self.seed, self.trace = seed, trace
        self.config = cell["config_spec"]
        self.traffic = cell["traffic_spec"]
        self.chips = int(cell["chips"])
        self.base = units.base_unit(self.config, self.traffic["scale"])
        self.rays = units.ray_count(self.base)
        self.spread = float(self.traffic["gain_spread"])
        self.dtype = {"float64": torch.float64, "float32": torch.float32}[
            self.config["spectrum_dtype"]]
        self.on_card = device == "cuda"
        self.method = "cuda" if self.on_card else "cpu"
        if self.on_card:
            self.devices = [torch.device("cuda", i) for i in range(self.chips)]
        else:
            self.devices = [torch.device("cpu")] * self.chips
        self.failed_ray_path = os.path.join(_tmpdir(), "bench_failed_rays.dat")
        self.next_index = 0
        self.sample = Reservoir(int(cell["check_calls"]), seed)
        self.latencies: list[float] = []
        self.attempted = self.failed = 0
        self.t_start = self.t_end = None
        self.capture = (devtrace.Capture(int(self.traffic["trace_skip"]),
                                         int(self.traffic["trace_calls"]),
                                         _tmpdir()) if trace else None)

    # --- inputs -------------------------------------------------------------
    def next_unit(self):
        """The next call's ``(index, g0 factors, program problem)``: the
        base unit with fresh gain tables (the client's table step)."""
        idx = self.next_index
        self.next_index += 1
        f = units.gain_factors(self.seed, idx, len(self.base.gain),
                               self.spread)
        return idx, f, units.to_program(units.call_unit(self.base, f))

    def span(self, name: str):
        """A ``bench.<name>`` host span in a traced run."""
        if not self.trace:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function("bench." + name)

    # --- the window ---------------------------------------------------------
    def done(self, idx, factors, t0: float, t1: float, out) -> None:
        """A call of the window completed at ``t1`` (``out``: its
        ``(image, I_ang)``, or None where it raised)."""
        self.attempted += 1
        self.t_end = t1
        if out is None:
            self.failed += 1
        else:
            self.latencies.append(t1 - t0)
            self.sample.offer((idx, factors, out[0], out[1]))
        if self.capture is not None:
            self.capture.tick(self.attempted)


def closed_loop(run: Run, call, deadline: float | None,
                calls: int | None = None) -> None:
    """Synchronous calls back to back, each on fresh tables: until one ends
    after ``deadline`` (the window), or ``calls`` of them (a warm-up, with
    ``deadline`` None, recording nothing)."""
    from raytrace_tpu_torch.utils.errors import RayTraceError

    n = 0
    while True:
        with run.span("table_step"):
            idx, f, p = run.next_unit()
        t0 = time.perf_counter()
        try:
            with run.span("call"):
                out = call(p)
        except RayTraceError:
            out = None
        t1 = time.perf_counter()
        n += 1
        if deadline is None:
            if out is None:
                raise RuntimeError("a warm-up call failed")
            if n >= calls:
                return
            continue
        run.done(idx, f, t0, t1, out)
        if t1 >= deadline:
            return


def _reference_check(run: Run) -> tuple[dict, dict]:
    """The sampled calls worked out again by the reference: the worst
    relative L2 of image and I_ang over them, the reference's failed rays,
    and its per-call trace counts."""
    worst = dict(image_rel_l2=0.0, i_ang_rel_l2=0.0, ref_failed_rays=0)
    counts = {}
    dev = run.devices[0]
    for idx, factors, image, i_ang in sorted(run.sample.items,
                                             key=lambda t: t[0]):
        unit = units.call_unit(run.base, factors)
        r_img, r_ang, counts = plain.create_image(unit, device=dev)
        worst["image_rel_l2"] = max(worst["image_rel_l2"],
                                    rel_l2(image, r_img))
        worst["i_ang_rel_l2"] = max(worst["i_ang_rel_l2"],
                                    rel_l2(i_ang, r_ang))
        worst["ref_failed_rays"] += counts["failed"]
    return worst, counts


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", started: float | None = None) -> dict:
    """Run ``cell`` once and return the result line's object (the
    ``checks`` last). ``device`` ``cpu`` runs the plain twins on the CPU
    (the tests); ``started`` is the process's start on the
    ``time.perf_counter`` clock."""
    import torch

    from raytrace_tpu_torch.models import ray_tracer
    from raytrace_tpu_torch.utils.timer import profiler

    started = process_start() if started is None else started
    t_harness = time.perf_counter()
    run = Run(cell, seed, trace, device)
    entry = importlib.import_module(
        f"benchmark.entries.{run.traffic['entry']}")
    readers = {m["name"]: load_reader(m["name"])
               for m in (cell["per_layer"] if trace else cell["end_to_end"])}
    t_inputs = time.perf_counter()
    entry.warm_up(run, int(run.traffic["warmup_calls"]))
    if run.capture is not None:
        run.capture.warm_up(lambda: entry.warm_up(run, 1))
    if run.on_card:
        for d in run.devices:
            torch.cuda.synchronize(d)
    profiler.reset()
    run.t_start = time.perf_counter()
    setup_s = run.t_start - started
    _log(f"set-up: {t_harness - started:.4f} s to the harness "
        f"(imports), {t_inputs - t_harness:.4f} s the inputs, "
        f"{run.t_start - t_inputs:.4f} s the warm-up")
    entry.window(run, run.t_start + seconds)
    if run.capture is not None:
        run.capture.close(run.attempted)
    window_s = (run.t_end or time.perf_counter()) - run.t_start
    timer = dict(totals=dict(profiler.totals), counts=dict(profiler.counts))
    peak = (max(torch.cuda.max_memory_reserved(d) for d in run.devices)
            if run.on_card else 0)
    _log(f"window: {run.attempted} calls ({run.failed} failed) in "
        f"{window_s:.4f} s after {setup_s:.4f} s of set-up; peak reserved "
        f"{peak / GIB:.4f} GiB")
    if run.latencies:
        lat = np.asarray(run.latencies)
        half = len(lat) // 2
        q = np.percentile(lat, [5, 25, 50, 75, 95])
        _log("latency s: p5 %.5f p25 %.5f p50 %.5f p75 %.5f p95 %.5f; mean "
            "of the first half %.5f, the second %.5f" % (
                *q, lat[:half].mean() if half else lat.mean(),
                lat[half:].mean()))
    for k in sorted(timer["totals"]):
        _log(f"timer {k}: {timer['counts'][k]} calls, "
            f"{1e3 * timer['totals'][k] / max(timer['counts'][k], 1):.4f} "
            f"ms each")
    leaked = forbidden_modules()
    if leaked:
        raise SystemExit(f"modules that no run may load are loaded: {leaked}")

    ray_tracer.clear_pipeline_cache()
    if run.on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    worst, counts = _reference_check(run)
    _log(f"reference: {len(run.sample.items)} sampled calls in "
        f"{time.perf_counter() - t_ref:.2f} s")

    view = dict(run=run, setup_s=setup_s, window_s=window_s,
                peak_reserved_bytes=peak, timer=timer, counts=counts,
                trace=None)
    if run.capture is not None and run.capture.data is not None:
        idx = [d.index for d in run.devices] if run.on_card else []
        view["trace"] = devtrace.reduce_trace(run.capture.data, idx)
        view["traced_calls"] = run.capture.traced_calls
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        value = readers[m["name"]].read(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    limits = cell["limits"]
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in limits}
    checks["failed_calls"] = {"value": run.failed, "limit": 0}
    correct = (all(c["value"] <= c["limit"] for c in checks.values())
               and run.attempted > 0 and len(run.sample.items) > 0)
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics,
           "device": _device(run, peak, view)}
    if view["trace"] is not None:
        out["breakdown"] = _breakdown(view["trace"])
    out["checks"] = checks
    return out


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _device(run: Run, peak: int, view: dict) -> dict:
    import torch

    dev = {"platform": "gpu" if run.on_card else "cpu",
           "kind": (torch.cuda.get_device_name(run.devices[0])
                    if run.on_card else "cpu"),
           "count": run.chips, "memory_peak_bytes": int(peak)}
    tr = view["trace"]
    if tr is not None:
        dev["busy_s"] = float(np.mean(tr["busy_s"])) if tr["busy_s"] else 0.0
        dev["window_s"] = tr["window_s"]
    return dev


def _breakdown(tr: dict) -> dict:
    ops = sorted({**tr["copy_s"], **tr["kernel_s"]}.items(),
                 key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr["gaps"], key=lambda g: -g[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
