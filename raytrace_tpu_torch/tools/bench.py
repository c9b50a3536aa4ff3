"""The port's benchmark: the rows of the root ``bench.py``, timed on one
NVIDIA GPU, in one JSON artifact.

    python -m raytrace_tpu_torch.tools.bench [--ase PATH] [--seed PATH]
                                             [--out PATH] [--cpu]
                                             [--mesh N] [--eager]
                                             [--spectrum f64|f32]

Rows, under the root bench's key names so that the two artifacts lie side
by side:

* ``ase_small_*``: 9 synchronous ``create_image`` calls of the ASE shape
  (399,000 rays); the headline keys (``value``, ``best_seconds_per_call``,
  ...) give its numbers under the root bench's top-level names;
* ``ase_stream_*``: ``create_image_stream`` at depth 4, 6 units, 3 rounds;
* ``seed_small_*`` (9 calls) and ``seed_stream_*`` (depth 2, 3 units, 2
  rounds): the seeded shape (7,803,000 rays);
* ``scale16_*`` (9 calls) and ``scale16_stream_*`` (depth 2, 4 units, 2
  rounds): the ASE shape at ``-scale=16`` (6,384,000 rays), the proxy of the
  reference's ASE_medium input (Readme.txt:47-49);
* ``seed_scale4_*``: 5 calls of the seeded shape at ``-scale=4``
  (30,663,360 rays), the proxy of seed_medium;
* ``scale64_*``: 2 calls of the ASE shape at ``-scale=64`` (24,452,610
  rays), the envelope probe.

Every timed call gets a fresh work unit with distinct gain tables
(``testing.perturbed_problems``), built before the timed region; the table
packing, upload, kernels and readback are inside it. The ASE rows' source
is ``synthetic_problem(**testing.ASE_SHAPE)``, the seeded rows'
``synthetic_problem(**testing.SEED_SHAPE)`` (the shipped snapshots are not
in the checkout), or the snapshot that ``--ase`` / ``--seed`` names.

Each synchronous row records its rays, the best, median, average and
standard deviation of s/call, the reference's stability booleans (recorded,
not gates), every call's stage split, the launches per call of B1, B2 and
B3 (their wrappers' ``launch_count``; a graph replay adds the launches it
captured), and ``mem_after_<row>``: the peak of allocated bytes since the
row began (``max_memory_allocated`` after ``reset_peak_memory_stats``; the
warmup call's eager run and capture allocate what the call needs, which a
replay keeps in the graph's pool), the reserved bytes and the card's
total, or ``{"unavailable": "cpu"}`` on the CPU. Stream rows (graph
replays, a graph per call in flight, also with ``--eager``) record the
same memory and launches, and per round ``fill_s`` (first yield) and
``yield_s`` (spacing of the later yields), as
``testing.time_stream_detailed`` gives them, with steady statistics over
the pooled ``yield_s``.

Stage split of a synchronous call, from consecutive ``perf_counter`` marks
(disjoint stages that add up to ``total_s``), as the root bench splits its
calls: ``prep_s``, ``prepare_pipeline`` (the limits and grid checks, the
host packing of the tables, the cached pipeline's lookup); ``dispatch_s``,
the pipeline's call (on the card the copy of the tables into the graph's
staging buffer and one graph replay; with ``--eager`` the upload and every
chunk's launches from Python); ``wait_s``, ``_finalize_call`` (the wait for
the device and the one readback). Each row starts with an empty pipeline
cache (``ray_tracer.clear_pipeline_cache``), so its warmup call, outside
the timed calls, captures the row's graph: ``<row>_graph`` records that
graph's warm-up and capture seconds, its nodes by type and its pool's
bytes (None with ``--eager`` or on the CPU). ``<row>_busy`` is the
device time of three more calls under ``torch.profiler`` (every CUDA
event's own time) per call, over the row's median s/call (None on the
CPU).

Gates, each a field, listed in ``gates``; any that fails makes the exit
code 1:

* ``golden_check``: ``check_ans`` at 5e-6 and a two-sided relative L2
  below 1e-5 against the embedded golden of both fixtures in
  ``tests/fixtures/`` and of the ``--ase`` / ``--seed`` snapshots;
* ``<row>_cross_backend_check``, on every timed shape: the kernels' image
  and I_ang against the plain twins' on the same device in 2^20-ray chunks,
  ``check_ans`` at 5e-6 with the twins as golden and a relative L2 below
  1e-5;
* ``<stream row>_sync_check``: every yield within a relative L2 of 1e-12
  of the synchronous call on the same unit;
* ``scale_flat_check``: the ``scale64`` row's peak of allocated bytes at
  most 1.10 times the ``scale16`` row's (the chunked design's claim that
  device memory does not grow with the ray count);
* ``graph_memory_check``: after the timed calls of every synchronous row
  (and of every mesh row, on each of its cards), the card's reserved bytes
  less the pools of the graphs cached on it
  (``ray_tracer.graph_pool_bytes``) at most max(256 MiB, 0.10 x the row's
  peak of allocated bytes on that card): what the card reserves beyond the
  graphs, which the cache's bound does not count. Each row records
  ``<row>_reserved_gib``, ``<row>_reserved_over_pools_gib`` and
  ``<row>_graph_memory_check`` (per card on a mesh row); None with
  ``--eager`` and on the CPU, where no graph holds the call's memory.

The full artifact goes to ``--out`` (by default ``bench_torch.json`` in
the checkout's output directory) and to stdout as one line; the last stdout line is a compact
summary: the headline keys, the card's name and power limit, the commit,
the torch and CUDA versions and the chunk size.

With ``--mesh N`` the run adds, after every row above, a row
``<row>_mesh<N>`` for ``ase_small``, ``seed_small``, ``scale64`` and
``seed_scale4``: the same timed units through ``create_image_sharded`` on
``make_mesh(N)`` (the first N cards; one entry a card, the reference's
``Cuda-MultiGPU`` layout), with its s/call statistics and rays/s,
``speedup`` (the same row's best 1-card s/call over its best mesh s/call),
its launches per call per card, ``mem_after_<row>_mesh<N>`` (each card's
peak over the row's sharded calls) and each call's split: ``dispatch_s``
(host: the tables packed once, each entry's graph replayed in turn -- or
its chunks launched in turns with ``--eager`` -- the reduction and
readback enqueued), ``wait_s``
(host: ``_finalize_sharded``), ``reduce_s`` (device: the reduction on the
first card, peer copies and adds once every entry is done; it lies inside
``wait_s``) and ``cards``, each entry's first and last marks (the end of
its first and of its last turn) in ms against its card's start
(``sharding.timeline``), ``<row>_mesh<N>_graphs`` (each entry's graph, as
``<row>_graph``) and ``<row>_mesh<N>_busy`` (the cards' device time over
the mesh's median s/call times the cards). Gates:
``<row>_mesh<N>_single_check``, the pristine unit's sharded image and
I_ang within a relative L2 of 1e-12 of its 1-card call, and ``mesh<N>_golden_check``, both fixtures through the
mesh against their goldens as ``golden_check``. Without ``--mesh`` nothing
of this runs and the keys are as above.

``--eager`` runs every call's chunk loop from Python on the card, as before
the calls were CUDA graphs (``prepare_pipeline(eager=True)``), for the two
to be compared in one run.

``--spectrum=f32`` runs every call with ``spectrum_dtype=float32``, the JAX
package's default spectrum (the f32 kernels B3-f32 and B2-f32 and the f32
emissivity amplify; the twins and the goldens in f32 too), and names each
row ``<row>_f32`` (``seed_small_f32_best_seconds_per_call``, ...). Each f32
synchronous row also calls its pristine unit in f64 and records the
relative L2 between the two (``<row>_f32_rel_vs_f64``), gated as
``<row>_f32_f64_check`` at 1e-5 (``tests/test_golden.py``'s bound), beside
``graph_memory_check`` as for every row.

Without a CUDA device the tool exits non-zero unless ``--cpu`` asks for the
CPU (the plain twins; ``--mesh`` then takes N CPU entries). A row that
raises ends the run. Tests and ``chip_smoke.py`` call :func:`run`.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from raytrace_tpu_torch.io.loader import load_input
from raytrace_tpu_torch.models import ray_tracer
from raytrace_tpu_torch.models.ray_tracer import (DEFAULT_CHUNK, create_image,
                                                  create_image_stream)
from raytrace_tpu_torch.ops import amplify_kernel, deposit_kernel, trace_kernel
from raytrace_tpu_torch.parallel import sharding
from raytrace_tpu_torch.parallel.mesh import make_mesh
from raytrace_tpu_torch.testing import (ASE_SHAPE, SEED_SHAPE, fresh_problem,
                                        perturbed_problems, ray_count,
                                        synthetic_problem,
                                        time_stream_detailed)
from raytrace_tpu_torch.utils.stats import TimingStats, check_ans, stability_ok

__all__ = ["run", "main", "summary"]

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
DEFAULT_OUT = os.path.join(ROOT, "chiprun_out", "bench_torch.json")

#: the sources' ``synthetic_problem`` shapes: (ASE, seeded)
SHAPES = (ASE_SHAPE, SEED_SHAPE)
#: ``-scale=`` of the ``scale16``, ``seed_scale4`` and ``scale64`` rows
SCALES = (16.0, 4.0, 64.0)
#: timed calls of each synchronous row (the root bench's)
REPS = {"ase_small": 9, "seed_small": 9, "scale16": 9, "seed_scale4": 5,
        "scale64": 2}
#: rounds of each stream row (the root bench's)
STREAM_ROUNDS = {"ase_stream": 3, "seed_stream": 2, "scale16_stream": 2}
#: the synchronous rows whose result is held against the plain twins
TWINS = tuple(REPS)

#: synchronous rows: (seeded source, index into the scales or None, salt)
_ROWS = {"ase_small": (False, None, 17), "seed_small": (True, None, 23),
         "scale16": (False, 0, 31), "seed_scale4": (True, 1, 41),
         "scale64": (False, 2, 53)}
#: stream rows: (the synchronous row whose source they stream, units, depth)
_STREAMS = {"ase_stream": ("ase_small", 6, 4),
            "seed_stream": ("seed_small", 3, 2),
            "scale16_stream": ("scale16", 4, 2)}
_ORDER = ("ase_small", "ase_stream", "seed_small", "seed_stream", "scale16",
          "scale16_stream", "seed_scale4", "scale64")

#: the kernels' wrappers, whose launch counts each row reads
_WRAPPERS = {"trace": trace_kernel, "bin_deposit": deposit_kernel,
             "amplify": amplify_kernel}

#: the rows that get a ``_mesh<N>`` row under ``--mesh``
MESH_ROWS = ("ase_small", "seed_small", "scale64", "seed_scale4")

GOLDEN_REL = 1e-5      # two-sided relative L2: goldens and twins
F32_REL = 1e-5         # an f32 row against the f64 call of its unit
STREAM_REL = 1e-12     # stream yields against the synchronous call
MESH_REL = 1e-12       # a sharded call against the 1-card call
SCALE_FLAT = 1.10      # scale64's peak allocated bytes over scale16's
GRAPH_MEMORY_FLOOR = 256 * 2 ** 20  # reserved beyond the graphs' pools:
GRAPH_MEMORY_SHARE = 0.10           # at most the larger of these two
TWIN_CHUNK = 1 << 20   # the kernels' chunk, for the twins on the card

#: the last line's keys beside the headline
SUMMARY_KEYS = (
    "ase_stream_steady_best_s", "ase_stream_steady_stability_ok",
    "seed_small_best_seconds_per_call", "seed_small_stability_ok",
    "seed_small_golden_check", "seed_stream_steady_best_s",
    "scale16_best_seconds_per_call", "scale16_stability_ok",
    "scale16_cross_backend_check", "scale16_stream_steady_best_s",
    "seed_scale4_best_seconds_per_call", "seed_scale4_cross_backend_check",
    "scale64_best_seconds_per_call", "scale_flat_check", "scale_flat_ratio",
    "graph_memory_check")

SCHEMA = ("sync *_calls: disjoint wall intervals, total=prep+dispatch+wait; "
          "prep=prepare_pipeline (host), dispatch=pipeline(*operands) (a "
          "graph replay, or upload+launches when eager), wait=_finalize_call "
          "(device+readback). <row>_graph: the row's graph (capture outside "
          "the timed calls); <row>_busy: profiled device time/median s/call. "
          "stream *_rounds: "
          "fill=first-yield latency, yield_s=steady spacing, round_wall="
          "fill+sum(yield_s); steady stats pool yield_s. Stability booleans "
          "(std<=10%avg and max<=avg+15%, CreateImage.cpp:174-181) are "
          "recorded, not gates. mem_after_<row>: peak since the row began. "
          "Gates: see gates; details in raytrace_tpu_torch/tools/bench.py.")


class _Ctx(NamedTuple):
    dev: torch.device
    method: str          # "cuda" (the kernels) or "cpu" (the plain twins)
    failed_ray_path: str
    eager: bool = False  # the chunk loop from Python in place of graphs
    spectrum: torch.dtype = torch.float64


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _memory(dev) -> dict:
    """Peak allocated bytes since the last reset, reserved bytes and the
    card's total; explicit where the device keeps no statistics."""
    if dev.type != "cuda":
        return {"unavailable": dev.type}
    return {"max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "memory_reserved": torch.cuda.memory_reserved(dev),
            "total": torch.cuda.mem_get_info(dev)[1]}


def _graph_memory(ctx: _Ctx, dev, mem: dict) -> dict:
    """The card's reserved GiB and the GiB it reserves beyond the pools of
    the graphs cached on it, with ``graph_memory_check`` (None on the CPU
    and for calls run from Python)."""
    if dev.type != "cuda":
        return {"reserved_gib": None, "reserved_over_pools_gib": None,
                "graph_memory_check": None}
    over = mem["memory_reserved"] - ray_tracer.graph_pool_bytes(dev)
    limit = max(GRAPH_MEMORY_FLOOR,
                GRAPH_MEMORY_SHARE * mem["max_memory_allocated"])
    return {"reserved_gib": mem["memory_reserved"] / 2 ** 30,
            "reserved_over_pools_gib": over / 2 ** 30,
            "graph_memory_check": None if ctx.eager else over <= limit}


def _all(checks) -> bool | None:
    """False if a check failed, else None if one (or every one, or none at
    all) was not evaluated, else True."""
    if any(c is False for c in checks):
        return False
    return None if not checks or None in checks else True


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _launch_counts() -> dict:
    return {n: w.launch_count for n, w in _WRAPPERS.items()}


def _card_launches() -> dict:
    return {n: dict(w.device_launches) for n, w in _WRAPPERS.items()}


def _per_call(before: dict, n: int) -> dict:
    return {k: (v - before[k]) / n for k, v in _launch_counts().items()}


def _timed_call(ctx: _Ctx, p) -> dict:
    """One synchronous call through the call path's own stages (what
    ``create_image`` runs), with the stage split."""
    t0 = time.perf_counter()
    prep = ray_tracer.prepare_pipeline(p, ctx.method,
                                       spectrum_dtype=ctx.spectrum,
                                       device=ctx.dev, eager=ctx.eager)
    t1 = time.perf_counter()
    outs = prep.pipeline(*prep.operands)
    t2 = time.perf_counter()
    ray_tracer._finalize_call(p, prep, outs, ctx.failed_ray_path)
    t3 = time.perf_counter()
    return {"total_s": t3 - t0, "prep_s": t1 - t0, "dispatch_s": t2 - t1,
            "wait_s": t3 - t2}


def _graphs(pipeline) -> list | None:
    """The graphs of a pipeline: each one's warm-up and capture seconds,
    nodes by type and pool bytes (None for a pipeline run from Python)."""
    if not isinstance(pipeline, ray_tracer._GraphPipeline):
        return None
    return [dict(warmup_s=g.warmup_s, capture_s=g.capture_s, nodes=g.nodes,
                 pool_bytes=g.pool_bytes) for g in pipeline.graphs]


def _device_s(dev, fn, n: int = 3) -> float | None:
    """Device seconds per call of ``fn`` over ``n`` calls under
    torch.profiler: every CUDA event's own time, on every card (None on
    the CPU)."""
    if dev.type != "cuda":
        return None
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / n / 1e6


def _row_stats(prefix: str, totals, n_rays: int) -> dict:
    stats = TimingStats.of(totals)
    best = min(totals)
    return {f"{prefix}n_rays": n_rays,
            f"{prefix}rays_per_sec": n_rays / best,
            f"{prefix}best_seconds_per_call": best,
            f"{prefix}median_seconds_per_call":
                sorted(totals)[len(totals) // 2],
            f"{prefix}avg_seconds_per_call": stats.avg,
            f"{prefix}std_seconds_per_call": stats.std,
            f"{prefix}stability_ok": bool(stability_ok(stats))}


def _twin(ctx: _Ctx, source, scale):
    """The plain twins' ``(image, I_ang)`` of a fresh unit on the bench's
    device, in the kernels' chunks, and the seconds the call took."""
    p = fresh_problem(source, scale)
    t0 = time.perf_counter()
    out = create_image(p, "cpu", device=ctx.dev, chunk_size=TWIN_CHUNK,
                       spectrum_dtype=ctx.spectrum,
                       failed_ray_path=ctx.failed_ray_path)
    return out, time.perf_counter() - t0


def _sync_row(ctx: _Ctx, name: str, source, scale, n: int, salt: int,
              twin: bool) -> dict:
    """A synchronous row: one warmup call on the unperturbed unit (the
    result the twins are held against), then ``n`` timed calls."""
    prefix = name + "_"
    ray_tracer.clear_pipeline_cache()
    _reset_peak(ctx.dev)
    pristine = fresh_problem(source, scale)
    t0 = time.perf_counter()
    _timed_call(ctx, pristine)
    warmup_s = time.perf_counter() - t0
    got = (pristine.image, pristine.I_ang)
    probs = perturbed_problems(source, n, salt=salt, scale=scale)
    before = _launch_counts()
    calls = [_timed_call(ctx, p) for p in probs]
    mem = _memory(ctx.dev)
    row = _row_stats(prefix, [c["total_s"] for c in calls],
                     ray_count(pristine))
    row.update({f"{prefix}calls": calls, f"{prefix}warmup_s": warmup_s,
                f"{prefix}launches_per_call": _per_call(before, n),
                f"mem_after_{name}": mem})
    row.update({prefix + k: v
                for k, v in _graph_memory(ctx, ctx.dev, mem).items()})
    prep = ray_tracer.prepare_pipeline(pristine, ctx.method,
                                       spectrum_dtype=ctx.spectrum,
                                       device=ctx.dev, eager=ctx.eager)
    row[f"{prefix}graph"] = _graphs(prep.pipeline)
    if ctx.spectrum == torch.float32:
        want = create_image(fresh_problem(source, scale), ctx.method,
                            device=ctx.dev,
                            failed_ray_path=ctx.failed_ray_path)
        rel = max(_rel(got[0], want[0]), _rel(got[1], want[1]))
        row[f"{prefix}rel_vs_f64"] = rel
        row[f"{prefix}f64_check"] = rel <= F32_REL
    dev_s = _device_s(ctx.dev, lambda: _timed_call(ctx, probs[0]))
    row[f"{prefix}device_s_per_call"] = dev_s
    row[f"{prefix}busy"] = (None if dev_s is None else
                            dev_s / row[f"{prefix}median_seconds_per_call"])
    check = None
    if twin:
        want, twin_s = _twin(ctx, source, scale)
        r_img, r_ang = _rel(got[0], want[0]), _rel(got[1], want[1])
        check = bool(check_ans(want[0], want[1], *got, verbose=False)
                     and r_img < GOLDEN_REL and r_ang < GOLDEN_REL)
        row[f"{prefix}twin"] = {"rel_image": r_img, "rel_iang": r_ang,
                                "twin_s": twin_s}
    row[f"{prefix}cross_backend_check"] = check
    return row


def _rtt_probe(dev) -> dict:
    """Round trip of one tiny launch and its ``.item()``: the fixed cost
    of a call's wait."""
    x = torch.zeros((), device=dev)
    (x + 1).item()
    ts = []
    for i in range(7):
        t0 = time.perf_counter()
        (x + i).item()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return {"rtt_probe_s": ts[0], "rtt_probe_median_s": ts[len(ts) // 2]}


def _readback_probe(dev) -> dict:
    """A [1500, 52] f64 result read back through the call path's
    ``_readback`` (the ASE image's size), five times."""
    bufs = [torch.full((1500, 52), 1.0 + i, dtype=torch.float64, device=dev)
            for i in range(5)]
    _sync(dev)
    ts = []
    for b in bufs:
        t0 = time.perf_counter()
        _host, done = ray_tracer._readback(b, dev)
        if done is not None:
            done.synchronize()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return {"readback_probe_s": ts[0],
            "readback_probe_median_s": ts[len(ts) // 2]}


def _stream_row(ctx: _Ctx, name: str, source, scale, n_units: int,
                depth: int, rounds: int) -> dict:
    """A stream row over fresh distinct-table units; afterwards every
    yield is held against the synchronous call on its unit."""
    prefix = name + "_"
    ray_tracer.clear_pipeline_cache()
    _reset_peak(ctx.dev)
    stream = functools.partial(create_image_stream, compute_method=ctx.method,
                               spectrum_dtype=ctx.spectrum,
                               device=ctx.dev, depth=depth,
                               failed_ray_path=ctx.failed_ray_path)
    for _ in stream(perturbed_problems(source, depth, salt=99, scale=scale)):
        pass  # warmup: a graph for each call in flight
    seen = []

    def make_stream(units):
        outs = []
        seen.append((units, outs))
        for out in stream(units):
            outs.append(out)
            yield out

    before = _launch_counts()
    per_call, detail = time_stream_detailed(source, n_units, rounds,
                                            make_stream, scale=scale)
    launches = _per_call(before, n_units * rounds)
    mem = _memory(ctx.dev)
    n_rays = ray_count(seen[0][0][0])
    yields = [y for d in detail for y in d["yield_s"]]
    row = {f"{prefix}n_rays": n_rays,
           f"{prefix}rays_per_sec": n_rays / min(per_call),
           f"{prefix}best_seconds_per_call": min(per_call),
           f"{prefix}median_seconds_per_call":
               sorted(per_call)[len(per_call) // 2],
           f"{prefix}rounds": detail,
           f"{prefix}launches_per_call": launches,
           f"mem_after_{name}": mem}
    if yields:
        ys = TimingStats.of(yields)
        row.update({f"{prefix}steady_best_s": min(yields),
                    f"{prefix}steady_median_s":
                        sorted(yields)[len(yields) // 2],
                    f"{prefix}steady_avg_s": ys.avg,
                    f"{prefix}steady_std_s": ys.std,
                    f"{prefix}steady_stability_ok": bool(stability_ok(ys)),
                    f"{prefix}steady_rays_per_sec": n_rays / min(yields)})
    worst = 0.0
    for units, outs in seen:
        if len(outs) != len(units):
            raise RuntimeError(f"{name}: {len(outs)} yields for "
                               f"{len(units)} units")
        for u, (image, i_ang) in zip(units, outs):
            want = create_image(u, ctx.method, device=ctx.dev,
                                spectrum_dtype=ctx.spectrum,
                                failed_ray_path=ctx.failed_ray_path)
            worst = max(worst, _rel(image, want[0]), _rel(i_ang, want[1]))
    row[f"{prefix}max_rel_vs_sync"] = worst
    row[f"{prefix}sync_check"] = worst <= STREAM_REL
    row.update({prefix + k: v for k, v in _rtt_probe(ctx.dev).items()})
    return row


def _mesh_call(ctx: _Ctx, runner, p) -> dict:
    """One sharded call through the sharded path's own stages (what
    ``create_image_sharded`` runs), with its split and marks."""
    t0 = time.perf_counter()
    call = runner.dispatch(p)
    t1 = time.perf_counter()
    sharding._finalize_sharded(call, ctx.failed_ray_path)
    t2 = time.perf_counter()
    c = {"total_s": t2 - t0, "dispatch_s": t1 - t0, "wait_s": t2 - t1}
    marks = sharding.timeline(call)
    if marks is not None:
        c.update(reduce_s=marks["reduce_ms"] / 1e3, cards=marks["entries"])
    return c


def _mesh_row(ctx: _Ctx, name: str, mesh, source, scale, n: int,
              salt: int, single_best: float | None) -> dict:
    """``name``'s units through ``create_image_sharded`` on ``mesh``: the
    pristine unit against its 1-card call, then the 1-card row's ``n``
    timed units."""
    prefix = f"{name}_mesh{len(mesh)}_"
    cards = [d for d in dict.fromkeys(mesh) if d.type == "cuda"]
    ray_tracer.clear_pipeline_cache()
    runner = sharding.MeshRunner(mesh, ctx.method, eager=ctx.eager,
                                 spectrum_dtype=ctx.spectrum)
    single = create_image(fresh_problem(source, scale), ctx.method,
                          spectrum_dtype=ctx.spectrum, device=ctx.dev,
                          failed_ray_path=ctx.failed_ray_path)
    # the peaks of the sharded calls alone
    for dev in cards:
        _reset_peak(dev)
    pristine = fresh_problem(source, scale)
    t0 = time.perf_counter()
    got = sharding._finalize_sharded(runner.dispatch(pristine),
                                     ctx.failed_ray_path)
    warmup_s = time.perf_counter() - t0
    rel = max(_rel(got[0], single[0]), _rel(got[1], single[1]))
    probs = perturbed_problems(source, n, salt=salt, scale=scale)
    before, before_cards = _launch_counts(), _card_launches()
    calls = [_mesh_call(ctx, runner, p) for p in probs]
    after_cards = _card_launches()
    mems = {d: _memory(d) for d in cards}
    held = {str(d): _graph_memory(ctx, d, m) for d, m in mems.items()}
    row = _row_stats(prefix, [c["total_s"] for c in calls],
                     ray_count(pristine))
    best = row[f"{prefix}best_seconds_per_call"]
    row.update({
        f"{prefix}calls": calls, f"{prefix}warmup_s": warmup_s,
        f"{prefix}devices": [str(d) for d in mesh],
        f"{prefix}speedup": None if single_best is None
        else single_best / best,
        f"{prefix}launches_per_call": _per_call(before, n),
        f"{prefix}launches_per_card": {
            k: {str(d): (v - before_cards[k].get(d, 0)) / n
                for d, v in after_cards[k].items()
                if v != before_cards[k].get(d, 0)}
            for k in after_cards},
        f"{prefix}rel_vs_single": rel,
        f"{prefix}single_check": rel <= MESH_REL,
        f"mem_after_{name}_mesh{len(mesh)}": (
            {str(d): m for d, m in mems.items()} if cards
            else _memory(mesh[0]))})
    for k in ("reserved_gib", "reserved_over_pools_gib"):
        row[prefix + k] = {d: h[k] for d, h in held.items()}
    row[prefix + "graph_memory_check"] = _all(
        [h["graph_memory_check"] for h in held.values()])
    prep = sharding.prepare_sharded(pristine, mesh, ctx.method,
                                    spectrum_dtype=ctx.spectrum,
                                    eager=ctx.eager)
    row[f"{prefix}graphs"] = [_graphs(pipe) for pipe in prep.pipeline]
    dev_s = _device_s(ctx.dev, lambda: _mesh_call(ctx, runner, probs[0]))
    row[f"{prefix}device_s_per_call"] = dev_s
    row[f"{prefix}busy"] = (
        None if dev_s is None else
        dev_s / (len(cards) * row[f"{prefix}median_seconds_per_call"]))
    return row


def _golden(ctx: _Ctx, path: str, mesh=None) -> dict:
    """The call (on ``mesh``, when given, the sharded call) against a
    snapshot's embedded golden."""
    p, image0, i_ang0 = load_input(path)
    if image0 is None or len(image0) == 0:
        return {"ok": None, "unavailable": "no embedded golden"}
    if mesh is None:
        image, i_ang = create_image(p, ctx.method, device=ctx.dev,
                                    spectrum_dtype=ctx.spectrum,
                                    failed_ray_path=ctx.failed_ray_path)
    else:
        image, i_ang = sharding.create_image_sharded(
            p, mesh, ctx.method, spectrum_dtype=ctx.spectrum,
            failed_ray_path=ctx.failed_ray_path)
    r_img, r_ang = _rel(image, image0), _rel(i_ang, i_ang0)
    ok = (check_ans(image0, i_ang0, image, i_ang, verbose=False)
          and r_img < GOLDEN_REL and r_ang < GOLDEN_REL)
    return {"ok": bool(ok), "rel_image": r_img, "rel_iang": r_ang}


def _git_commit() -> str:
    try:
        r = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                           text=True, cwd=ROOT, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return r.stdout.strip() or "unknown"


def _card_line(dev):
    """The card's name and power limit as nvidia-smi reports them (the
    first card's for ``cuda`` without an index; None on the CPU)."""
    if dev.type != "cuda":
        return None
    card = [] if dev.index is None else [f"--id={dev.index}"]
    r = subprocess.run(["nvidia-smi", *card, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def run(device="cuda", shapes=SHAPES, scales=SCALES, reps=REPS,
        stream_rounds=STREAM_ROUNDS, twins=TWINS, ase=None, seed=None,
        out_dir=os.path.dirname(DEFAULT_OUT), mesh=None,
        eager=False, spectrum=torch.float64) -> dict:
    """Run the bench's rows on ``device``; returns the artifact.

    ``shapes``: the ASE and seeded ``synthetic_problem`` shapes;
    ``scales``: ``-scale=`` of the ``scale16``, ``seed_scale4`` and
    ``scale64`` rows; ``reps`` / ``stream_rounds``: timed calls / rounds of
    each row, a row left out is not run; ``twins``: the synchronous rows
    held against the plain twins; ``ase`` / ``seed``: snapshot paths that
    replace the synthetic sources; ``out_dir``: where a failing call's
    failed-ray dump goes; ``mesh``: N for the ``_mesh<N>`` rows of
    :data:`MESH_ROWS` (each with its 1-card row in ``reps``) on
    ``make_mesh(N)``, or on N CPU entries for a CPU ``device``; ``eager``:
    the synchronous and mesh rows' calls run from Python on the card in
    place of graph replays; ``spectrum``: every call's ``spectrum_dtype``
    (float32: rows named ``<row>_f32``, each held against its unit's f64
    call). Raises whatever a row raises.
    """
    dev = torch.device(device)
    ctx = _Ctx(dev, "cuda" if dev.type == "cuda" else "cpu",
               os.path.join(out_dir, "bench_failed_rays.dat"), eager,
               spectrum)
    tag = "_f32" if spectrum == torch.float32 else ""
    os.makedirs(out_dir, exist_ok=True)
    sources = (ase or functools.partial(synthetic_problem, **shapes[0]),
               seed or functools.partial(synthetic_problem, **shapes[1]))
    res = {"method": ctx.method, "eager": eager,
           "spectrum": str(spectrum).replace("torch.", ""),
           "platform": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
           "schema": SCHEMA,
           "provenance": {
               "git_commit": _git_commit(), "card": _card_line(dev),
               "torch": torch.__version__, "cuda": torch.version.cuda,
               "chunk_size": DEFAULT_CHUNK[ctx.method],
               "shapes": list(shapes), "scales": list(scales),
               "sources": [s if isinstance(s, str) else "synthetic"
                           for s in sources],
               "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}}

    goldens = {name: _golden(ctx, os.path.join(FIXTURES, name))
               for name in ("golden_ase.dat", "golden_seed.dat")}
    for path in (ase, seed):
        if path:
            goldens[path] = _golden(ctx, path)
    res["golden_checks"] = goldens
    res["golden_check"] = all(g["ok"] is not False for g in goldens.values())
    res["seed_small_golden_check"] = all(
        g["ok"] is not False for k, g in goldens.items()
        if k in ("golden_seed.dat", seed))
    _log(f"golden checks {goldens}")
    res.update(_rtt_probe(dev))
    res.update(_readback_probe(dev))

    for name in _ORDER:
        row = name + tag
        if name in _ROWS and name in reps:
            seeded, si, salt = _ROWS[name]
            res.update(_sync_row(ctx, row, sources[seeded],
                                 None if si is None else scales[si],
                                 reps[name], salt, name in twins))
            _log(f"{row}: {res[f'{row}_n_rays']} rays, best "
                 f"{res[f'{row}_best_seconds_per_call']} s/call, twins "
                 f"{res[f'{row}_cross_backend_check']}, "
                 f"{res[f'mem_after_{row}']}, reserved "
                 f"{res[f'{row}_reserved_gib']} GiB, beyond the graphs' "
                 f"pools {res[f'{row}_reserved_over_pools_gib']} GiB"
                 + (f", against f64 {res[f'{row}_rel_vs_f64']}" if tag
                    else ""))
        elif name in _STREAMS and name in stream_rounds:
            parent, units, depth = _STREAMS[name]
            seeded, si, _ = _ROWS[parent]
            res.update(_stream_row(ctx, row, sources[seeded],
                                   None if si is None else scales[si],
                                   units, depth, stream_rounds[name]))
            _log(f"{row}: best {res[f'{row}_best_seconds_per_call']} "
                 f"s/call, against sync {res[f'{row}_max_rel_vs_sync']}")

    if mesh is not None:
        cards = (make_mesh(mesh) if dev.type == "cuda"
                 else make_mesh(devices=(dev,) * mesh))
        res["mesh_devices"] = [str(d) for d in cards]
        res["mesh_cards"] = [_card_line(d) for d in dict.fromkeys(cards)]
        mesh_goldens = {name: _golden(ctx, os.path.join(FIXTURES, name),
                                      cards)
                        for name in ("golden_ase.dat", "golden_seed.dat")}
        res[f"mesh{mesh}_golden_checks"] = mesh_goldens
        res[f"mesh{mesh}_golden_check"] = all(
            g["ok"] is not False for g in mesh_goldens.values())
        for name in MESH_ROWS:
            if name not in reps:
                continue
            seeded, si, salt = _ROWS[name]
            res.update(_mesh_row(
                ctx, name + tag, cards, sources[seeded],
                None if si is None else scales[si], reps[name], salt,
                res.get(f"{name}{tag}_best_seconds_per_call")))
            p = f"{name}{tag}_mesh{mesh}_"
            _log(f"{p[:-1]}: best {res[p + 'best_seconds_per_call']} "
                 f"s/call, speedup {res[p + 'speedup']}, against 1 card "
                 f"{res[p + 'rel_vs_single']}, reserved "
                 f"{res[p + 'reserved_gib']} GiB, beyond the graphs' pools "
                 f"{res[p + 'reserved_over_pools_gib']} GiB")

    if f"ase_small{tag}_best_seconds_per_call" in res:
        res.update({"metric": f"ase_small{tag}_rays_per_sec",
                    "value": res[f"ase_small{tag}_rays_per_sec"],
                    "unit": "rays/s"})
        res.update({k: res[f"ase_small{tag}_" + k] for k in (
            "best_seconds_per_call", "median_seconds_per_call",
            "avg_seconds_per_call", "std_seconds_per_call", "stability_ok")})

    flat, ratio = None, None
    mems = [res.get(f"mem_after_{r}{tag}", {}).get("max_memory_allocated")
            for r in ("scale16", "scale64")]
    if None not in mems:
        ratio = mems[1] / mems[0]
        flat = ratio <= SCALE_FLAT
    res["scale_flat_ratio"], res["scale_flat_check"] = ratio, flat
    res["graph_memory_check"] = _all([
        v for k, v in res.items() if k.endswith("_graph_memory_check")])

    gates = {"golden_check": res["golden_check"],
             "scale_flat_check": flat,
             "graph_memory_check": res["graph_memory_check"]}
    gates.update({k: v for k, v in res.items()
                  if k.endswith(("_cross_backend_check", "_sync_check",
                                 "_f64_check"))})
    if mesh is not None:
        gates.update({k: v for k, v in res.items()
                      if k.endswith("_single_check")
                      or k == f"mesh{mesh}_golden_check"})
    res["gates"] = gates
    res["gates_not_evaluated"] = sorted(k for k, v in gates.items()
                                        if v is None)
    res["gates_ok"] = all(v is not False for v in gates.values())
    return res


def summary(res: dict) -> dict:
    """The artifact's compact last line."""
    prov = res["provenance"]
    s = {k: res[k] for k in ("metric", "value", "unit",
                             "best_seconds_per_call", "stability_ok",
                             "golden_check", "gates_ok", "method", "eager",
                             "platform") if k in res}
    s.update(card=prov["card"], git_commit=prov["git_commit"][:12],
             torch=prov["torch"], cuda=prov["cuda"],
             chunk_size=prov["chunk_size"])
    tag = "_f32" if res.get("spectrum") == "float32" else ""
    s.update({k: res[k] for k in SUMMARY_KEYS if k in res})
    if tag:
        s["spectrum"] = res["spectrum"]
        for k in SUMMARY_KEYS:
            row = next((r for r in _ORDER if k.startswith(r + "_")), None)
            f32 = k if row is None else row + tag + k[len(row):]
            if f32 in res:
                s[f32] = res[f32]
        s.update({k: v for k, v in res.items() if k.endswith("_f64_check")})
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytrace_tpu_torch.tools.bench",
        description="Time the port's rows of the root bench.py on the card.")
    ap.add_argument("--ase", help="ASE snapshot (.dat) in place of the "
                    "synthetic ASE shape")
    ap.add_argument("--seed", help="seeded snapshot (.dat) in place of the "
                    "synthetic seeded shape")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="the full artifact's path (default: %(default)s)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain twins on the CPU")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="also time the sharded call on make_mesh(N) "
                    "(rows <row>_mesh<N>)")
    ap.add_argument("--eager", action="store_true",
                    help="run the synchronous and mesh rows' calls from "
                    "Python in place of CUDA graph replays")
    ap.add_argument("--spectrum", choices=("f64", "f32"), default="f64",
                    help="every call's spectrum_dtype (f32: rows "
                    "<row>_f32, each held against its unit's f64 call)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device (--cpu runs the plain twins "
                         "on the CPU)")
    res = run("cpu" if args.cpu else "cuda", shapes=SHAPES, scales=SCALES,
              reps=REPS, stream_rounds=STREAM_ROUNDS, twins=TWINS,
              ase=args.ase, seed=args.seed,
              out_dir=os.path.dirname(os.path.abspath(args.out)),
              mesh=args.mesh, eager=args.eager,
              spectrum=(torch.float32 if args.spectrum == "f32"
                        else torch.float64))
    full = json.dumps(res)
    with open(args.out, "w") as f:
        f.write(full + "\n")
    print(full)
    print(json.dumps(summary(res)), flush=True)
    return 0 if res["gates_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
