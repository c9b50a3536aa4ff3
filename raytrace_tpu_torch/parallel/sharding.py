"""Multi-device and multi-rank ``create_image``: one call split over a mesh
of devices and over the ranks of a process group.

The reference's multi-device story (SURVEY.md section 2.4): "Cuda-MultiGPU"
gives each GPU a share of the rays and sums the images on the host
(src/RayTraceImage.cpp:396-405); production MPI gives each rank a stride of
the rays (N_start/N_parallel) and sums the image buffers with
MPI_Allreduce (src/RayTraceStructures.cpp:1603-1646).
``raytrace_tpu.parallel.sharding`` runs that as a ``shard_map`` over a 1-D
mesh with one ``psum`` at the end of the call. Here:

* **Shards are strides.** On a mesh of D entries in a process group of P
  ranks, shard ``g = rank * D + d`` of ``G = P * D`` is an ordinary
  single-device call (:func:`raytrace_tpu_torch.models.ray_tracer.
  prepare_pipeline`'s, the same chunk loop and kernels B1, B3 and B2, its
  partial left on the device) on the problem with ``N_start' = N_start +
  g * N_parallel`` and ``N_parallel' = G * N_parallel``. That is the set
  of rays ``raytrace_tpu`` gives device g: its stride index ``it = ci *
  chunk + g + j * G`` (chunk ``ci``, position ``j``; ``chunk = per_dev *
  G``) runs over every ``it`` with ``it % G == g``, and ``N_start + it *
  N_parallel = N_start' + (it // G) * N_parallel'``. The shard's own
  stride index ``it' = it // G`` therefore names the physical ray through
  the shard problem's own ``N_start' + it' * N_parallel'``, as the failure
  path (``ray_tracer._finish``) reads it. A shard with no rays (more
  shards than rays) yields zeros.
* **Each CUDA entry** runs under ``torch.cuda.device(dev)`` on a compute
  stream of its own, so two entries on one card overlap, and on several
  cards each runs on its own device. The host packs the tables once; each
  entry's call uploads them on its own stream.
* **The entries are dispatched together**, as ``shard_map`` runs every
  shard at once: one host thread advances the entries' calls in turns,
  each under its own device and compute stream. With the kernels on a
  card an entry's call is one replay of a CUDA graph of the shard's call,
  captured on the entry's compute stream, so a turn is the whole call;
  a call run from Python (the plain twins, or ``eager``) takes a turn per
  chunk (``ray_tracer._dispatch_steps``), so that the host does not fill
  one card's launch queue before the next card gets its first launch.
  Each entry's chunks, their order and its f64 accumulation are those of
  its own single call.
* **The reduction** (the ``psum``): each entry's f64 [image | I_ang |
  failure flags] partial meets on ``mesh[0]`` (peer copies,
  :func:`~raytrace_tpu_torch.parallel.collectives.sum_reduce`, each
  partial ordered after its stream by an event and kept alive there by
  ``record_stream``), and one readback brings the sum to the host. With a
  process group of one rank per card (NCCL,
  :mod:`~raytrace_tpu_torch.parallel.distributed`), the sum is all-reduced
  over the ranks on the card before that readback
  (:func:`~raytrace_tpu_torch.parallel.collectives.rank_sum_on_card`, the
  process-mesh ``psum``); in a gloo group,
  :func:`~raytrace_tpu_torch.parallel.collectives.host_sum_arrays` sums
  the host copy. Every rank returns the total; the failure flags are
  counts, so the sum keeps every rank's failures. Each rank dumps only its
  own failed rays (the reference's per-rank ``write_failures``).
* **Marks**: on CUDA a call records timing events (each card's start,
  the end of each entry's first and last turn, the reduction), which
  :func:`timeline` reads once the call is finalized; the finalize itself
  records the reduction's device seconds as the profiler's
  ``mesh.reduce``.
* **Spans**: ``utils.timer.profiler`` times the call's host boundaries,
  as a single call's: ``prepare`` (:func:`prepare_sharded`, the tables
  packed once in ``pack``), ``dispatch`` (every entry's turns, the
  reduction's enqueue and the readback's), ``wait`` and ``finalize``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from raytrace_tpu_torch.models import ray_tracer
from raytrace_tpu_torch.ops.cuda_lib import device_guard
from raytrace_tpu_torch.parallel import collectives, distributed
from raytrace_tpu_torch.parallel.mesh import make_mesh
from raytrace_tpu_torch.structures import CreateImageProblem
from raytrace_tpu_torch.utils.timer import profiler

__all__ = ["create_image_sharded", "prepare_sharded", "PreparedShardedCall",
           "MeshRunner", "timeline"]


class PreparedShardedCall(NamedTuple):
    """A sharded call prepared (``raytrace_tpu``'s ``PreparedShardedCall``):
    this rank's shard problems, one per mesh entry, each with its own
    pipeline (:func:`ray_tracer.prepare_pipeline`'s: a CUDA graph of the
    shard's call on the entry's card, its partial left there, or the chunk
    loop), and the tables, packed once for every entry."""

    problem: CreateImageProblem
    method: str
    mesh: tuple
    shards: tuple          # (device, shard problem) per mesh entry
    pipeline: tuple        # each entry's pipeline
    operands: tuple        # (packed tables,), the same for every entry
    #: the call's ``N``, ``K``, ``method``, ``use_emis``,
    #: ``spectrum_dtype``, ``dims``, ``reorder`` (of any entry) and
    #: ``launches`` (the entries' summed), and ``entries``, each entry's
    #: own cfg
    cfg: dict


def prepare_sharded(problem: CreateImageProblem, mesh,
                    compute_method: str = "auto",
                    chunk_size: int | None = None,
                    spectrum_dtype=torch.float64, c: float = 0.5,
                    deposit: str = "auto", reorder: bool = False, *,
                    eager: bool = False) -> PreparedShardedCall:
    """Validate the problem, resolve the method on the mesh (the entries
    name their devices; ``cuda`` on a CPU mesh raises, as a call does), give
    each of this rank's mesh entries its stride of the rays and prepare
    each entry's call. The arguments are ``raytrace_tpu``'s, in its order
    (``spectrum_dtype`` and ``deposit`` as in
    :func:`ray_tracer.prepare_pipeline`); ``eager`` is keyword-only, as
    there."""
    with profiler.span("prepare"):
        mesh = make_mesh(devices=mesh)
        method = ray_tracer._route(compute_method, mesh[0])[0]
        ray_tracer.check_deposit(deposit)
        src = ray_tracer._validate(problem)[1]
        D = len(mesh)
        G = distributed.size() * D
        first = distributed.rank() * D
        step = problem.N_parallel
        shards = tuple(
            (dev, dataclasses.replace(
                problem, N_start=problem.N_start + (first + d) * step,
                N_parallel=G * step, image=None, I_ang=None))
            for d, dev in enumerate(mesh))
        packed = ray_tracer._pack(problem, src, mesh[0])
        entries = [ray_tracer._prepare(sp, method, dev, chunk_size, c,
                                       reorder, readback=False, eager=eager,
                                       packed=packed,
                                       spectrum_dtype=spectrum_dtype)
                   for dev, sp in shards]
        cfgs = tuple(e.cfg for e in entries)
        cfg = {k: cfgs[0][k] for k in ("N", "K", "method", "use_emis",
                                       "spectrum_dtype", "dims")}
        launches = Counter()
        for e in cfgs:
            launches.update(e["launches"])
        cfg.update(reorder=any(e["reorder"] for e in cfgs),
                   launches=dict(launches), entries=cfgs)
        return PreparedShardedCall(
            problem=problem, method=method, mesh=mesh, shards=shards,
            pipeline=tuple(e.pipeline for e in entries),
            operands=(packed[0],), cfg=cfg)


class _Marks(NamedTuple):
    """A sharded call's timing events on CUDA (:func:`timeline`)."""

    start: dict            # card -> its current stream at the call's start
    first: list            # per entry: after its first step (one chunk)
    last: list             # per entry: after its last step
    reduce: tuple          # before and after the reduction on mesh[0]


class _ShardedCall(NamedTuple):
    """A dispatched sharded call: each entry's ``_Call`` (device partials,
    per-ray codes) and the reduced output's readback."""

    prep: PreparedShardedCall
    calls: list
    out: torch.Tensor      # reduced [image | I_ang | flags] f64 on the host
    done: object           # CUDA event of the readback (None on the CPU)
    ranks_summed: bool     # summed over the ranks on the card already
    marks: object          # _Marks on CUDA, None on the CPU


#: the compute stream of each (card, entry index), for the life of the
#: process: the caching allocator keeps each stream's freed blocks for that
#: stream, so a call on the streams of the last one reuses its memory
_COMPUTE_STREAMS: dict = {}


def _compute_stream(dev: torch.device, d: int):
    stream = _COMPUTE_STREAMS.get((dev, d))
    if stream is None:
        stream = _COMPUTE_STREAMS.setdefault((dev, d), torch.cuda.Stream(dev))
    return stream


class MeshRunner:
    """Dispatches sharded calls on one mesh, and keeps what calls share:
    each CUDA entry's compute stream and, with ``reorder``, each entry's
    reorder feedback (keyed by the entry's own stride). ``eager`` runs the
    entries' chunk loops from Python on CUDA too, in turns, one chunk of
    each entry a turn. ``spectrum_dtype`` as in
    :func:`ray_tracer.prepare_pipeline`."""

    def __init__(self, mesh, compute_method: str = "auto",
                 chunk_size: int | None = None, c: float = 0.5,
                 reorder: bool = False, eager: bool = False,
                 spectrum_dtype=torch.float64):
        self.mesh = make_mesh(devices=mesh)
        self.compute_method = compute_method
        ray_tracer._route(compute_method, self.mesh[0])
        ray_tracer.resolve_spectrum_dtype(spectrum_dtype)
        self.chunk_size, self.c = chunk_size, c
        self.spectrum_dtype = spectrum_dtype
        self.reorder, self.eager = reorder, eager
        self.compute = [_compute_stream(dev, d) if dev.type == "cuda"
                        else None for d, dev in enumerate(self.mesh)]
        self.feedback = [ray_tracer._Feedback() for _ in self.mesh]

    @contextlib.contextmanager
    def _entry(self, d: int):
        """Entry ``d``'s device and compute stream, made current (nothing
        on the CPU)."""
        with device_guard(self.mesh[d]), torch.cuda.stream(self.compute[d]):
            yield

    def dispatch(self, problem: CreateImageProblem) -> _ShardedCall:
        """Enqueue every entry's call, the entries in turns (a graph's
        replay is one turn, a chunk loop's chunk is one), the reduction on
        ``mesh[0]`` (and over the ranks on the card, in a group of one rank
        per card) and its readback; nothing here waits for a device."""
        prep = prepare_sharded(problem, self.mesh, self.compute_method,
                               self.chunk_size, self.spectrum_dtype, self.c,
                               "auto", self.reorder, eager=self.eager)
        with profiler.span("dispatch"):
            return self._enqueue(prep)

    def _enqueue(self, prep: PreparedShardedCall) -> _ShardedCall:
        """:meth:`dispatch` of a prepared call."""
        cards = [dev for dev in dict.fromkeys(prep.mesh) if dev.type == "cuda"]
        entries = prep.cfg["entries"]

        def event():
            return torch.cuda.Event(enable_timing=True)

        marks = (_Marks(start={dev: event() for dev in cards},
                        first=[event() for _ in prep.mesh],
                        last=[event() for _ in prep.mesh],
                        reduce=(event(), event())) if cards else None)
        for dev in cards:
            marks.start[dev].record(torch.cuda.current_stream(dev))
        steps = []
        for d, pipe in enumerate(prep.pipeline):
            with self._entry(d):
                steps.append(pipe.steps(*self.feedback[d].operands(
                    entries[d], prep.operands)))
        calls = [None] * len(steps)
        live = list(range(len(steps)))
        turn = 0
        while live:
            for d in tuple(live):
                with self._entry(d):
                    try:
                        next(steps[d])
                    except StopIteration as stop:
                        calls[d] = stop.value
                        self.feedback[d].update(entries[d], calls[d])
                        live.remove(d)
                    if turn == 0 and marks is not None:
                        marks.first[d].record(self.compute[d])
            turn += 1
        for d, dev in enumerate(prep.mesh):
            if dev.type == "cuda":
                marks.last[d].record(self.compute[d])
                # the reduction reads the partial on the current stream of
                # its device (a peer copy starts there)
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(marks.last[d])
                calls[d].out.record_stream(cur)
        home = prep.mesh[0]
        on_card = home.type == "cuda" and distributed.device_collectives()
        with device_guard(home):
            if marks is not None:
                # the reduction's first mark after every entry's last, so
                # that it times the copies and adds alone, not the wait for
                # the slowest card
                for last in marks.last:
                    torch.cuda.current_stream(home).wait_event(last)
                marks.reduce[0].record(torch.cuda.current_stream(home))
            total = collectives.sum_reduce([c.out for c in calls])
            if marks is not None:
                marks.reduce[1].record(torch.cuda.current_stream(home))
            if on_card:
                total = collectives.rank_sum_on_card(total)
            out, done = ray_tracer._readback(total, total.device)
        return _ShardedCall(prep=prep, calls=calls, out=out, done=done,
                            ranks_summed=on_card, marks=marks)


def timeline(call: _ShardedCall) -> dict | None:
    """A finalized sharded call's marks in ms, each against the start of
    its card's current stream when the call was dispatched: per entry its
    ``device``, ``first`` (its first chunk's kernels done) and ``last``
    (its last step done), and the reduction's device ``reduce_ms`` (from
    the end of the last entry). Times on one card share a clock; across
    cards they are comparable to the spread of the start marks, which were
    recorded in one host pass. None for a call on the CPU."""
    m = call.marks
    if m is None:
        return None
    entries = []
    for d, dev in enumerate(call.prep.mesh):
        start = m.start[dev]
        entries.append(dict(device=str(dev),
                            first=start.elapsed_time(m.first[d]),
                            last=start.elapsed_time(m.last[d])))
    return dict(entries=entries,
                reduce_ms=m.reduce[0].elapsed_time(m.reduce[1]))


def create_image_sharded(problem: CreateImageProblem, mesh,
                         compute_method: str = "auto",
                         chunk_size: int | None = None,
                         spectrum_dtype=torch.float64, c: float = 0.5,
                         deposit: str = "auto",
                         failed_ray_path: str = "Failed_RayTrace_rays.dat",
                         ) -> tuple[np.ndarray, np.ndarray]:
    """``create_image`` over a mesh of devices (and, in a process group,
    over every rank's mesh): each entry computes a stride share of the rays
    and every rank returns the summed ``(image, I_ang)``, stored on the
    problem as :func:`~raytrace_tpu_torch.models.ray_tracer.create_image`
    stores them. The arguments are ``raytrace_tpu``'s, in its order.
    Raises :class:`RayTraceError` on invalid input or when a ray fails
    anywhere, after each rank dumps its own failed rays."""
    profiler.start("create_image-sharded")
    try:
        ray_tracer.check_deposit(deposit)
        runner = MeshRunner(mesh, compute_method, chunk_size, c,
                            spectrum_dtype=spectrum_dtype)
        return _finalize_sharded(runner.dispatch(problem), failed_ray_path)
    finally:
        # closes after the call's own wait for its readback
        profiler.stop("create_image-sharded")


def _finalize_sharded(call: _ShardedCall, failed_ray_path: str
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Wait for the reduced readback (the ``wait`` span), then in the
    ``finalize`` span the reduction's device seconds (``mesh.reduce``, on
    CUDA, from the call's own marks), the sum over the ranks and
    :func:`ray_tracer._finish` of the sum over this rank's shards (each
    rank dumps its own failed rays); the entries' graphs may run again
    after."""
    try:
        with profiler.span("wait"):
            if call.done is not None:
                call.done.synchronize()
        with profiler.span("finalize"):
            if call.marks is not None:
                # both marks precede the readback's event: complete now
                profiler.add("mesh.reduce", 1e-3 * call.marks.reduce[0]
                             .elapsed_time(call.marks.reduce[1]))
            host = call.out.numpy()
            if not call.ranks_summed:
                (host,) = collectives.host_sum_arrays([host])
            return ray_tracer._finish(
                call.prep.problem, host,
                [(sp, c.codes) for (_dev, sp), c in zip(call.prep.shards,
                                                        call.calls)],
                call.prep.cfg["method"], failed_ray_path)
    finally:
        ray_tracer._release(*call.calls)
