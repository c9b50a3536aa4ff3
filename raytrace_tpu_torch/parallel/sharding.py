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
  single-device call (:func:`raytrace_tpu_torch.models.ray_tracer._dispatch`,
  the same chunk loop and kernels B1, B3 and B2) on the problem with
  ``N_start' = N_start + g * N_parallel`` and ``N_parallel' = G *
  N_parallel``. That is the set of rays ``raytrace_tpu`` gives device g:
  its stride index ``it = ci * chunk + g + j * G`` (chunk ``ci``, position
  ``j``; ``chunk = per_dev * G``) runs over every ``it`` with ``it % G ==
  g``, and ``N_start + it * N_parallel = N_start' + (it // G) *
  N_parallel'``. The shard's own stride index ``it' = it // G`` therefore
  names the physical ray through ``_finalize``'s own ``gidx = N_start' +
  it' * N_parallel'``. A shard with no rays (more shards than rays)
  yields zeros.
* **Each CUDA entry** is dispatched under ``torch.cuda.device(dev)`` on a
  compute stream of its own, so two entries on one card overlap, and on
  several cards each launches on its own device. The tables depend on the
  problem, not on the stride: the host packs them once, each device gets
  one upload and one seed setup, on its current stream, and its entries'
  streams wait for them.
* **The entries are dispatched together**, as ``shard_map`` runs every
  shard at once: one host thread advances the entries' dispatches
  (``ray_tracer._dispatch_steps``) in turns, one chunk of each entry a
  turn, each under its own device and compute stream. Entry by entry, the
  host would fill one card's launch queue before the next card got its
  first launch. Each entry's chunks, their order and its f64 accumulation
  are those of its own single call.
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
  the end of each entry's first and last step, the reduction), which
  :func:`timeline` reads once the call is finalized.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
    """A sharded call's plan (host only): the method, the mesh, and this
    rank's shard problems, one per mesh entry."""

    problem: CreateImageProblem
    src: object            # the beam whose grids give the rays
    method: str
    mesh: tuple
    shards: tuple          # (device, shard problem) per mesh entry


def prepare_sharded(problem: CreateImageProblem, mesh,
                    compute_method: str = "auto") -> PreparedShardedCall:
    """Validate the problem, resolve the method on the mesh (``cuda`` on a
    CPU mesh raises, as :func:`ray_tracer.resolve_method` does) and give
    each of this rank's mesh entries its stride of the rays."""
    mesh = make_mesh(devices=mesh)
    method = ray_tracer.resolve_method(compute_method, mesh[0])[0]
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
    return PreparedShardedCall(problem=problem, src=src, method=method,
                               mesh=mesh, shards=shards)


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
    tables: dict           # each device's tables, alive until finalized
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
    each CUDA entry's compute stream; when ``streaming``, upload and
    readback streams per card; with ``reorder``, each entry's reorder
    feedback (keyed by the entry's own stride)."""

    def __init__(self, mesh, compute_method: str = "auto",
                 chunk_size: int | None = None, c: float = 0.5,
                 streaming: bool = False, reorder: bool = False):
        self.mesh = make_mesh(devices=mesh)
        self.compute_method = compute_method
        ray_tracer.resolve_method(compute_method, self.mesh[0])
        self.chunk_size, self.c = chunk_size, c
        self.compute = [_compute_stream(dev, d) if dev.type == "cuda"
                        else None for d, dev in enumerate(self.mesh)]
        self.io = ({dev: ray_tracer._Streams(dev) for dev in set(self.mesh)
                    if dev.type == "cuda"} if streaming else {})
        self.feedback = ([ray_tracer._Feedback() for _ in self.mesh]
                         if reorder else [None] * len(self.mesh))

    @contextlib.contextmanager
    def _entry(self, d: int):
        """Entry ``d``'s device and compute stream, made current (nothing
        on the CPU)."""
        with device_guard(self.mesh[d]), torch.cuda.stream(self.compute[d]):
            yield

    def dispatch(self, problem: CreateImageProblem) -> _ShardedCall:
        """Enqueue every shard's chunks, the entries in turns, the
        reduction on ``mesh[0]`` (and over the ranks on the card, in a
        group of one rank per card) and its readback; nothing here waits
        for a device."""
        prep = prepare_sharded(problem, self.mesh, self.compute_method)
        cards = [dev for dev in dict.fromkeys(prep.mesh) if dev.type == "cuda"]

        def event():
            return torch.cuda.Event(enable_timing=True)

        marks = (_Marks(start={dev: event() for dev in cards},
                        first=[event() for _ in prep.mesh],
                        last=[event() for _ in prep.mesh],
                        reduce=(event(), event())) if cards else None)
        for dev in cards:
            marks.start[dev].record(torch.cuda.current_stream(dev))
        # the tables packed once; one upload and seed setup per device, on
        # its current stream; the entries' streams wait for it, and the
        # call keeps the tables until it is finalized
        packed = ray_tracer._pack(problem, prep.src, prep.mesh[0])
        tables, ready = {}, {}
        for dev in dict.fromkeys(prep.mesh):
            with device_guard(dev):
                tables[dev] = ray_tracer._tables(problem, prep.src, dev,
                                                 self.io.get(dev), packed)
                if dev.type == "cuda":
                    ready[dev] = torch.cuda.Event()
                    ready[dev].record(torch.cuda.current_stream(dev))
        # the tables are up already, and the partial stays on the device:
        # no side streams
        steps = [ray_tracer._dispatch_steps(
            sp, prep.method, dev, self.chunk_size, self.c, None,
            self.feedback[d], readback=False, tables=tables[dev])
            for d, (dev, sp) in enumerate(prep.shards)]
        for d, dev in enumerate(prep.mesh):
            if dev.type == "cuda":
                self.compute[d].wait_event(ready[dev])
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
            out, done = ray_tracer._readback(total, total.device,
                                             self.io.get(total.device))
        return _ShardedCall(prep=prep, calls=calls, out=out, done=done,
                            tables=tables, ranks_summed=on_card, marks=marks)


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
                         chunk_size: int | None = None, c: float = 0.5,
                         failed_ray_path: str = "Failed_RayTrace_rays.dat",
                         ) -> tuple[np.ndarray, np.ndarray]:
    """``create_image`` over a mesh of devices (and, in a process group,
    over every rank's mesh): each entry computes a stride share of the rays
    and every rank returns the summed ``(image, I_ang)``, stored on the
    problem as :func:`~raytrace_tpu_torch.models.ray_tracer.create_image`
    stores them. Raises :class:`RayTraceError` on invalid input or when a
    ray fails anywhere, after each rank dumps its own failed rays."""
    profiler.start("create_image-sharded")
    dev = None
    try:
        runner = MeshRunner(mesh, compute_method, chunk_size, c)
        dev = runner.mesh[0]
        return _finalize_sharded(runner.dispatch(problem), failed_ray_path)
    finally:
        profiler.stop("create_image-sharded", dev)


def _finalize_sharded(call: _ShardedCall, failed_ray_path: str
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Wait for the reduced readback, sum it over the ranks, then the
    failure path and the layout contract, as ``ray_tracer._finalize``."""
    if call.done is not None:
        call.done.synchronize()
    host = call.out.numpy()
    if not call.ranks_summed:
        (host,) = collectives.host_sum_arrays([host])
    first = call.calls[0]
    bits = ray_tracer.fail_bits(host[-ray_tracer.N_FLAGS:])
    if bits:
        # this rank's failed rays over its shards, in the single call's
        # (ascending) order
        gidx = np.sort(np.concatenate(
            [ray_tracer.failed_rays(c) for c in call.calls]))
        ray_tracer.raise_failure(call.prep.problem, first.src, first.method,
                                 gidx, bits, failed_ray_path)
    problem = call.prep.problem
    problem.image = host[:first.n_image].copy()
    problem.I_ang = host[first.n_image:-ray_tracer.N_FLAGS].copy()
    return problem.image, problem.I_ang

