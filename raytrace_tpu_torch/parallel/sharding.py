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
  problem, not on the stride: each device gets one upload and one seed
  setup, on its current stream, and its entries' streams wait for them.
* **The reduction** (the ``psum``): each entry's f64 [image | I_ang |
  failure flags] partial meets on ``mesh[0]`` (peer copies,
  :func:`~raytrace_tpu_torch.parallel.collectives.sum_reduce`, each
  partial ordered after its stream by an event and kept alive there by
  ``record_stream``), and one readback brings the sum to the host. With a
  process group,
  :func:`~raytrace_tpu_torch.parallel.collectives.host_sum_arrays` then
  sums it over the ranks (gloo), and every rank returns the total;
  the failure flags are counts, so the sum keeps every rank's failures.
  Each rank dumps only its own failed rays (the reference's per-rank
  ``write_failures``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from raytrace_tpu_torch.models import ray_tracer
from raytrace_tpu_torch.parallel import collectives, distributed
from raytrace_tpu_torch.parallel.mesh import make_mesh
from raytrace_tpu_torch.structures import CreateImageProblem
from raytrace_tpu_torch.utils.timer import profiler

__all__ = ["create_image_sharded", "prepare_sharded", "PreparedShardedCall",
           "MeshRunner"]


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


class _ShardedCall(NamedTuple):
    """A dispatched sharded call: each entry's ``_Call`` (device partials,
    per-ray codes) and the reduced output's readback."""

    prep: PreparedShardedCall
    calls: list
    out: torch.Tensor      # reduced [image | I_ang | flags] f64 on the host
    done: object           # CUDA event of the readback (None on the CPU)
    tables: dict           # each device's tables, alive until finalized


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

    def dispatch(self, problem: CreateImageProblem) -> _ShardedCall:
        """Enqueue every shard's chunks, the reduction on ``mesh[0]`` and
        its readback; nothing here waits for a device."""
        prep = prepare_sharded(problem, self.mesh, self.compute_method)
        # one upload and seed setup per device, on its current stream; the
        # entries' streams wait for it, and the call keeps the tables
        # until it is finalized
        tables, ready = {}, {}
        for dev in dict.fromkeys(prep.mesh):
            if dev.type != "cuda":
                tables[dev] = ray_tracer._tables(problem, prep.src, dev)
                continue
            with torch.cuda.device(dev):
                tables[dev] = ray_tracer._tables(problem, prep.src, dev,
                                                 self.io.get(dev))
                ready[dev] = torch.cuda.Event()
                ready[dev].record()
        calls, parts = [], []
        for d, (dev, sp) in enumerate(prep.shards):
            # the tables are up already, and the partial stays on the
            # device: no side streams
            args = (sp, prep.method, dev, self.chunk_size, self.c, None,
                    self.feedback[d])
            if dev.type != "cuda":
                call = ray_tracer._dispatch(*args, readback=False,
                                            tables=tables[dev])
            else:
                with torch.cuda.device(dev), \
                        torch.cuda.stream(self.compute[d]):
                    self.compute[d].wait_event(ready[dev])
                    call = ray_tracer._dispatch(*args, readback=False,
                                                tables=tables[dev])
                    made = torch.cuda.Event()
                    made.record()
                # the reduction reads the partial on the current stream of
                # its device (a peer copy starts there)
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(made)
                call.out.record_stream(cur)
            calls.append(call)
            parts.append(call.out)
        home = prep.mesh[0]
        if home.type != "cuda":
            out, done = collectives.sum_reduce(parts), None
        else:
            with torch.cuda.device(home):
                out, done = ray_tracer._readback(
                    collectives.sum_reduce(parts), home, self.io.get(home))
        return _ShardedCall(prep=prep, calls=calls, out=out, done=done,
                            tables=tables)


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
    (host,) = collectives.host_sum_arrays([call.out.numpy()])
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

