"""``create_image`` and ``create_image_stream``: ray-list generation, method
dispatch, chunked execution, the cost-feedback reorder, failure handling.

Rebuild of ``RayTrace::create_image`` (src/RayTraceImage.cpp:227-434) on
PyTorch, following ``raytrace_tpu.models.ray_tracer``:

* limits and uniform euv/seed grid checks (RayTraceImage.cpp:229-264);
* method 1 (backward, ASE) or 2 (forward, seeded), scale and ray dims;
* the N_start/N_parallel stride contract (RayTraceImage.cpp:300-328);
* per chunk: entry rays -> trace -> f64 amplify (seeded: the per-ray seed
  factor into kernel B3, which forms the entry spectrum and flags bad
  spectra) -> binning deposit (kernel B2: bins, scale and the I_ang sum in
  one pass) into the call's f64 image and I_ang accumulators;
* per-ray failure codes -1/-2/-3 -> bitmask on the device -> (only when a
  bit is set) the codes, failed-ray dump and abort (RayTraceImage.cpp:
  427-430).

A call is a dispatch (:func:`_dispatch`: upload, every chunk's kernels, the
start of the readback; the host never waits) and a finalize
(:func:`_finalize`: wait for the one readback of image, I_ang and failure
bits). ``create_image`` runs the two back to back; ``create_image_stream``
keeps up to ``depth`` calls dispatched. A dispatch is a sequence of steps,
one a chunk (:func:`_dispatch_steps`), so that a mesh of cards can advance
its entries' dispatches in turns. On a CUDA device the dispatch runs with
that device current (``cuda_lib.device_guard``), whichever device the
caller had made current.

Methods: ``cuda`` runs the hand-written kernels (trace B1, deposit B2,
amplify B3) on a CUDA device; ``cpu`` runs their plain PyTorch twins (on the
CPU unless a ``device`` is given -- a CUDA device then runs the twins on the
card, which is how the kernels are checked end to end). The reference's
method names map onto these two (``_METHOD_ALIASES``).

The problem tables are copied to the device once per call, inside the timed
region: the reference re-uploads per call because production gain tables
change every iteration (Readme.txt:43).
"""

from __future__ import annotations

from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from raytrace_tpu_torch.models.problem import (
    DeviceGain, beam_arrays, beam_from_tensors, gain_arrays, pack_arrays,
    seed_arrays, seed_from_tensors, unpack_arrays)
from raytrace_tpu_torch.ops import (amplify_kernel, binning, cuda_lib,
                                    deposit_kernel, seed as seed_ops,
                                    spectrum, stepper, trace_kernel)
from raytrace_tpu_torch.structures import CreateImageProblem
from raytrace_tpu_torch.utils import errors as err_util
from raytrace_tpu_torch.utils.timer import profiler

__all__ = ["create_image", "create_image_stream", "resolve_method",
           "make_stride_mapper", "generate_ray_indices", "available_methods",
           "reorder_perm", "reorder_row_geom", "N_MAX", "K_MAX", "METHODS"]

N_MAX = 20   # max length segments (RayTraceImageHelper.h:29)
K_MAX = 100  # max frequencies (RayTraceImageHelper.h:30)

METHODS = ("cuda", "cpu")

#: the reference's compute_method names (src/RayTraceImage.cpp:333-423):
#: the CUDA-class backends map to the kernels, every other one to the twins
_METHOD_ALIASES = {
    "threads": "cpu", "openmp": "cpu", "kokkos-serial": "cpu",
    "kokkos-openmp": "cpu", "kokkos-thread": "cpu", "openacc": "cpu",
    "kokkos-cuda": "cuda", "cuda-multigpu": "cuda",
}

#: rays per chunk. On CUDA a call is a few large launches (the seeded
#: shipped shape, 7.8M rays, is eight chunks); each chunk's f64 [chunk, K]
#: spectra live in device memory (peak per call: chip_smoke.py, PERF.md).
#: The CPU chunk keeps the plain trace's masked loops cache-sized.
DEFAULT_CHUNK = {"cuda": 1 << 20, "cpu": 16384}


def _check_grid(d: float, grid) -> bool:
    """Non-uniform spacing at 1e-12*d tolerance (check_grid,
    src/RayTraceImage.cpp:220-226)."""
    diffs = np.diff(np.asarray(grid, np.float64))
    return bool(np.any(np.abs(diffs - d) > 1e-12 * d))


def generate_ray_indices(problem: CreateImageProblem) -> np.ndarray:
    """Global flat ray indices under the stride contract: worker takes
    ``ijkm = N_start + it * N_parallel`` (RayTraceImage.cpp:300-328)."""
    beam = problem.seed_beam if problem.seed is not None else problem.euv_beam
    Nt = beam.nx * beam.ny * beam.na * beam.nb
    its = np.arange(Nt // problem.N_parallel + 1, dtype=np.int64)
    ijkm = problem.N_start + its * problem.N_parallel
    return ijkm[ijkm < Nt]


def make_stride_mapper(dims, N_start: int, N_parallel: int):
    """The stride contract as a function of the stride index:
    ``map_it(it) -> (ijkm, valid)`` with it <= Nt // skip, ijkm < Nt, and
    invalid indices clamped to 0."""
    Nt = dims[0] * dims[1] * dims[2] * dims[3]
    it_max = Nt // N_parallel  # last valid stride index (RayTraceImage.cpp:304)

    def map_it(it):
        ijkm = N_start + it * N_parallel
        valid = (it <= it_max) & (ijkm < Nt)
        return torch.where(valid, ijkm, torch.zeros_like(ijkm)), valid

    return map_it


def _unflatten_rays(ijkm, dims):
    """b-fastest unflatten of the 4-D ray-grid index
    (RayTraceImage.cpp:309-313)."""
    nx, ny, na, nb = dims
    m = ijkm % nb
    k = (ijkm // nb) % na
    j = (ijkm // (na * nb)) % ny
    i = ijkm // (ny * na * nb)
    return i, j, k, m


def available_methods() -> list[str]:
    """The methods this host runs, slowest first: the twins always, the
    kernels where a CUDA device is present."""
    return ["cpu", "cuda"] if torch.cuda.is_available() else ["cpu"]


def resolve_method(compute_method: str = "auto", device=None):
    """``(method, device)`` a call runs with. ``auto`` follows the device;
    without a device, the default one (CUDA when present)."""
    name = compute_method.lower()
    name = _METHOD_ALIASES.get(name, name)
    if name not in METHODS + ("auto",):
        raise err_util.RayTraceError(f"Unknown method: {compute_method}")
    if device is None:
        use_cuda = name == "cuda" or (name == "auto"
                                      and torch.cuda.is_available())
        device = "cuda" if use_cuda else "cpu"
    device = torch.device(device)
    if name == "auto":
        name = "cuda" if device.type == "cuda" else "cpu"
    if name == "cuda" and device.type != "cuda":
        raise err_util.RayTraceError(
            f"method 'cuda' runs the CUDA kernels and needs a CUDA device, "
            f"got {device}")
    return name, device


def _validate(problem: CreateImageProblem):
    """Limits and grid checks (RayTraceImage.cpp:229-264); returns
    (method, source beam, scale, timer name)."""
    if problem.N > N_MAX:
        raise err_util.RayTraceError(
            "Exceeded maximum number of length segments")
    beam = problem.euv_beam
    if beam.nv >= K_MAX:
        raise err_util.RayTraceError("Exceeded maximum number of frequencies")
    for g, d in ((beam.x, beam.dx), (beam.y, beam.dy),
                 (beam.a, beam.da), (beam.b, beam.db)):
        if _check_grid(d, g):
            raise err_util.RayTraceError(
                "Only uniform grid spacings are currently supported (euv_beam)")
    if problem.seed_beam is not None:
        sb = problem.seed_beam
        for g, d in ((sb.x, sb.dx), (sb.y, sb.dy), (sb.a, sb.da),
                     (sb.b, sb.db)):
            if _check_grid(d, g):
                raise err_util.RayTraceError(
                    "Only uniform grid spacings are currently supported "
                    "(seed_beam)")
        if (beam.y[0] >= 0.0) != (sb.y[0] >= 0.0):
            raise err_util.RayTraceError(
                "Negitive y positions in seed_beam or euv_beam, but not both")
    if problem.seed is not None:
        src = problem.seed_beam
        scale = (src.dx * src.dy * src.da * src.db) / (beam.dx * beam.dy)
        return 2, src, scale, "propagate_seed"
    return 1, beam, 1.0, "propagate_ASE"


def create_image(problem: CreateImageProblem, compute_method: str = "auto",
                 device=None, chunk_size: int | None = None, c: float = 0.5,
                 failed_ray_path: str = "Failed_RayTrace_rays.dat",
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Compute the near-field image and the far-field angular image.

    Returns ``(image, I_ang)`` as float64 numpy arrays in the reference's
    flat layouts ``image[nv*(i1+i2*nx)+iv]`` and ``I_ang[i3+i4*na]``; they
    are also stored on ``problem.image`` / ``problem.I_ang``. Raises
    :class:`~raytrace_tpu_torch.utils.errors.RayTraceError` on invalid
    input or when any ray fails, after writing the failed-ray dump to
    ``failed_ray_path``.
    """
    profiler.start("create_image")
    dev = None
    try:
        name, dev = resolve_method(compute_method, device)
        timer_name = _validate(problem)[3] + "-" + name
        profiler.start(timer_name)
        try:
            with cuda_lib.device_guard(dev):
                call = _dispatch(problem, name, dev, chunk_size, c)
            return _finalize(call, failed_ray_path)
        finally:
            profiler.stop(timer_name, dev)
    finally:
        profiler.stop("create_image", dev)


def create_image_stream(problems, compute_method: str = "auto", device=None,
                        chunk_size: int | None = None, c: float = 0.5,
                        depth: int = 2,
                        failed_ray_path: str = "Failed_RayTrace_rays.dat",
                        reorder: bool = False, mesh=None):
    """Overlapped execution over a sequence of independent work units
    (``raytrace_tpu.create_image_stream``).

    Yields ``(image, I_ang)`` per problem, in order, as :func:`create_image`
    returns them: the same per-call table upload, failure path and layouts.
    Up to ``depth`` calls are dispatched and not yet read back; the oldest
    is read back before the next is dispatched. On a CUDA device a call's
    tables go up on an upload stream from a page-locked buffer and its
    result comes back on a readback stream, so call k+1's host packing and
    upload overlap call k's kernels, and call k's readback overlaps call
    k+1's kernels. A failing call raises at its own yield position.

    ``reorder`` turns on the cost-feedback reorder: each chunk's rays run in
    the order of ``(entry fetch row, previous call's micro-step count)``
    (:func:`reorder_perm`), with the counts taken by the trace's counts
    variant and kept on the device in natural ray order for the next call
    of the same shape. The first call, and the first after a shape change,
    runs in natural order. Per-ray results do not depend on the order; only
    the f64 deposits are summed in another order, so images agree with the
    synchronous call to rounding (about 1e-15 relative).

    With ``mesh`` (a tuple of devices, :func:`~raytrace_tpu_torch.parallel.
    mesh.make_mesh`), every unit runs as a sharded call
    (:func:`~raytrace_tpu_torch.parallel.sharding.create_image_sharded`
    semantics) with the same depth bound; each mesh entry keeps its compute
    stream, and with ``reorder`` its own feedback, keyed by its own stride,
    across the units. Pass ``device`` or ``mesh``, not both.
    """
    if depth < 1:
        raise err_util.RayTraceError("create_image_stream needs depth >= 1")
    if mesh is None:
        name, dev = resolve_method(compute_method, device)
        streams = _Streams(dev) if dev.type == "cuda" else None
        feedback = _Feedback() if reorder else None

        def dispatch(problem):
            with cuda_lib.device_guard(dev):
                return _dispatch(problem, name, dev, chunk_size, c, streams,
                                 feedback)
        finalize = _finalize
    else:
        if device is not None:
            raise err_util.RayTraceError(
                "create_image_stream takes device= or mesh=, not both")
        from raytrace_tpu_torch.parallel import sharding

        runner = sharding.MeshRunner(mesh, compute_method, chunk_size, c,
                                     streaming=True, reorder=reorder)
        dev = runner.mesh[0]
        dispatch, finalize = runner.dispatch, sharding._finalize_sharded
    in_flight = deque()
    profiler.start("create_image_stream")
    try:
        for problem in problems:
            if len(in_flight) >= depth:
                yield finalize(in_flight.popleft(), failed_ray_path)
            in_flight.append(dispatch(problem))
        while in_flight:
            yield finalize(in_flight.popleft(), failed_ray_path)
    finally:
        profiler.stop("create_image_stream", dev)


#: rays per window of the row-free reorder fallback (:func:`_window_perm`):
#: 8 (8,128) tiles, the width at which raytrace_tpu's micro-step census
#: found window-local sorts capture nearly all of a perfect sort's gain
#: while every ray stays within 8,192 of its natural position
#: (``raytrace_tpu/models/ray_tracer.py:332-338``). That package computes it
#: as ``_REORDER_WINDOW_TILES * pallas_kernel.TILE``, which its later
#: 16-row tiles doubled; the port keeps the census width.
_REORDER_WINDOW = 8 * 1024

_INT32_MAX = 2 ** 31 - 1


def _window_perm(costs: torch.Tensor, window: int) -> torch.Tensor:
    """Window-local stable argsort (``raytrace_tpu``'s ``_window_perm``): a
    permutation of ``range(len(costs))`` that sorts each ``window``-sized
    block of positions by cost. Uniform costs give the identity; the ragged
    tail is padded with int32-max sentinels, which sort last and are cut
    off."""
    n = costs.shape[0]
    nw = -(-n // window)
    pad = torch.full((nw * window - n,), _INT32_MAX, dtype=torch.int32,
                     device=costs.device)
    c = torch.cat([costs.to(torch.int32), pad])
    perm = torch.argsort(c.reshape(nw, window), dim=1, stable=True)
    perm = perm + (torch.arange(nw, device=costs.device) * window)[:, None]
    return perm.reshape(-1)[:n]


def reorder_row_geom(problem: CreateImageProblem):
    """``(y0, mean_dy, last_row)`` of the first traced segment's gain grid,
    the reorder's primary key (``raytrace_tpu``'s ``reorder_row_geom``), or
    None without a readable row grid (the reorder then sorts by cost within
    windows). A heuristic: the row id never touches the physics."""
    if problem.N < 2 or len(problem.gain) < 2:
        return None
    g1 = problem.gain[1]
    if g1.Ny < 2 or g1.y is None:
        return None
    y1 = np.asarray(g1.y, np.float64)
    return (float(y1[0]), float(np.diff(y1).mean()), int(g1.Ny - 2))


def reorder_perm(row, dims, costs: torch.Tensor, ijkm_nat: torch.Tensor,
                 grid_y: torch.Tensor) -> torch.Tensor:
    """Within-chunk permutation of the cost-feedback reorder
    (``raytrace_tpu``'s ``reorder_perm``): stable argsort by ``(entry fetch
    row k2, previous call's micro-step count)``.

    ``row``: :func:`reorder_row_geom` of the problem; ``dims``: the source
    ray grid (nx, ny, na, nb); ``costs``: [n] i32 counts at the chunk's
    natural positions; ``ijkm_nat``: the chunk's natural ray indices;
    ``grid_y``: the source beam's f32 y grid. All-zero costs keep the
    natural order; ``row`` None falls back to :func:`_window_perm`."""
    n = costs.shape[0]
    if row is None:
        return _window_perm(costs, min(_REORDER_WINDOW, n))
    y0, dy, last = row
    _i, j, _k, _m = _unflatten_rays(ijkm_nat, dims)
    y = grid_y[j].to(torch.float32)
    # half-plane grids mirror y (RayTraceImageHelper.h:325-336); f32 as in
    # raytrace_tpu, divided by a tensor (one rounding on every device). The
    # constants are filled on the device: a host-to-device copy of a Python
    # scalar would wait for every kernel already queued.
    y_eff = torch.abs(y) if y0 >= 0.0 else y
    f32 = dict(dtype=torch.float32, device=costs.device)
    k2 = torch.clamp(torch.ceil((y_eff - torch.full((), y0, **f32))
                                / torch.full((), dy, **f32)) - 1.0, 0, last)
    key = (k2.to(torch.int64) * 2 ** 32
           + torch.clamp(costs, 0, _INT32_MAX).to(torch.int64))
    natural = torch.arange(n, dtype=torch.int64, device=costs.device)
    key = torch.where(torch.any(costs > 0), key, natural)
    return torch.argsort(key, stable=True)


class _Streams:
    """Side streams of a CUDA stream executor: uploads and readbacks each
    on their own stream, so they overlap the compute stream's kernels."""

    def __init__(self, dev):
        self.upload = torch.cuda.Stream(dev)
        self.readback = torch.cuda.Stream(dev)


class _Feedback:
    """The reorder's sort key between calls of a stream: the last
    dispatched call's per-ray counts in natural order (on the device), and
    the shape they belong to."""

    def __init__(self):
        self.key = None
        self.counts = None


class _Call(NamedTuple):
    """A dispatched call: its device work is enqueued; :func:`_finalize`
    reads it back."""

    problem: CreateImageProblem
    method: int
    src: object
    #: [image | I_ang | per-code failure flags] f64: on the host once the
    #: readback is started (its CUDA event ``done``; None on the CPU), on
    #: the device for a dispatch without the readback
    out: torch.Tensor
    done: object
    codes: torch.Tensor     # [B_total] i8 per-ray codes, natural order
    n_image: int


def _pack(problem, src, dev):
    """The call's tables packed on the host into one buffer, page-locked
    for a CUDA ``dev``: ``(buffer, layout)`` of :func:`pack_arrays`."""
    arrays = {f"gain.{k}": v for k, v in gain_arrays(problem.gain).items()}
    arrays.update({f"beam.{k}": v
                   for k, v in beam_arrays(problem.euv_beam).items()})
    for axis, grid in zip("xyab", (src.x, src.y, src.a, src.b)):
        arrays[f"grid.{axis}"] = np.asarray(grid, np.float64).astype(
            np.float32)
    if problem.seed is not None:
        arrays.update({f"seed.{k}": v
                       for k, v in seed_arrays(problem.seed).items()})
    return pack_arrays(arrays, pin=dev.type == "cuda")


def _upload(packed, dev, streams):
    """The call's tables on ``dev`` as a dict of tensors: :func:`_pack`'s
    buffer copied in one transfer (asynchronously, from page-locked memory,
    on the upload stream when ``streams`` is given)."""
    buf, layout = packed
    if dev.type != "cuda":
        dbuf = buf.to(dev)
    elif streams is None:
        dbuf = buf.to(dev, non_blocking=True)
    else:
        with torch.cuda.stream(streams.upload):
            dbuf = buf.to(dev, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(streams.upload)
        compute = torch.cuda.current_stream(dev)
        compute.wait_event(ready)
        dbuf.record_stream(compute)
    t = unpack_arrays(dbuf, layout)

    def part(prefix):
        return {k[len(prefix):]: v for k, v in t.items()
                if k.startswith(prefix)}

    return t, part


def _readback(out: torch.Tensor, dev, streams):
    """Start the copy of ``out`` to the host; returns ``(host, event)``
    (``out`` itself and None on the CPU). The copy follows the current
    stream of ``dev``, and the event is recorded on ``dev``, whichever
    device is current: it completes only after the copy."""
    if dev.type != "cuda":
        return out, None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    compute = torch.cuda.current_stream(dev)
    if streams is None:
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(compute)
        return host, done
    ready = torch.cuda.Event()
    ready.record(compute)
    streams.readback.wait_event(ready)
    with torch.cuda.stream(streams.readback):
        host.copy_(out, non_blocking=True)
        out.record_stream(streams.readback)
        done = torch.cuda.Event()
        done.record(streams.readback)
    return host, done


class _Tables(NamedTuple):
    """A call's tables on its device."""

    gain: DeviceGain
    beam: object            # DeviceBeam
    grids: list             # source grids x, y, a, b as f32
    entry_seed: object      # EntrySeedTables, or None without a seed
    fv: torch.Tensor        # [K] f64 frequency profile (ones without)


def _tables(problem, src, dev, streams=None, packed=None) -> _Tables:
    """Upload the problem's tables to ``dev`` (one transfer; ``packed``:
    :func:`_pack`'s result, when the host packing was done apart) and form
    the entry seed's factor tables there. They depend on the problem alone,
    not on its stride, so the shards of a sharded call on one device share
    them."""
    K = problem.euv_beam.nv
    t, part = _upload(packed or _pack(problem, src, dev), dev, streams)
    grids = [t[f"grid.{axis}"] for axis in "xyab"]
    entry_seed = None
    fv = torch.ones(K, dtype=torch.float64, device=dev)
    if problem.seed is not None:
        entry_seed = seed_ops.make_entry_seed_tables(
            seed_from_tensors(part("seed."), problem.seed), grids, K)
        fv = entry_seed.fv
    return _Tables(gain=DeviceGain(**part("gain.")),
                   beam=beam_from_tensors(part("beam."), problem.euv_beam),
                   grids=grids, entry_seed=entry_seed, fv=fv)


def _dispatch(problem, name, dev, chunk_size, c, streams=None,
              feedback=None, readback=True, tables=None) -> _Call:
    """Validate, upload the tables (unless ``tables`` holds them already),
    enqueue every chunk and (with ``readback``) the readback: every step of
    :func:`_dispatch_steps` at once. Nothing here waits for the device."""
    steps = _dispatch_steps(problem, name, dev, chunk_size, c, streams,
                            feedback, readback, tables)
    while True:
        try:
            next(steps)
        except StopIteration as stop:
            return stop.value


def _dispatch_steps(problem, name, dev, chunk_size, c, streams=None,
                    feedback=None, readback=True, tables=None):
    """:func:`_dispatch` as a generator that yields after each chunk's
    launches and returns the :class:`_Call` (``StopIteration.value``). The
    first step validates, uploads and enqueues the first chunk; the last
    enqueues the failure flags and the readback. ``feedback`` (a stream's
    reorder state) turns on the cost-feedback reorder and is updated in
    place. Each step's work goes to the current stream of ``dev`` (the side
    streams of ``streams`` aside), so a caller that interleaves the steps
    of several dispatches makes each one's device and stream current around
    each step."""
    method, src, scale, _ = _validate(problem)
    beam = problem.euv_beam
    K = beam.nv
    N = problem.N
    use_emis = problem.gain[0].E0 is not None and problem.seed is None
    dims = (src.nx, src.ny, src.na, src.nb)
    if name == "cuda":
        trace, gain_only, deposit = (trace_kernel.trace_batch,
                                     amplify_kernel.amplify_gain,
                                     deposit_kernel.bin_deposit)
    else:
        trace, gain_only, deposit = (stepper.trace_batch_plain,
                                     amplify_kernel.amplify_gain_plain,
                                     deposit_kernel.bin_deposit_plain)

    # one upload of the problem tables per call
    if tables is None:
        tables = _tables(problem, src, dev, streams)
    gain, dbeam, grids = tables.gain, tables.beam, tables.grids
    entry_seed, fv = tables.entry_seed, tables.fv
    gv = gain.gv[1:]
    f64 = dict(dtype=torch.float64, device=dev)

    Nt = dims[0] * dims[1] * dims[2] * dims[3]
    skip = problem.N_parallel
    B_total = (len(range(problem.N_start, Nt, skip))
               if problem.N_start < Nt else 0)
    chunk = max(1, min(chunk_size or DEFAULT_CHUNK[name], max(B_total, 1)))
    map_it = make_stride_mapper(dims, problem.N_start, skip)

    prev = counts = None
    if feedback is not None:
        key = (B_total, chunk, dims, problem.N_start, skip)
        prev = (feedback.counts if feedback.key == key else
                torch.zeros(B_total, dtype=torch.int32, device=dev))
        counts = torch.zeros(B_total, dtype=torch.int32, device=dev)
        row = reorder_row_geom(problem)

    image = torch.zeros((beam.nx * beam.ny, K), dtype=torch.float64,
                        device=dev)
    i_ang = torch.zeros((beam.na * beam.nb, 1), dtype=torch.float64,
                        device=dev)
    codes = torch.zeros(B_total, dtype=torch.int8, device=dev)
    for start in range(0, B_total, chunk):
        n = min(chunk, B_total - start)
        it = torch.arange(start, start + n, dtype=torch.int64, device=dev)
        perm = None
        if prev is not None:
            perm = reorder_perm(row, dims, prev[start:start + n],
                                map_it(it)[0], grids[1])
            it = start + perm
        ijkm, valid = map_it(it)
        i, j, k, m = _unflatten_rays(ijkm, dims)
        rays = {"x": grids[0][i], "y": grids[1][j], "a": grids[2][k],
                "b": grids[3][m]}
        if perm is None:
            res = trace(rays, N, beam.dz, gain, method, c, use_emis)
        else:
            res, cnt = trace(rays, N, beam.dz, gain, method, c, use_emis,
                             counts=True)
            # back to natural order: the next call's sort key
            counts.narrow(0, start, n).index_copy_(0, perm, cnt)
        if use_emis:
            Iv = spectrum.amplify(res, torch.zeros((n, K), **f64), gv, N)
            flags = amplify_kernel.iv_flags(Iv)
        else:
            # the entry seed in factor form; B3 forms f * fv, masks the
            # escaped rays and flags the bad spectra
            f = (torch.zeros(n, **f64) if entry_seed is None else
                 seed_ops.seed_factor(entry_seed, i, j, k, m))
            Iv, flags = gain_only(f, fv, res.escaped, res.ivl, res.gvl, gv)
        code = torch.where(res.perp, -1, torch.where(
            (flags & amplify_kernel.FLAG_NEG) != 0, -2,
            torch.where((flags & amplify_kernel.FLAG_NAN) != 0, -3, 0)))
        code = torch.where(valid, code, 0).to(torch.int8)
        binning.bin_images(Iv, res, rays, dbeam, method, scale,
                           valid & (code == 0), image, i_ang, deposit)
        if perm is None:
            codes[start:start + n] = code
        else:
            # natural order, so the failure path names the physical ray
            codes.narrow(0, start, n).index_copy_(0, perm, code)
        yield
    if feedback is not None:
        feedback.key, feedback.counts = key, counts

    # a flag per failure code (-1, -2, -3), on the device; flags add up
    # across the shards and ranks of a sharded call, and one readback
    # carries them
    flags = torch.stack([torch.any(codes == -err) for err in (1, 2, 3)])
    out = torch.cat([image.reshape(-1), i_ang.reshape(-1),
                     flags.to(torch.float64)])
    done = None
    if readback:
        out, done = _readback(out, dev, streams)
    return _Call(problem=problem, method=method, src=src, out=out,
                 done=done, codes=codes, n_image=image.numel())


#: the failure flags at the end of a call's output, one per code -1/-2/-3
N_FLAGS = 3


def fail_bits(flags) -> int:
    """The reference's failure bitmask (``set_bit(-error)``,
    RayTraceImageCPU.cpp:34) from the per-code flags (or their sums)."""
    bits = 0
    for err, flag in zip((1, 2, 3), flags):
        if flag > 0:
            bits = err_util.set_bit(err, bits)
    return bits


def failed_rays(call: _Call) -> np.ndarray:
    """The flat source-grid indices of the call's failed rays, ascending
    (the per-ray codes are read back here)."""
    its = np.nonzero(call.codes.cpu().numpy() < 0)[0]
    return call.problem.N_start + its.astype(np.int64) * \
        call.problem.N_parallel


def raise_failure(problem, src, method, gidx, bits, failed_ray_path):
    """The failure path (RayTraceImage.cpp:427-430): print the messages,
    dump the first N_FAILED_MAX rays of ``gidx`` with the gain tables,
    raise."""
    dims = (src.nx, src.ny, src.na, src.nb)
    failed = []
    for g in gidx[: err_util.N_FAILED_MAX]:
        gi, gj, gk, gm = _unflatten_rays(int(g), dims)
        failed.append(np.array(
            [src.x[gi], src.y[gj], src.a[gk], src.b[gm]], np.float32))
    for msg in err_util.failure_messages(bits):
        print(msg)
    err_util.write_failures(failed_ray_path, bits, np.array(failed), method,
                            problem.N, problem.euv_beam.dz, problem.gain)
    raise err_util.RayTraceError("Some rays failed")


def _finalize(call: _Call, failed_ray_path: str):
    """Wait for the call's readback; failure path (RayTraceImage.cpp:
    427-430), reading the per-ray codes only when a ray failed; reference
    layout; store on the problem."""
    problem = call.problem
    if call.done is not None:
        call.done.synchronize()
    host = call.out.numpy()
    bits = fail_bits(host[-N_FLAGS:])
    if bits:
        raise_failure(problem, call.src, call.method, failed_rays(call),
                      bits, failed_ray_path)
    image_np = host[:call.n_image].copy()
    i_ang_np = host[call.n_image:-N_FLAGS].copy()
    problem.image = image_np
    problem.I_ang = i_ang_np
    return image_np, i_ang_np
