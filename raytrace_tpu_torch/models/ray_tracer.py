"""``create_image`` and ``create_image_stream``: ray-list generation, method
dispatch, chunked execution, the cost-feedback reorder, failure handling.

Rebuild of ``RayTrace::create_image`` (src/RayTraceImage.cpp:227-434) on
PyTorch, following ``raytrace_tpu.models.ray_tracer``:

* limits and uniform euv/seed grid checks (RayTraceImage.cpp:229-264);
* method 1 (backward, ASE) or 2 (forward, seeded), scale and ray dims;
* the N_start/N_parallel stride contract (RayTraceImage.cpp:300-328);
* per chunk: entry rays -> trace -> amplify (seeded: the per-ray seed
  factor into kernel B3, which forms the entry spectrum and flags bad
  spectra) -> binning deposit (kernel B2: bins, scale and the I_ang sum in
  one pass) into the call's f64 image and I_ang accumulators;
* the spectrum in f64 (the port's default, the reference's arithmetic) or,
  with ``spectrum_dtype`` float32, in ``raytrace_tpu``'s default f32
  two-float form (the f32 instantiations of B3 and B2, the f32 emissivity
  amplify); the image and I_ang accumulate in f64 either way;
* per-ray failure codes -1/-2/-3 -> bitmask on the device -> (only when a
  bit is set) the codes, failed-ray dump and abort (RayTraceImage.cpp:
  427-430).

A call is split, as in ``raytrace_tpu``, into a prepare and an execute:
:func:`prepare_pipeline` validates the problem, packs its tables on the
host and resolves the static configuration (``cfg``), and fetches the
cached whole-call pipeline of that configuration; ``pipeline(*operands)``
enqueues the whole call (the upload of the packed tables, every chunk's
kernels, the failure flags, the readback) without waiting for the device;
:func:`_finalize_call` waits for the readback and runs the failure path and
the layout. ``create_image`` is the three in a row; ``create_image_stream``
keeps up to ``depth`` calls dispatched.

On a CUDA device with the kernels (method ``cuda``) the pipeline is a CUDA
graph of the whole call (:class:`_GraphPipeline`): captured once per
configuration and then replayed, one host call per call, with each call's
tables copied into the graph's page-locked staging buffer first. Elsewhere
(the plain twins, on the CPU or on a card) it runs the chunk loop from
Python (:class:`_EagerPipeline`, which is also what a graph captures). On
a CUDA device the call runs with that device current
(``cuda_lib.device_guard``), whichever device the caller had made current.

Methods: ``cuda`` runs the hand-written kernels (trace B1, deposit B2,
amplify B3) on a CUDA device; ``cpu`` runs their plain PyTorch twins (on the
CPU unless a ``device`` is given -- a CUDA device then runs the twins on the
card, which is how the kernels are checked end to end). The reference's
method names and ``raytrace_tpu``'s (``pallas``; ``lax`` and ``lax-exact``)
map onto these two (``_METHOD_ALIASES``).

The entry points take ``raytrace_tpu``'s arguments in its positional order
(``compute_method, chunk_size, spectrum_dtype, c, deposit, ...``); the
device is keyword-only, after them. ``spectrum_dtype`` defaults to float64
here, where ``raytrace_tpu`` defaults to float32 (a TPU emulates f64).
``deposit`` takes ``raytrace_tpu``'s strategy names, which all run kernel
B2 on ``cuda`` and its twin elsewhere (:data:`DEPOSITS`).

The problem tables are copied to the device once per call, inside the timed
region: the reference re-uploads per call because production gain tables
change every iteration (Readme.txt:43).
"""

from __future__ import annotations

import time
from collections import OrderedDict, deque
from typing import NamedTuple

import numpy as np
import torch

from raytrace_tpu_torch.models.problem import (
    DeviceGain, beam_arrays, beam_from_tensors, beam_scalars, gain_arrays,
    pack_arrays, seed_arrays, seed_from_tensors, seed_scalars, unpack_arrays)
from raytrace_tpu_torch.ops import (amplify_kernel, binning, cuda_lib,
                                    deposit_kernel, seed as seed_ops,
                                    spectrum, stepper, trace_kernel)
from raytrace_tpu_torch.structures import CreateImageProblem
from raytrace_tpu_torch.utils import errors as err_util
from raytrace_tpu_torch.utils.timer import profiler

__all__ = ["create_image", "create_image_stream", "prepare_pipeline",
           "PreparedCall", "resolve_method", "resolve_spectrum_dtype",
           "check_deposit", "make_stride_mapper", "generate_ray_indices",
           "available_methods", "reorder_perm", "reorder_row_geom",
           "clear_pipeline_cache", "N_MAX", "K_MAX", "METHODS", "DEPOSITS",
           "GRAPH_POOL_SHARE"]

N_MAX = 20   # max length segments (RayTraceImageHelper.h:29)
K_MAX = 100  # max frequencies (RayTraceImageHelper.h:30)

METHODS = ("cuda", "cpu")

#: the reference's compute_method names (src/RayTraceImage.cpp:333-423):
#: the CUDA-class backends map to the kernels, every other one to the twins;
#: and ``raytrace_tpu``'s backends: its kernel backend ``pallas`` to the
#: kernels, its XLA backends ``lax`` and ``lax-exact`` to the twins on the
#: call's device (as it maps ``cuda`` to ``pallas`` and ``cpu`` to
#: ``lax-exact``)
_METHOD_ALIASES = {
    "threads": "cpu", "openmp": "cpu", "kokkos-serial": "cpu",
    "kokkos-openmp": "cpu", "kokkos-thread": "cpu", "openacc": "cpu",
    "kokkos-cuda": "cuda", "cuda-multigpu": "cuda",
    "pallas": "cuda", "lax": "cpu", "lax-exact": "cpu",
}

#: ``raytrace_tpu``'s deposit strategies (``resolve_bin_deposit``). On a TPU
#: they are different kernels: ``scatter`` a ``segment_sum``, ``matmul`` the
#: one-hot MXU deposit (its Pallas kernel, what B2 ports) and ``dense`` a
#: pure reduction over full natural-order ASE grids, which ``auto`` never
#: picks. Here every name runs the one binning deposit, B2 on ``cuda`` and
#: its twin elsewhere: the images agree up to the order of the f64 sums.
DEPOSITS = ("auto", "scatter", "matmul", "dense")

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
    beam = _source_beam(problem)
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


def resolve_spectrum_dtype(spectrum_dtype) -> torch.dtype:
    """The spectrum's dtype, ``torch.float64`` or ``torch.float32``, from a
    torch dtype or anything ``np.dtype()`` takes (``np.float32``,
    ``"float32"``, a ``jnp.float32`` of a JAX-side caller). Anything else
    raises :class:`RayTraceError`."""
    if isinstance(spectrum_dtype, torch.dtype):
        dtype = spectrum_dtype
    else:
        try:
            dtype = {np.dtype(np.float64): torch.float64,
                     np.dtype(np.float32): torch.float32}.get(
                np.dtype(spectrum_dtype))
        except (TypeError, ValueError):
            dtype = None
    if dtype not in (torch.float64, torch.float32):
        raise err_util.RayTraceError(
            f"spectrum_dtype must be float64 or float32, got "
            f"{spectrum_dtype!r}")
    return dtype


def check_deposit(deposit: str) -> None:
    """Raise the error ``raytrace_tpu`` raises for an unknown strategy
    unless ``deposit`` names one of :data:`DEPOSITS`."""
    if deposit not in DEPOSITS:
        raise err_util.RayTraceError(
            f"Unknown deposit strategy '{deposit}' "
            "(expected auto/dense/matmul/scatter)")


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


class PreparedCall(NamedTuple):
    """The prepare/execute split of a ``create_image`` call
    (``raytrace_tpu``'s ``PreparedCall``).

    ``pipeline(*operands)`` enqueues the whole call -- the upload of the
    packed tables, every chunk's kernels, the failure flags and the
    readback -- and returns its :class:`_Call` without waiting for the
    device; :func:`_finalize_call` waits for it. With ``cfg["reorder"]``
    the pipeline takes one more operand, the previous call's per-ray
    counts in natural order (all zero: the natural order), and the call
    returns its own (``_Call.counts``).
    """

    pipeline: object
    #: (packed tables: one host uint8 buffer, page-locked for a CUDA device)
    operands: tuple
    #: the static configuration the pipeline was built for: ``N``, ``K``,
    #: ``method``, ``use_emis``, ``spectrum_dtype``, ``dims``, ``chunk``,
    #: ``n_chunks``, ``N_start``, ``N_parallel``, ``reorder`` (as built: on
    #: where asked and the call has rays), ``graph`` (a CUDA graph, or the
    #: chunk loop from Python), ``launches`` (each kernel's launches in one
    #: call, the f32 instantiations also under their own names), the table
    #: layout and the host scalars the call bakes in
    cfg: dict
    timer_name: str


def prepare_pipeline(problem: CreateImageProblem, compute_method: str = "auto",
                     chunk_size: int | None = None,
                     spectrum_dtype=torch.float64, c: float = 0.5,
                     deposit: str = "auto", reorder: bool = False, *,
                     device=None, eager: bool = False) -> PreparedCall:
    """Validate the problem, pack its tables on the host, resolve the static
    config and fetch the cached whole-call pipeline of that config.

    The arguments are ``raytrace_tpu``'s, in its order; ``device`` (the
    call's device: default the CUDA card where there is one) and ``eager``
    are keyword-only. ``spectrum_dtype``: f64 (the default) or f32, the
    JAX package's default two-float spectrum; the f32 and f64 calls of one
    problem are two configs, two cached pipelines. ``deposit``: one of
    :data:`DEPOSITS` (all run B2).

    The host-to-device copy of the tables happens when the returned
    pipeline is called with the returned operands, inside the timed region
    (the reference re-uploads per call, Readme.txt:43). On a CUDA device
    with method ``cuda`` the pipeline replays a CUDA graph of the call,
    captured on the first call of its config (after one eager warm-up
    call); ``eager`` asks for the chunk loop from Python there instead (the
    reference the graphs are held against). Elsewhere the pipeline is the
    chunk loop. ``reorder`` asks for the cost-feedback reorder
    (``cfg["reorder"]`` says whether it was built: a call with no rays has
    nothing to sort).
    """
    name, dev = resolve_method(compute_method, device)
    check_deposit(deposit)
    return _prepare(problem, name, dev, chunk_size, c, reorder, eager=eager,
                    spectrum_dtype=spectrum_dtype)


def _card(dev) -> torch.device:
    """``dev`` with its index: ``cuda`` alone is the current card (a graph
    is bound to the card it was captured on)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _prepare(problem, name, dev, chunk_size=None, c=0.5, reorder=False,
             readback=True, eager=False, packed=None,
             spectrum_dtype=torch.float64) -> PreparedCall:
    """:func:`prepare_pipeline` for a resolved method and device; without
    ``readback`` the call's output stays on the device (a mesh entry's
    partial); ``packed``: the tables of :func:`_pack`, when packed apart."""
    sdtype = resolve_spectrum_dtype(spectrum_dtype)
    method, src, scale, timer_name = _validate(problem)
    dev = _card(dev)
    beam = problem.euv_beam
    dims = (src.nx, src.ny, src.na, src.nb)
    Nt = dims[0] * dims[1] * dims[2] * dims[3]
    skip = problem.N_parallel
    B_total = (len(range(problem.N_start, Nt, skip))
               if problem.N_start < Nt else 0)
    chunk = max(1, min(chunk_size or DEFAULT_CHUNK[name], max(B_total, 1)))
    n_chunks = -(-B_total // chunk)
    use_emis = problem.gain[0].E0 is not None and problem.seed is None
    reorder = bool(reorder) and B_total > 0
    buf, layout = packed or _pack(problem, src, dev)
    kernels = n_chunks if name == "cuda" else 0
    f32 = kernels if sdtype == torch.float32 else 0
    n_image = beam.nx * beam.ny * beam.nv
    cfg = dict(
        name=name, device=dev, N=problem.N, dz=float(beam.dz), K=beam.nv,
        method=method, use_emis=use_emis, spectrum_dtype=sdtype, dims=dims,
        scale=float(scale),
        c=float(c), chunk=chunk, n_chunks=n_chunks, B_total=B_total,
        N_start=problem.N_start, N_parallel=skip, reorder=reorder,
        reorder_row=reorder_row_geom(problem) if reorder else None,
        pack_layout=tuple(layout), beam_scalars=beam_scalars(beam),
        seed_scalars=(None if problem.seed is None
                      else seed_scalars(problem.seed)),
        n_image=n_image, n_out=n_image + beam.na * beam.nb + N_FLAGS,
        readback=readback, graph=name == "cuda" and not eager,
        launches=dict(trace=kernels, bin_deposit=kernels,
                      amplify=0 if use_emis else kernels,
                      bin_deposit_f32=f32,
                      amplify_f32=0 if use_emis else f32))
    return PreparedCall(pipeline=_pipeline(cfg), operands=(buf,), cfg=cfg,
                        timer_name=timer_name + "-" + name)


def create_image(problem: CreateImageProblem, compute_method: str = "auto",
                 chunk_size: int | None = None,
                 spectrum_dtype=torch.float64, c: float = 0.5,
                 deposit: str = "auto",
                 failed_ray_path: str = "Failed_RayTrace_rays.dat", *,
                 device=None) -> tuple[np.ndarray, np.ndarray]:
    """Compute the near-field image and the far-field angular image.

    ``raytrace_tpu.create_image``'s arguments in its order (see
    :func:`prepare_pipeline`; ``spectrum_dtype`` defaults to float64 here),
    and the keyword ``device``. Returns ``(image, I_ang)`` as float64 numpy
    arrays in the reference's flat layouts ``image[nv*(i1+i2*nx)+iv]`` and
    ``I_ang[i3+i4*na]``; they are also stored on ``problem.image`` /
    ``problem.I_ang``. Raises
    :class:`~raytrace_tpu_torch.utils.errors.RayTraceError` on invalid
    input or when any ray fails, after writing the failed-ray dump to
    ``failed_ray_path``. The call is :func:`prepare_pipeline`, the
    pipeline, then :func:`_finalize_call`.
    """
    profiler.start("create_image")
    dev = None
    try:
        prep = prepare_pipeline(problem, compute_method, chunk_size,
                                spectrum_dtype, c, deposit, device=device)
        dev = prep.cfg["device"]
        profiler.start(prep.timer_name)
        try:
            outs = prep.pipeline(*prep.operands)
            return _finalize_call(problem, prep, outs, failed_ray_path)
        finally:
            profiler.stop(prep.timer_name, dev)
    finally:
        profiler.stop("create_image", dev)


def _finalize_call(problem: CreateImageProblem, prep: PreparedCall,
                   outs, failed_ray_path: str
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Blocking tail of a dispatched call: wait for its readback; the
    failure path (RayTraceImage.cpp:427-430), reading the per-ray codes
    only when a ray failed; the reference layout; store on the problem.
    A graph's outputs are read before the graph may run again."""
    try:
        if outs.done is not None:
            outs.done.synchronize()
        host = outs.out.numpy()
        bits = fail_bits(host[-N_FLAGS:])
        if bits:
            raise_failure(problem, _source_beam(problem), prep.cfg["method"],
                          failed_rays(problem, outs.codes), bits,
                          failed_ray_path)
        image_np = host[:outs.n_image].copy()
        i_ang_np = host[outs.n_image:-N_FLAGS].copy()
    finally:
        _release(outs)
    problem.image = image_np
    problem.I_ang = i_ang_np
    return image_np, i_ang_np


def create_image_stream(problems, compute_method: str = "auto",
                        chunk_size: int | None = None,
                        spectrum_dtype=torch.float64, c: float = 0.5,
                        deposit: str = "auto", depth: int = 2,
                        failed_ray_path: str = "Failed_RayTrace_rays.dat",
                        mesh=None, reorder: bool = False, *, device=None):
    """Overlapped execution over a sequence of independent work units
    (``raytrace_tpu.create_image_stream``, its arguments in its order, and
    the keyword ``device``).

    Yields ``(image, I_ang)`` per problem, in order, as :func:`create_image`
    returns them: the same per-call table upload, failure path and layouts.
    Each unit is prepared with :func:`prepare_pipeline`, and up to
    ``depth`` calls are dispatched and not yet read back; the oldest is
    read back before the next is dispatched, so call k+1's host packing and
    dispatch overlap call k's device work. On a CUDA device each call in
    flight replays a graph of its own (the key's graphs, one per call in
    flight), all on the current stream. A failing call raises at its own
    yield position.

    ``reorder`` turns on the cost-feedback reorder: each chunk's rays run in
    the order of ``(entry fetch row, previous call's micro-step count)``
    (:func:`reorder_perm`), with the counts taken by the trace's counts
    variant and kept on the device in natural ray order for the next call
    of the same rays and chunks. The first call, and the first after a
    change, runs in natural order. Per-ray results do not depend on the
    order; only the f64 deposits are summed in another order, so images
    agree with the synchronous call to rounding (about 1e-15 relative).

    With ``mesh`` (a tuple of devices, :func:`~raytrace_tpu_torch.parallel.
    mesh.make_mesh`), every unit runs as a sharded call
    (:func:`~raytrace_tpu_torch.parallel.sharding.create_image_sharded`
    semantics) with the same depth bound; each mesh entry keeps its compute
    stream, and with ``reorder`` its own feedback, keyed by its own stride,
    across the units. Pass ``device`` or ``mesh``, not both.
    """
    if depth < 1:
        raise err_util.RayTraceError("create_image_stream needs depth >= 1")
    check_deposit(deposit)
    if mesh is None:
        name, dev = resolve_method(compute_method, device)
        feedback = _Feedback()

        def dispatch(problem):
            prep = prepare_pipeline(problem, name, chunk_size,
                                    spectrum_dtype, c, deposit, reorder,
                                    device=dev)
            outs = prep.pipeline(*feedback.operands(prep.cfg, prep.operands))
            feedback.update(prep.cfg, outs)
            return problem, prep, outs

        def finalize(item):
            return _finalize_call(*item, failed_ray_path)

        def discard(item):
            _discard(item[2])
    else:
        if device is not None:
            raise err_util.RayTraceError(
                "create_image_stream takes device= or mesh=, not both")
        from raytrace_tpu_torch.parallel import sharding

        runner = sharding.MeshRunner(mesh, compute_method, chunk_size, c,
                                     reorder=reorder,
                                     spectrum_dtype=spectrum_dtype)
        dev = runner.mesh[0]
        dispatch = runner.dispatch

        def finalize(call):
            return sharding._finalize_sharded(call, failed_ray_path)
        discard = sharding._discard_sharded
    in_flight = deque()
    profiler.start("create_image_stream")
    try:
        for problem in problems:
            if len(in_flight) >= depth:
                yield finalize(in_flight.popleft())
            in_flight.append(dispatch(problem))
        while in_flight:
            yield finalize(in_flight.popleft())
    finally:
        # a stream ended early (a failing call, a consumer that stopped)
        # leaves no graph in flight
        while in_flight:
            discard(in_flight.popleft())
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


class _Feedback:
    """The reorder's sort key between calls of a stream (or of a mesh
    entry): the last dispatched call's per-ray counts in natural order (on
    the device), and the rays and chunks they belong to."""

    def __init__(self):
        self.key = None
        self.counts = None

    def operands(self, cfg: dict, operands: tuple) -> tuple:
        """A call's ``operands``, with the sort key appended where its
        ``cfg`` runs the reorder: the last call's counts when it had the
        same rays in the same chunks, else zeros (the natural order)."""
        if not cfg["reorder"]:
            return operands
        key = (cfg["B_total"], cfg["chunk"], cfg["dims"], cfg["N_start"],
               cfg["N_parallel"], cfg["device"])
        if self.key != key:
            self.key = key
            self.counts = torch.zeros(cfg["B_total"], dtype=torch.int32,
                                      device=cfg["device"])
        return operands + (self.counts,)

    def update(self, cfg: dict, call) -> None:
        """Keep ``call``'s counts as the next call's sort key."""
        if cfg["reorder"]:
            self.counts = call.counts


class _Call(NamedTuple):
    """A dispatched call's outputs: its device work is enqueued;
    :func:`_finalize_call` reads it back."""

    #: [image | I_ang | per-code failure flags] f64: on the host once the
    #: readback is started (its CUDA event ``done``; None on the CPU), on
    #: the device for a call without the readback
    out: torch.Tensor
    done: object
    codes: torch.Tensor     # [B_total] i8 per-ray codes, natural order
    counts: object          # [B_total] i32 micro-step counts (reorder)
    n_image: int
    #: the graph whose static buffers these are, until the call is
    #: finalized (None for a call run from Python)
    graph: object = None


def _source_beam(problem):
    """The beam whose grids give the rays: the seed beam of a seeded
    problem, the EUV beam otherwise."""
    return problem.seed_beam if problem.seed is not None else problem.euv_beam


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


def _readback(out: torch.Tensor, dev):
    """Start the copy of ``out`` to page-locked host memory on the current
    stream of ``dev``; returns ``(host, event)`` (``out`` itself and None
    on the CPU). The event is recorded on ``dev``, whichever device is
    current: it completes only after the copy."""
    if dev.type != "cuda":
        return out, None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    return host, done


class _Tables(NamedTuple):
    """A call's tables on its device."""

    gain: DeviceGain
    beam: object            # DeviceBeam
    grids: list             # source grids x, y, a, b as f32
    entry_seed: object      # EntrySeedTables, or None without a seed
    fv: torch.Tensor        # [K] f64 frequency profile (ones without)


def _tables(cfg: dict, buf: torch.Tensor) -> _Tables:
    """Copy the packed tables ``buf`` to the call's device in one transfer
    (asynchronous from page-locked memory) on its current stream, and form
    the entry seed's factor tables there."""
    dev, K = cfg["device"], cfg["K"]
    dbuf = buf.to(dev, non_blocking=True)
    t = unpack_arrays(dbuf, cfg["pack_layout"])

    def part(prefix):
        return {k[len(prefix):]: v for k, v in t.items()
                if k.startswith(prefix)}

    grids = [t[f"grid.{axis}"] for axis in "xyab"]
    entry_seed = None
    fv = torch.ones(K, dtype=torch.float64, device=dev)
    if cfg["seed_scalars"] is not None:
        entry_seed = seed_ops.make_entry_seed_tables(
            seed_from_tensors(part("seed."), cfg["seed_scalars"]), grids, K)
        fv = entry_seed.fv
    return _Tables(gain=DeviceGain(**part("gain.")),
                   beam=beam_from_tensors(part("beam."), cfg["beam_scalars"]),
                   grids=grids, entry_seed=entry_seed, fv=fv)


def _dispatch_steps(cfg: dict, buf: torch.Tensor, prev=None):
    """One call of ``cfg`` run from Python, as a generator that yields
    after each chunk's launches and returns the :class:`_Call` with its
    output on the device (``StopIteration.value``). The first step uploads
    the packed tables ``buf`` and enqueues the first chunk; the last the
    failure flags. ``prev`` (where ``cfg["reorder"]``): the previous call's
    counts, the reorder's sort key. Every step's work goes to the current
    stream of the device, so a caller that interleaves the steps of several
    calls makes each one's device and stream current around each step.
    Nothing here waits for the device: a CUDA graph captures it."""
    dev, method, N, K = cfg["device"], cfg["method"], cfg["N"], cfg["K"]
    dims, use_emis = cfg["dims"], cfg["use_emis"]
    sdtype = cfg["spectrum_dtype"]
    if cfg["name"] == "cuda":
        trace, gain_only, deposit = (trace_kernel.trace_batch,
                                     amplify_kernel.amplify_gain,
                                     deposit_kernel.bin_deposit)
    else:
        trace, gain_only, deposit = (stepper.trace_batch_plain,
                                     amplify_kernel.amplify_gain_plain,
                                     deposit_kernel.bin_deposit_plain)

    # one upload of the problem tables per call
    tables = _tables(cfg, buf)
    gain, dbeam, grids = tables.gain, tables.beam, tables.grids
    entry_seed, fv = tables.entry_seed, tables.fv
    gv = gain.gv[1:]
    f64 = dict(dtype=torch.float64, device=dev)

    B_total, chunk = cfg["B_total"], cfg["chunk"]
    map_it = make_stride_mapper(dims, cfg["N_start"], cfg["N_parallel"])
    counts = None
    if cfg["reorder"]:
        counts = torch.zeros(B_total, dtype=torch.int32, device=dev)
        row = cfg["reorder_row"]

    image = torch.zeros((dbeam.x.shape[0] * dbeam.y.shape[0], K), **f64)
    i_ang = torch.zeros((dbeam.a.shape[0] * dbeam.b.shape[0], 1), **f64)
    codes = torch.zeros(B_total, dtype=torch.int8, device=dev)
    for start in range(0, B_total, chunk):
        n = min(chunk, B_total - start)
        it = torch.arange(start, start + n, dtype=torch.int64, device=dev)
        perm = None
        if counts is not None:
            perm = reorder_perm(row, dims, prev[start:start + n],
                                map_it(it)[0], grids[1])
            it = start + perm
        ijkm, valid = map_it(it)
        i, j, k, m = _unflatten_rays(ijkm, dims)
        rays = {"x": grids[0][i], "y": grids[1][j], "a": grids[2][k],
                "b": grids[3][m]}
        if perm is None:
            res = trace(rays, N, cfg["dz"], gain, method, cfg["c"], use_emis)
        else:
            res, cnt = trace(rays, N, cfg["dz"], gain, method, cfg["c"],
                             use_emis, counts=True)
            # back to natural order: the next call's sort key
            counts.narrow(0, start, n).index_copy_(0, perm, cnt)
        if use_emis:
            Iv = spectrum.amplify(
                res, torch.zeros((n, K), dtype=sdtype, device=dev), gv, N,
                dtype=sdtype)
            flags = amplify_kernel.iv_flags(Iv)
        else:
            # the entry seed in factor form; B3 forms f * fv, masks the
            # escaped rays and flags the bad spectra
            f = (torch.zeros(n, **f64) if entry_seed is None else
                 seed_ops.seed_factor(entry_seed, i, j, k, m))
            Iv, flags = gain_only(f, fv, res.escaped, res.ivl, res.gvl, gv,
                                  dtype=sdtype)
        code = torch.where(res.perp, -1, torch.where(
            (flags & amplify_kernel.FLAG_NEG) != 0, -2,
            torch.where((flags & amplify_kernel.FLAG_NAN) != 0, -3, 0)))
        code = torch.where(valid, code, 0).to(torch.int8)
        binning.bin_images(Iv, res, rays, dbeam, method, cfg["scale"],
                           valid & (code == 0), image, i_ang, deposit)
        if perm is None:
            codes[start:start + n] = code
        else:
            # natural order, so the failure path names the physical ray
            codes.narrow(0, start, n).index_copy_(0, perm, code)
        yield

    # a flag per failure code (-1, -2, -3), on the device; flags add up
    # across the shards and ranks of a sharded call, and one readback
    # carries them
    flags = torch.stack([torch.any(codes == -err) for err in (1, 2, 3)])
    out = torch.cat([image.reshape(-1), i_ang.reshape(-1),
                     flags.to(torch.float64)])
    return _Call(out=out, done=None, codes=codes, counts=counts,
                 n_image=image.numel())


def _drain(steps):
    """Run a generator of steps to its end; its return value."""
    while True:
        try:
            next(steps)
        except StopIteration as stop:
            return stop.value


def _dispatch(problem, name, dev, chunk_size=None, c=0.5, readback=True,
              prev=None, spectrum_dtype=torch.float64) -> _Call:
    """One call of ``problem`` run from Python, also on a CUDA device (the
    reference the graphs are held against); with ``prev``, the reorder
    sorted by it. Nothing here waits for the device."""
    prep = _prepare(problem, name, dev, chunk_size, c,
                    reorder=prev is not None, readback=readback, eager=True,
                    spectrum_dtype=spectrum_dtype)
    return prep.pipeline(*prep.operands,
                         *(() if prev is None else (prev,)))


class _EagerPipeline:
    """The pipeline of a config run from Python: the plain twins (on the
    CPU or on a card), and the kernels when asked (``eager``)."""

    def __init__(self, cfg: dict):
        self.cfg = cfg

    def steps(self, buf, prev=None):
        """The call as steps, one a chunk (:func:`_dispatch_steps`), then
        the start of the readback."""
        call = yield from _dispatch_steps(self.cfg, buf, prev)
        if self.cfg["readback"]:
            out, done = _readback(call.out, self.cfg["device"])
            call = call._replace(out=out, done=done)
        return call

    def __call__(self, buf, prev=None) -> _Call:
        with cuda_lib.device_guard(self.cfg["device"]):
            return _drain(self.steps(buf, prev))


#: kernel launches per call are counted per wrapper: the modules by the
#: names of ``cfg["launches"]``, and the f32 instantiations' own counters
_WRAPPERS = {"trace": trace_kernel, "bin_deposit": deposit_kernel,
             "amplify": amplify_kernel, "bin_deposit_f32": deposit_kernel.F32,
             "amplify_f32": amplify_kernel.F32}


def _launch_counts() -> dict:
    return {n: (w.launch_count, dict(w.device_launches))
            for n, w in _WRAPPERS.items()}


def _credit(launches: dict, dev) -> None:
    """A graph replay launches the kernels it captured: add them to their
    wrappers' counts, as the launches themselves would."""
    for n, k in launches.items():
        if k:
            w = _WRAPPERS[n]
            w.launch_count += k
            w.device_launches[dev] = w.device_launches.get(dev, 0) + k


#: a side stream per card to capture on when the caller's current stream
#: is the card's default stream (CUDA captures on no default stream)
_CAPTURE_STREAMS: dict = {}


class _Graph:
    """One captured CUDA graph of a config's call, with what it keeps:
    its page-locked staging buffer (the tables a replay uploads) and host
    output, its reorder input ``prev``, the pair of B1 refill counters its
    launches use, and its outputs (static: each replay overwrites them, so
    a graph runs one call at a time, ``in_flight`` until finalized).

    Built on the first call that finds every graph of its config in
    flight: one eager warm-up call of the config on the same buffers
    (builds and loads the kernels, caches B1's occupancy query, so that no
    such call happens during the capture), whose cached blocks then go
    back to the card, then the capture of :func:`_dispatch_steps` and the
    readback on the caller's current stream (or a side stream), without
    waiting for any of it; the capture and replay raise on failure.
    ``pool_bytes``: the growth of the card's reservation over the capture,
    the graph's private pool (the warm-up's blocks released before it, so
    that they are not cached beside the pool)."""

    def __init__(self, cfg: dict, buf: torch.Tensor):
        dev = cfg["device"]
        self.cfg, self.in_flight = cfg, False
        t0 = time.perf_counter()
        self.staging = torch.empty(buf.shape, dtype=buf.dtype,
                                   pin_memory=True)
        self.staging.copy_(buf)
        self.ctr = torch.zeros(2, dtype=torch.int64, device=dev)
        self.prev = (torch.zeros(cfg["B_total"], dtype=torch.int32,
                                 device=dev) if cfg["reorder"] else None)
        self.host = (torch.empty(cfg["n_out"], dtype=torch.float64,
                                 pin_memory=True) if cfg["readback"] else None)
        with cuda_lib.device_guard(dev), \
                trace_kernel.own_counters(self.ctr):
            _drain(_dispatch_steps(cfg, self.staging, self.prev))
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            # the warm-up's outputs are dropped; its blocks, idle on every
            # stream of the card after the sync, go back to the card
            torch.cuda.empty_cache()
            stream = torch.cuda.current_stream(dev)
            if stream == torch.cuda.default_stream(dev):
                stream = _CAPTURE_STREAMS.setdefault(dev,
                                                     torch.cuda.Stream(dev))
            reserved = torch.cuda.memory_reserved(dev)
            before = _launch_counts()
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            try:
                with torch.cuda.stream(stream):
                    self.graph.capture_begin()
                    try:
                        call = _drain(_dispatch_steps(cfg, self.staging,
                                                      self.prev))
                        if self.host is not None:
                            self.host.copy_(call.out, non_blocking=True)
                    except BaseException:
                        try:
                            self.graph.capture_end()
                        except RuntimeError:
                            pass  # the capture's own error is the one
                        raise
                    self.graph.capture_end()
            finally:
                captured = {n: w.launch_count - before[n][0]
                            for n, w in _WRAPPERS.items()}
                for n, w in _WRAPPERS.items():
                    w.launch_count = before[n][0]
                    w.device_launches.clear()
                    w.device_launches.update(before[n][1])
            self.nodes = cuda_lib.graph_nodes(self.graph.raw_cuda_graph())
            self.graph.instantiate()
        if captured != cfg["launches"]:
            raise RuntimeError(f"graph capture: launches {captured}, the "
                               f"call makes {cfg['launches']}")
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.warmup_s, self.capture_s = t1 - t0, time.perf_counter() - t1
        self.call = call._replace(out=call.out if self.host is None
                                  else self.host)

    def replay(self, buf, prev=None) -> _Call:
        """Copy ``buf`` into the staging buffer and ``prev`` into the
        graph's reorder input, replay the graph on the current stream of
        its card, and record the ``done`` event there."""
        cfg = self.cfg
        dev = cfg["device"]
        self.staging.copy_(buf)
        done = None
        with cuda_lib.device_guard(dev):
            if self.prev is not None:
                if prev is None:
                    self.prev.zero_()
                else:
                    self.prev.copy_(prev, non_blocking=True)
            self.graph.replay()
            if self.host is not None:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
        self.in_flight = True
        _credit(cfg["launches"], dev)
        return self.call._replace(done=done, graph=self)


class _GraphPipeline:
    """The pipeline of a config with the kernels on a CUDA device: its
    captured graphs, one per call in flight. A call replays a graph that
    is not in flight, captured anew when there is none."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.graphs: list = []

    def steps(self, buf, prev=None):
        """The call as one step: the replay."""
        return self(buf, prev)
        yield  # a generator of no steps before its return

    def __call__(self, buf, prev=None) -> _Call:
        graph = next((g for g in self.graphs if not g.in_flight), None)
        if graph is None:
            graph = _Graph(self.cfg, buf)
            self.graphs.append(graph)
            _evict(self.cfg["device"], self)
        return graph.replay(buf, prev)


def _release(call: _Call) -> None:
    """The call is finalized: its graph may run again."""
    if call.graph is not None:
        call.graph.in_flight = False


def _discard(call: _Call) -> None:
    """Drop a dispatched call without reading it: wait for it, release its
    graph."""
    if call.done is not None:
        call.done.synchronize()
    _release(call)


#: process-wide cache of pipelines, least recently used first, keyed by
#: the whole ``cfg`` but its launch counts: everything that fixes a call's
#: shapes, launch parameters and the host scalars it bakes in, but no
#: table contents
_PIPELINE_CACHE: OrderedDict = OrderedDict()
#: configs the cache keeps at most
MAX_PIPELINES = 64
#: the share of a card's memory that the cached graphs' pools may hold
#: (20 GiB of an 80 GB H100); past it, the graphs of the least recently
#: used configs that are not in flight are dropped. A pool is all that the
#: card reserves for its graph, so this bounds the cache's reservation
GRAPH_POOL_SHARE = 0.25


def _pipeline(cfg: dict):
    """The cached pipeline of ``cfg``, made on its first use."""
    key = tuple((k, v) for k, v in cfg.items() if k != "launches")
    pipe = _PIPELINE_CACHE.get(key)
    if pipe is None:
        pipe = (_GraphPipeline if cfg["graph"] else _EagerPipeline)(cfg)
        _PIPELINE_CACHE[key] = pipe
        while len(_PIPELINE_CACHE) > MAX_PIPELINES:
            # a graph in flight stays alive through its call
            _PIPELINE_CACHE.popitem(last=False)
    _PIPELINE_CACHE.move_to_end(key)
    return pipe


def _graph_pipelines(dev) -> list:
    """The cached graph pipelines of card ``dev``, least recently used
    first."""
    dev = _card(dev)
    return [p for p in _PIPELINE_CACHE.values()
            if isinstance(p, _GraphPipeline) and p.cfg["device"] == dev]


def graph_pool_bytes(dev) -> int:
    """The bytes the pools of the graphs cached on card ``dev`` hold: what
    the card reserves for the cache (``memory_reserved`` less this is what
    the rest of the process reserves there)."""
    return sum(g.pool_bytes for p in _graph_pipelines(dev) for g in p.graphs)


def _evict(dev, keep: _GraphPipeline) -> None:
    """Drop the graphs not in flight of the least recently used configs on
    ``dev`` (never ``keep``'s) until the graphs' pools there hold at most
    :data:`GRAPH_POOL_SHARE` of the card's memory, and return the dropped
    pools to the card."""
    pipes = _graph_pipelines(dev)
    held = sum(g.pool_bytes for p in pipes for g in p.graphs)
    limit = GRAPH_POOL_SHARE * torch.cuda.get_device_properties(dev) \
        .total_memory
    dropped = False
    for p in pipes:
        if held <= limit:
            break
        if p is keep:
            continue
        held -= sum(g.pool_bytes for g in p.graphs if not g.in_flight)
        p.graphs = [g for g in p.graphs if g.in_flight]
        dropped = True
    if dropped:
        torch.cuda.empty_cache()


def clear_pipeline_cache() -> None:
    """Drop every cached pipeline (graphs in flight stay alive through
    their calls) and return the cached device memory."""
    _PIPELINE_CACHE.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


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


def failed_rays(problem: CreateImageProblem, codes) -> np.ndarray:
    """The flat source-grid indices of a call's failed rays, ascending,
    from its per-ray ``codes`` (read back here)."""
    its = np.nonzero(codes.cpu().numpy() < 0)[0]
    return problem.N_start + its.astype(np.int64) * problem.N_parallel


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
