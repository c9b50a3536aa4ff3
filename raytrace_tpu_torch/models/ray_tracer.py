"""``create_image``: ray-list generation, method dispatch, chunked
execution, failure handling.

Rebuild of ``RayTrace::create_image`` (src/RayTraceImage.cpp:227-434) on
PyTorch, following ``raytrace_tpu.models.ray_tracer``:

* limits and uniform euv/seed grid checks (RayTraceImage.cpp:229-264);
* method 1 (backward, ASE) or 2 (forward, seeded), scale and ray dims;
* the N_start/N_parallel stride contract (RayTraceImage.cpp:300-328);
* per chunk: entry rays -> trace -> entry seed -> f64 amplify -> deposit
  into the call's f64 image and I_ang accumulators;
* per-ray failure codes -1/-2/-3 -> bitmask -> failed-ray dump -> abort
  (RayTraceImage.cpp:427-430).

Methods: ``cuda`` runs the hand-written kernels (trace B1, deposit B2) on a
CUDA device; ``cpu`` runs their plain PyTorch twins (on the CPU unless a
``device`` is given -- a CUDA device then runs the twins on the card, which
is how the kernels are checked end to end). The reference's method names
map onto these two (``_METHOD_ALIASES``).

The problem tables are copied to the device once per call, inside the timed
region: the reference re-uploads per call because production gain tables
change every iteration (Readme.txt:43).
"""

from __future__ import annotations

import numpy as np
import torch

from raytrace_tpu_torch.models.problem import (prepare_beam, prepare_gain,
                                               prepare_seed)
from raytrace_tpu_torch.ops import (binning, deposit_kernel, seed as seed_ops,
                                    spectrum, stepper, trace_kernel)
from raytrace_tpu_torch.structures import CreateImageProblem
from raytrace_tpu_torch.utils import errors as err_util
from raytrace_tpu_torch.utils.timer import profiler

__all__ = ["create_image", "resolve_method", "make_stride_mapper",
           "generate_ray_indices", "available_methods", "N_MAX", "K_MAX",
           "METHODS"]

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
        method, src, scale, timer_name = _validate(problem)
        timer_name += "-" + name
        profiler.start(timer_name)
        try:
            image, i_ang, codes = _run(problem, name, dev, method, src,
                                       scale, chunk_size, c)
            return _finalize(problem, method, src, image, i_ang, codes,
                             failed_ray_path)
        finally:
            profiler.stop(timer_name, dev)
    finally:
        profiler.stop("create_image", dev)


def _run(problem, name, dev, method, src, scale, chunk_size, c):
    """Upload the tables, run every chunk, return the device accumulators
    (image [nx*ny, K], I_ang [na*nb, 1]) and the per-ray codes."""
    beam = problem.euv_beam
    K = beam.nv
    N = problem.N
    use_emis = problem.gain[0].E0 is not None and problem.seed is None
    dims = (src.nx, src.ny, src.na, src.nb)
    if name == "cuda":
        trace, deposit = trace_kernel.trace_batch, deposit_kernel.deposit
    else:
        trace, deposit = stepper.trace_batch_plain, deposit_kernel.deposit_plain

    # one upload of the problem tables per call
    gain = prepare_gain(problem.gain, dev)
    gv = gain.gv[1:]
    dbeam = prepare_beam(beam, dev)
    grids = [torch.as_tensor(np.asarray(g, np.float64), device=dev)
             .to(torch.float32) for g in (src.x, src.y, src.a, src.b)]
    entry_seed = None
    if problem.seed is not None:
        entry_seed = seed_ops.make_entry_seed_tables(
            prepare_seed(problem.seed, dev), (src.x, src.y, src.a, src.b), K)

    Nt = dims[0] * dims[1] * dims[2] * dims[3]
    skip = problem.N_parallel
    B_total = (len(range(problem.N_start, Nt, skip))
               if problem.N_start < Nt else 0)
    chunk = max(1, min(chunk_size or DEFAULT_CHUNK[name], max(B_total, 1)))
    map_it = make_stride_mapper(dims, problem.N_start, skip)

    image = torch.zeros((beam.nx * beam.ny, K), dtype=torch.float64,
                        device=dev)
    i_ang = torch.zeros((beam.na * beam.nb, 1), dtype=torch.float64,
                        device=dev)
    codes = []
    for start in range(0, B_total, chunk):
        it = torch.arange(start, min(start + chunk, B_total),
                          dtype=torch.int64, device=dev)
        ijkm, valid = map_it(it)
        i, j, k, m = _unflatten_rays(ijkm, dims)
        rays = {"x": grids[0][i], "y": grids[1][j], "a": grids[2][k],
                "b": grids[3][m]}
        res = trace(rays, N, beam.dz, gain, method, c, use_emis)
        if entry_seed is None:
            Iv0 = torch.zeros((it.shape[0], K), dtype=torch.float64,
                              device=dev)
        else:
            Iv0 = seed_ops.calc_seed_entry(entry_seed, i, j, k, m, K)
            Iv0 = torch.where(res.escaped[:, None], 0.0, Iv0)
        Iv = spectrum.amplify(res, Iv0, gv, N, use_emis)
        neg = torch.any(Iv < 0.0, dim=1)
        nan = torch.any(Iv != Iv, dim=1)
        code = torch.where(res.perp, -1, torch.where(
            neg, -2, torch.where(nan, -3, 0)))
        code = torch.where(valid, code, 0).to(torch.int8)
        binning.bin_images(Iv, res, rays, dbeam, method, scale,
                           valid & (code == 0), image, i_ang, deposit)
        codes.append(code)
    codes = (torch.cat(codes) if codes
             else torch.zeros(0, dtype=torch.int8, device=dev))
    return image, i_ang, codes


def _finalize(problem, method, src, image, i_ang, codes, failed_ray_path):
    """Readback, failure path (RayTraceImage.cpp:427-430), reference
    layout, store on the problem."""
    beam = problem.euv_beam
    codes = codes.cpu().numpy()
    fail_bits = 0
    for code in (-1, -2, -3):
        if np.any(codes == code):
            fail_bits = err_util.set_bit(-code, fail_bits)
    if fail_bits:
        dims = (src.nx, src.ny, src.na, src.nb)
        failed = []
        for it in np.nonzero(codes < 0)[0][: err_util.N_FAILED_MAX]:
            gidx = problem.N_start + int(it) * problem.N_parallel
            gi, gj, gk, gm = _unflatten_rays(gidx, dims)
            failed.append(np.array(
                [src.x[gi], src.y[gj], src.a[gk], src.b[gm]], np.float32))
        for msg in err_util.failure_messages(fail_bits):
            print(msg)
        err_util.write_failures(failed_ray_path, fail_bits, np.array(failed),
                                method, problem.N, beam.dz, problem.gain)
        raise err_util.RayTraceError("Some rays failed")
    image_np = image.cpu().numpy().reshape(-1)
    i_ang_np = i_ang.cpu().numpy().reshape(-1)
    problem.image = image_np
    problem.I_ang = i_ang_np
    return image_np, i_ang_np

