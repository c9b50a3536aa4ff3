"""Synthetic problem generation and stream timing for tests and
shipped-shape runs.

Builds physically-sane random ``create_image`` work units shaped like the
production snapshots (plasma gain column, half-plane y symmetry, optional
separable seed). :func:`synthetic_problem` is a bit-identical copy of
``raytrace_tpu.testing.synthetic_problem``, so both packages see the same
work unit for the same arguments. :func:`perturbed_problems` and the
stream timers follow ``raytrace_tpu.testing``. :func:`oracle_images` is the
brute-force reference deposit through the scalar oracle that the tests and
the fuzz tool (``raytrace_tpu_torch.tools.fuzz_oracle``) gate against.
"""

from __future__ import annotations

import time

import numpy as np

from raytrace_tpu_torch.io.loader import load_input, scale_problem
from raytrace_tpu_torch.ops import oracle
from raytrace_tpu_torch.structures import (
    CreateImageProblem, EUVBeam, RayGain, RaySeed, SeedBeam,
)

__all__ = ["synthetic_problem", "perturbed_problems", "time_stream_rounds",
           "time_stream_detailed", "amplify_inputs", "source_rays",
           "seed_factors", "deposit_inputs", "physical_gain", "oracle_images",
           "ASE_SHAPE", "SEED_SHAPE"]

#: ``synthetic_problem`` arguments of the two shipped shapes: the widths of
#: ``ASE_small.dat`` (399,000 rays, nv 52, method 1) and of
#: ``seed_small.dat`` (7,803,000 rays, nv 82, method 2) with synthetic tables
ASE_SHAPE = dict(nx=60, ny=25, na=19, nb=14, nv=52, N=3, gain_nx=106,
                 gain_ny=26)
SEED_SHAPE = dict(nx=118, ny=25, na=50, nb=50, nv=82, N=3, seeded=True,
                  seed_dim=251, gain_nx=106, gain_ny=26)


def source_rays(p, n=None, device="cpu"):
    """The first ``n`` rays (all by default) of the work unit in natural
    (b-fastest) order, as the port's chunks enumerate them: f32 ``x, y, a,
    b`` [n] on ``device``."""
    import torch

    from raytrace_tpu_torch.models.ray_tracer import _unflatten_rays

    src = p.seed_beam if p.seed is not None else p.euv_beam
    total = src.nx * src.ny * src.na * src.nb
    ijkm = torch.arange(min(n or total, total), device=device)
    i, j, k, m = _unflatten_rays(ijkm, (src.nx, src.ny, src.na, src.nb))
    grids = [torch.as_tensor(np.asarray(g, np.float64), device=device)
             .float() for g in (src.x, src.y, src.a, src.b)]
    return {"x": grids[0][i], "y": grids[1][j], "a": grids[2][k],
            "b": grids[3][m]}


def seed_factors(p, n=None, device="cpu"):
    """Kernel B3's seed inputs for the first ``n`` rays of a seeded work
    unit in natural order, as ``create_image`` forms them: ``(f [n] f64,
    fv [K] f64)`` on ``device``."""
    import torch

    from raytrace_tpu_torch.models.problem import (seed_arrays,
                                                   seed_from_tensors)
    from raytrace_tpu_torch.models.ray_tracer import _unflatten_rays
    from raytrace_tpu_torch.ops import seed as seed_ops

    src = p.seed_beam
    dims = (src.nx, src.ny, src.na, src.nb)
    total = dims[0] * dims[1] * dims[2] * dims[3]
    grids = [torch.as_tensor(np.asarray(g, np.float64), device=device)
             .float() for g in (src.x, src.y, src.a, src.b)]
    dseed = seed_from_tensors({k: torch.as_tensor(v, device=device)
                               for k, v in seed_arrays(p.seed).items()},
                              p.seed)
    tabs = seed_ops.make_entry_seed_tables(dseed, grids, p.euv_beam.nv)
    ijkm = torch.arange(min(n or total, total), device=device)
    return (seed_ops.seed_factor(tabs, *_unflatten_rays(ijkm, dims)),
            tabs.fv.contiguous())


def amplify_inputs(B=1024, nseg=2, nsub=3, cells=2756, K=82, seed=0,
                   spread=None):
    """Trace-shaped inputs of the gain-only amplify as numpy arrays
    ``(ivl [B, nseg, nsub] i32, gvl f32, gv [nseg, cells, K] f32)``, at the
    seeded shipped widths by default: random cell ids, or with ``spread``
    ids clustered per 256-ray block (coherent rays), as
    tests/test_pallas_amplify.py makes them."""
    rng = np.random.default_rng(seed)
    if spread is None:
        ivl = rng.integers(0, cells, size=(B, nseg, nsub)).astype(np.int32)
    else:
        ivl = np.empty((B, nseg, nsub), np.int32)
        for b0 in range(0, B, 256):
            c0 = int(rng.integers(0, cells))
            ivl[b0:b0 + 256] = np.clip(
                c0 + rng.integers(-spread, spread,
                                  size=(len(ivl[b0:b0 + 256]), nseg, nsub)),
                0, cells - 1)
    gvl = (rng.standard_normal((B, nseg, nsub)) * 0.1).astype(np.float32)
    gv = (rng.standard_normal((nseg, cells, K)) * 0.5).astype(np.float32)
    return ivl, gvl, gv


def deposit_inputs(beam, B, seed=0, nan_share=0.01):
    """Binning deposit inputs on an EUV beam's grids as numpy arrays
    ``(Iv [B, K] f64, (x, y, a, b) [B] f32 each, ok [B] bool)``.

    Each coordinate is drawn over the half-cell-padded grid and beyond, or
    over its negation (what method 2's mirror and negated angles map back),
    or is a grid point or a half-cell edge; ``nan_share`` of them are NaN
    (get_index puts NaN in the last interval, as the reference's bisection
    does; ``raytrace_tpu``'s count puts it in the first). Consecutive
    rays repeat one draw for a run of 1 to 40 rays, as entry rays
    repeat their cell. About one ray in ten is not ok and carries a NaN or
    negative spectrum; the rest positive ones."""
    rng = np.random.default_rng(seed)
    starts = np.cumsum(rng.integers(1, 41, B))
    draw = np.searchsorted(starts, np.arange(B), side="right")
    n = int(draw[-1]) + 1 if B else 0
    coords = []
    for g, d in ((beam.x, beam.dx), (beam.y, beam.dy), (beam.a, beam.da),
                 (beam.b, beam.db)):
        g = np.asarray(g, np.float64)
        span = rng.uniform(g[0] - d, g[-1] + d, n)
        span = np.where(rng.random(n) < 0.5, span, -span)
        edges = np.concatenate([g, g - 0.5 * d, g + 0.5 * d])
        on_grid = edges[rng.integers(0, len(edges), n)]
        c = np.where(rng.random(n) < 0.2, on_grid, span)
        c[rng.random(n) < nan_share] = np.nan
        coords.append(c.astype(np.float32)[draw])
    K = beam.nv
    Iv = rng.uniform(0.1, 2.0, (B, K))
    ok = rng.random(B) > 0.1
    bad = np.where(rng.random((B, 1)) < 0.5, np.nan, -1.0)
    Iv = np.where(ok[:, None], Iv, bad * Iv)
    return Iv, tuple(coords), ok


def perturbed_problems(source, n, salt=0, scale=None):
    """``n`` fresh work units, each with its gain ``g0`` tables scaled by a
    distinct factor ``1 + 1e-5*(salt*n + i + 1)``.

    ``source`` is a ``.dat`` snapshot path, or a callable that returns a
    fresh problem (``functools.partial(synthetic_problem, ...)``).
    Production changes the gain tables every iteration (Readme.txt:43), so
    a serving stream is timed over distinct tables; vary ``salt`` across
    timing rounds so factors never repeat within a process.
    """
    probs = []
    for i in range(n):
        p = source() if callable(source) else load_input(source)[0]
        if scale is not None and scale != 1.0:
            scale_problem(p, scale)
        f = np.float32(1.0 + 1e-5 * (salt * n + i + 1))
        for g in p.gain:
            g.g0 = (np.asarray(g.g0, np.float32) * f).astype(np.float32)
        probs.append(p)
    return probs


def time_stream_rounds(source, n_units, rounds, consume, salt0=0,
                       scale=None):
    """Per-call seconds of a serving-mode stream over fresh work units:
    each round builds ``n_units`` units with :func:`perturbed_problems`,
    ``consume(units)`` drains the stream, and the round's wall time is
    divided by the unit count. One entry per round."""
    def make_stream(units):
        def gen():
            consume(units)
            yield None  # one mark at the drain's end: the round wall only
        return gen()

    per_call, _ = time_stream_detailed(source, n_units, rounds, make_stream,
                                       salt0=salt0, scale=scale)
    return per_call


def time_stream_detailed(source, n_units, rounds, make_stream, salt0=0,
                         scale=None):
    """Per-yield wall times of a serving-mode stream.

    ``make_stream(units)`` returns the stream iterator; every yield is
    timestamped. Returns ``(per_call, rounds_detail)``: ``per_call`` is the
    per-round round_wall / n_units, and each ``rounds_detail`` entry is
    ``{"round_wall_s", "fill_s" (first-yield latency: call 0's upload,
    compute and readback with nothing to overlap), "yield_s" (spacing of
    the later yields, the steady-state statistic)}``.

    Raises ``ValueError`` for ``n_units < 1`` or a stream that yields
    nothing.
    """
    if n_units < 1:
        raise ValueError(f"time_stream_detailed: n_units must be >= 1, got "
                         f"{n_units}")
    per_call, detail = [], []
    for r in range(rounds):
        units = perturbed_problems(source, n_units, salt=salt0 + r,
                                   scale=scale)
        t0 = time.perf_counter()
        marks = [time.perf_counter() for _ in make_stream(units)]
        if not marks:
            raise ValueError("time_stream_detailed: the stream yielded "
                             "nothing")
        wall = marks[-1] - t0
        per_call.append(wall / len(units))
        detail.append({
            "round_wall_s": wall,
            "fill_s": marks[0] - t0,
            "yield_s": [b - a for a, b in zip(marks, marks[1:])],
        })
    return per_call, detail


def physical_gain(p: CreateImageProblem) -> CreateImageProblem:
    """Scale ``p``'s gain to the saturated X-ray-laser regime for long
    (N > ~5) paths, in place: g0 times 0.25 in f32, a total exponent of
    ~14 instead of ~57 (``raytrace_tpu.testing.physical_gain``, bit for
    bit). The fuzz gates compare problems scaled in different code paths
    and depend on the copies being bitwise identical."""
    for g in p.gain:
        g.g0 = (np.asarray(g.g0) * np.float32(0.25)).astype(np.float32)
    return p


def oracle_images(p: CreateImageProblem, method: int):
    """Brute-force reference deposit via the scalar oracle, on the host:
    trace every ray with ``ops.oracle.calc_ray`` and bin like the reference
    kernel (RayTraceImageCuda.cu:84-125 semantics -- method 1 bins at entry
    coords, method 2 at the negated exit angles with the y mirror).

    Returns ``(image, i_ang)`` as float64 arrays, or ``(None, None)`` if
    any ray hits the failure path (the caller decides whether that is a
    skip or an assertion failure). ``raytrace_tpu.testing.oracle_images``
    step for step, so both packages' results agree bitwise.
    """
    b = p.euv_beam
    src = p.seed_beam if method == 2 else b
    scale = 1.0 if method == 1 else (
        (src.dx * src.dy * src.da * src.db) / (b.dx * b.dy))
    image = np.zeros(b.nx * b.ny * b.nv)
    i_ang = np.zeros(b.na * b.nb)

    def get_index(grid, d, y):
        if y < grid[0] - 0.5 * d or y > grid[-1] + 0.5 * d:
            return -1
        return oracle.find_first_single(grid, y - 0.5 * d)

    for i in range(src.nx):
        for j in range(src.ny):
            for k in range(src.na):
                for m in range(src.nb):
                    ray = (np.float32(src.x[i]), np.float32(src.y[j]),
                           np.float32(src.a[k]), np.float32(src.b[m]))
                    res = oracle.calc_ray(
                        ray, p.N, b.dz, p.gain,
                        p.seed if method == 2 else None, b.nv, method)
                    if res.error != 0:
                        return None, None  # failure-path config
                    if method == 1:
                        bx, by, ba, bb_ = ray
                    else:
                        bx, by = res.ray_out[0], res.ray_out[1]
                        ba, bb_ = -res.ray_out[2], -res.ray_out[3]
                        if by < 0 and b.y[0] >= 0:
                            by = -by
                    i1 = get_index(b.x, b.dx, bx)
                    i2 = get_index(b.y, b.dy, by)
                    i3 = get_index(b.a, b.da, ba)
                    i4 = get_index(b.b, b.db, bb_)
                    if i1 >= 0 and i2 >= 0:
                        base = b.nv * (i1 + i2 * b.nx)
                        image[base:base + b.nv] += res.Iv * scale
                    if i3 >= 0 and i4 >= 0:
                        i_ang[i3 + i4 * b.na] += float(
                            np.sum(2.0 * b.dv * res.Iv))
    return image, i_ang


def _uniform_grid(lo, hi, n):
    d = (hi - lo) / n
    return lo + (0.5 + np.arange(n)) * d, d


def synthetic_problem(nx=8, ny=5, na=5, nb=4, nv=6, N=3, seeded=False,
                      seed_dim=21, rng=None, non_uniform_gain=False,
                      refraction_free=False,
                      full_plane=False, gain_nx=30,
                      gain_ny=12) -> CreateImageProblem:
    """A miniature ASE or seeded work unit with smooth random gain tables.

    ``refraction_free``: constant index of refraction (n = 1 everywhere, so
    dn/dx = dn/dy = 0). Rays travel in straight lines, which makes every
    implementation's micro-step sequence geometry-determined and identical
    -- the lockstep-parity regime (tests/test_stepper.py) where per-ray
    results must agree to float32 accumulation error, with no trajectory
    chaos to hide a half-cell indexing bug. The gain tables stay nonzero so
    the cell walk, bilinear gain interpolation, and path integrals are all
    still exercised.

    ``full_plane``: grids span negative y too (the reference's abs_y mirror
    is OFF: RayTraceImageHelper.h:325-336 only mirrors when y[0] >= 0), so
    the non-mirrored index/gradient/binning paths get exercised.
    """
    rng = np.random.default_rng(rng)
    p = CreateImageProblem()
    p.N = N
    p.N_start = 0
    p.N_parallel = 1

    beam = EUVBeam()
    beam.run_ASE, beam.run_sat, beam.run_refract = True, True, True
    beam.lam = 1.7e-6
    # A is compared by operator== but never serialized by the reference's
    # euv pack (RayTraceStructures.cpp:441-506), so keep it at the default
    beam.A = 0.0
    beam.Nc = 3.8e24
    beam.R_scale = beam.G_scale = -1.0
    beam.x, beam.dx = _uniform_grid(1e-4, 6e-3, nx)
    if full_plane:
        beam.y, beam.dy = _uniform_grid(-2.4e-3, 2.4e-3, ny)
    else:
        beam.y, beam.dy = _uniform_grid(0.0, 2.4e-3, ny)
    beam.a, beam.da = _uniform_grid(-10.0, 8.0, na)
    beam.b, beam.db = _uniform_grid(-9.0, 5.0, nb)
    beam.z = np.linspace(0.0, 0.05 * (N - 1), max(N, 2))
    beam.dz = 0.05
    v0 = 1.76e16
    beam.v, dv0 = _uniform_grid(v0 * 0.99998, v0 * 1.00002, nv)
    beam.dv = np.full(nv, dv0)
    beam.v0 = v0
    p.euv_beam = beam

    gains = []
    Nx, Ny = gain_nx, gain_ny
    gx, _ = _uniform_grid(0.0, 7e-3, Nx)
    if full_plane:
        gy, _ = _uniform_grid(-2.45e-3, 2.45e-3, Ny)
    else:
        gy, _ = _uniform_grid(0.0, 2.45e-3, Ny)
    gx = np.sort(gx)
    gy = np.sort(gy)
    if non_uniform_gain is True:
        gx = np.sort(gx + rng.uniform(-2e-5, 2e-5, Nx))
        gy = np.sort(gy + rng.uniform(-5e-6, 5e-6, Ny))
    elif non_uniform_gain:
        # float strength w: power-warp the coordinates (t -> t^(1+w) over
        # the same extents) -- strongly non-uniform spacings that really
        # exercise findindex bisection, unlike the tiny jitter above
        w = float(non_uniform_gain)

        def _warp(g):
            t = (g - g[0]) / (g[-1] - g[0])
            return g[0] + (g[-1] - g[0]) * t ** (1.0 + w)

        gx = _warp(gx)
        gy = gy if gy[0] < 0 else _warp(gy)  # keep full-plane grids simple
    X, Y = np.meshgrid(gx, gy)  # [Ny, Nx]
    for s in range(N):
        g = RayGain()
        g.x = gx.copy()
        g.y = gy.copy()
        # smooth, *gentle* index-of-refraction dip. Trajectories through a
        # refracting column are chaotic: 1-ulp arithmetic differences between
        # implementations amplify per sub-length (measured ~1000x/sub at
        # production-strength gradients on a 30-cell grid). Tests compare
        # per-ray results against the scalar oracle, so the synthetic keeps
        # gradients weak enough that implementations agree to ~1e-5; the
        # production-strength regime is covered by the golden-image norm
        # gates against the real snapshots.
        blob = np.exp(-((X - 2.5e-3) ** 2) / (3e-3) ** 2
                      - (Y / 2.5e-3) ** 2)
        n_dip = 0.0 if refraction_free else 2e-5
        g.n = (1.0 - n_dip * blob * (1 + 0.05 * s)).reshape(-1)
        g.g0 = (60.0 * blob * (1 + 0.1 * s)).astype(np.float32).reshape(-1)
        g.E0 = (1e-4 * blob).astype(np.float32).reshape(-1)
        # normalized Lorentzian-ish lineshape per frequency
        prof = 1.0 / (1.0 + np.linspace(-2, 2, nv) ** 2)
        g.gv = (np.ones((Ny * Nx, 1)) * prof[None, :]).astype(np.float32).reshape(-1)
        g.gv0 = np.full(Ny * Nx, prof.max(), np.float32)
        gains.append(g)
    p.gain = gains

    if seeded:
        sb = SeedBeam()
        sb.x, sb.dx = _uniform_grid(5e-4, 5.5e-3, nx + 2)
        if full_plane:
            sb.y, sb.dy = _uniform_grid(-2.2e-3, 2.2e-3, ny)
        else:
            sb.y, sb.dy = _uniform_grid(0.0, 2.2e-3, ny)
        sb.a, sb.da = _uniform_grid(-6.0, 6.0, na + 1)
        sb.b, sb.db = _uniform_grid(-6.0, 6.0, nb + 1)
        sb.Wx = sb.Wy = 1e-3
        sb.Wa = sb.Wb = 3.0
        sb.Wv = 1e-5
        sb.Wt = 1e-12
        sb.E = 1e-6
        p.seed_beam = sb

        seed = RaySeed()
        dims = [seed_dim] * 4 + [nv]
        seed.initialize(dims)
        centers = (2.5e-3, 1.0e-3, 0.0, 0.0)
        widths = (1.5e-3, 0.8e-3, 4.0, 4.0)
        spans = ((0.0, 6.5e-3), (-2.5e-3, 2.5e-3), (-8.0, 8.0), (-8.0, 8.0))
        for ax in range(4):
            gr = np.linspace(*spans[ax], seed_dim)
            seed.x[ax] = gr
            seed.f[ax] = np.exp(-((gr - centers[ax]) / widths[ax]) ** 2)
        seed.x[4] = beam.v.copy()
        seed.f[4] = 1.0 / (1.0 + np.linspace(-1, 1, nv) ** 2)
        seed.f0 = 3e10
        p.seed = seed
    return p
