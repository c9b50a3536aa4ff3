"""Work units of the benchmark: a frozen generator and the per-call tables.

A work unit is what one ``create_image`` call consumes: an EUV beam grid,
N gain tables (index of refraction, gain, emissivity, lineshape) and, for
the seeded method, a seed beam and a separable seed table. The upstream
snapshots are not in the checkout, so the tables are synthetic.

:func:`synthetic_unit` is a frozen copy of the port's
``testing.synthetic_problem`` and :func:`scale_unit` of its
``io.loader.scale_problem`` (the reference's ``-scale=``). Both build plain
``SimpleNamespace`` objects of numpy arrays under the reference's field
names, so that the plain reference (``benchmark/reference``) reads them
without the program, and :func:`to_program` wraps the same arrays in the
program's structures to call it. Later changes to the program's copies do
not move the yardstick.

Production hands ``create_image`` new gain tables on every iteration, so
every call of a window gets tables no earlier call had: one base unit is
made in set-up, and :func:`call_unit` scales each segment's ``g0`` by a
factor drawn from the seed and the call index (:func:`gain_factors`), as
the port's ``testing.perturbed_problems`` scales it. The factors move no
trajectory (the walk depends on the index of refraction only), so every
call of a cell does the same work.
"""

from __future__ import annotations

import copy
from types import SimpleNamespace

import numpy as np

__all__ = ["synthetic_unit", "scale_unit", "base_unit", "ray_count",
           "gain_factors", "call_unit", "to_program"]


def _uniform_grid(lo, hi, n):
    d = (hi - lo) / n
    return lo + (0.5 + np.arange(n)) * d, d


def synthetic_unit(nx=8, ny=5, na=5, nb=4, nv=6, N=3, seeded=False,
                   seed_dim=21, gain_nx=30, gain_ny=12,
                   non_uniform_gain=0.0, seed_nx=None, seed_ny=None,
                   seed_na=None, seed_nb=None) -> SimpleNamespace:
    """An ASE or seeded work unit with smooth gain tables: the port's
    ``testing.synthetic_problem`` (half-plane y, refraction on), value for
    value. ``non_uniform_gain`` > 0 power-warps the gain grids' x and y
    spacings by that strength, as ``synthetic_problem``'s float form does;
    0 keeps them uniform. ``seed_nx`` .. ``seed_nb`` size the seed beam's
    grid apart from the EUV beam's, as an input file does; each left out
    is ``synthetic_problem``'s (nx + 2, ny, na + 1, nb + 1)."""
    p = SimpleNamespace(N=N, N_start=0, N_parallel=1, seed_beam=None,
                        seed=None)
    beam = SimpleNamespace(run_ASE=True, run_sat=True, run_refract=True,
                           lam=1.7e-6, A=0.0, Nc=3.8e24, R_scale=-1.0,
                           G_scale=-1.0)
    beam.x, beam.dx = _uniform_grid(1e-4, 6e-3, nx)
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

    gx, _ = _uniform_grid(0.0, 7e-3, gain_nx)
    gy, _ = _uniform_grid(0.0, 2.45e-3, gain_ny)
    gx, gy = np.sort(gx), np.sort(gy)
    if non_uniform_gain:
        def _warp(g):
            t = (g - g[0]) / (g[-1] - g[0])
            return g[0] + (g[-1] - g[0]) * t ** (1.0 + float(non_uniform_gain))

        gx, gy = _warp(gx), _warp(gy)
    X, Y = np.meshgrid(gx, gy)  # [Ny, Nx]
    blob = np.exp(-((X - 2.5e-3) ** 2) / (3e-3) ** 2 - (Y / 2.5e-3) ** 2)
    prof = 1.0 / (1.0 + np.linspace(-2, 2, nv) ** 2)
    p.gain = []
    for s in range(N):
        p.gain.append(SimpleNamespace(
            x=gx.copy(), y=gy.copy(),
            n=(1.0 - 2e-5 * blob * (1 + 0.05 * s)).reshape(-1),
            g0=(60.0 * blob * (1 + 0.1 * s)).astype(np.float32).reshape(-1),
            E0=(1e-4 * blob).astype(np.float32).reshape(-1),
            gv=(np.ones((gain_ny * gain_nx, 1)) * prof[None, :]).astype(
                np.float32).reshape(-1),
            gv0=np.full(gain_ny * gain_nx, prof.max(), np.float32)))

    if seeded:
        sb = SimpleNamespace(Wx=1e-3, Wy=1e-3, Wa=3.0, Wb=3.0, Wv=1e-5,
                             Wt=1e-12, E=1e-6)
        sb.x, sb.dx = _uniform_grid(5e-4, 5.5e-3, seed_nx or nx + 2)
        sb.y, sb.dy = _uniform_grid(0.0, 2.2e-3, seed_ny or ny)
        sb.a, sb.da = _uniform_grid(-6.0, 6.0, seed_na or na + 1)
        sb.b, sb.db = _uniform_grid(-6.0, 6.0, seed_nb or nb + 1)
        p.seed_beam = sb
        dims = [seed_dim] * 4 + [nv]
        seed = SimpleNamespace(dim=np.asarray(dims, np.int32),
                               x=[np.zeros(d) for d in dims],
                               f=[np.zeros(d) for d in dims], f0=3e10)
        centers = (2.5e-3, 1.0e-3, 0.0, 0.0)
        widths = (1.5e-3, 0.8e-3, 4.0, 4.0)
        spans = ((0.0, 6.5e-3), (-2.5e-3, 2.5e-3), (-8.0, 8.0), (-8.0, 8.0))
        for ax in range(4):
            gr = np.linspace(*spans[ax], seed_dim)
            seed.x[ax] = gr
            seed.f[ax] = np.exp(-((gr - centers[ax]) / widths[ax]) ** 2)
        seed.x[4] = beam.v.copy()
        seed.f[4] = 1.0 / (1.0 + np.linspace(-1, 1, nv) ** 2)
        p.seed = seed
    return p


def _scale_beam(beam, scale: float) -> None:
    """Resample the (x, y, a, b) grids of a beam in place, keeping the
    cell-edge extents (``scale_beam``, src/CreateImageHelpers.cpp:104-143)."""
    for name, dname in (("x", "dx"), ("y", "dy"), ("a", "da"), ("b", "db")):
        grid = getattr(beam, name)
        d = getattr(beam, dname)
        lo = grid[0] - 0.5 * d
        hi = grid[-1] + 0.5 * d
        n_new = int(len(grid) * scale)
        d_new = (hi - lo) / n_new
        setattr(beam, name, lo + (0.5 + np.arange(n_new)) * d_new)
        setattr(beam, dname, d_new)


def scale_unit(unit, scale: float) -> None:
    """Scale the ray count of ``unit`` by about ``scale``, in place
    (``scale_problem``, src/CreateImageHelpers.cpp:144-150)."""
    _scale_beam(unit.euv_beam, scale ** 0.25)
    if unit.seed_beam is not None:
        _scale_beam(unit.seed_beam, scale ** 0.25)


def base_unit(config: dict, scale: float = 1.0) -> SimpleNamespace:
    """The base unit of a configuration file's ``shape`` at ``scale``."""
    unit = synthetic_unit(**config["shape"])
    if scale != 1:
        scale_unit(unit, scale)
    return unit


def ray_count(unit) -> int:
    """Rays of one call: the cells of the source grid (the seed beam's
    when seeded), at the full stride."""
    src = unit.seed_beam if unit.seed is not None else unit.euv_beam
    return len(src.x) * len(src.y) * len(src.a) * len(src.b)


def gain_factors(seed: int, call: int, n_seg: int, spread: float):
    """The f32 factors of call ``call``'s ``g0`` tables, one a segment,
    uniform in ``1 +- spread``, drawn from ``(seed, call)`` alone."""
    rng = np.random.default_rng(
        [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, call])
    return (1.0 + spread * rng.uniform(-1.0, 1.0, n_seg)).astype(np.float32)


def call_unit(base, factors) -> SimpleNamespace:
    """``base`` with each segment's ``g0`` scaled by its factor in f32;
    every other array is shared with ``base``."""
    unit = copy.copy(base)
    unit.gain = []
    for g, f in zip(base.gain, factors):
        g2 = copy.copy(g)
        g2.g0 = (np.asarray(g.g0, np.float32) * np.float32(f)).astype(
            np.float32)
        unit.gain.append(g2)
    return unit


def to_program(unit):
    """The program's ``CreateImageProblem`` over ``unit``'s arrays (no
    copies)."""
    from raytrace_tpu_torch.structures import (
        CreateImageProblem, EUVBeam, RayGain, RaySeed, SeedBeam)

    p = CreateImageProblem(N=unit.N, N_start=unit.N_start,
                           N_parallel=unit.N_parallel,
                           euv_beam=EUVBeam(**vars(unit.euv_beam)),
                           gain=[RayGain(**vars(g)) for g in unit.gain])
    if unit.seed is not None:
        p.seed_beam = SeedBeam(**vars(unit.seed_beam))
        p.seed = RaySeed(**vars(unit.seed))
    return p
