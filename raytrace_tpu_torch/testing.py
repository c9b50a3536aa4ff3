"""Synthetic problem generation for tests and shipped-shape runs.

Builds physically-sane random ``create_image`` work units shaped like the
production snapshots (plasma gain column, half-plane y symmetry, optional
separable seed). :func:`synthetic_problem` is a bit-identical copy of
``raytrace_tpu.testing.synthetic_problem``, so both packages see the same
work unit for the same arguments.
"""

from __future__ import annotations

import numpy as np

from raytrace_tpu_torch.structures import (
    CreateImageProblem, EUVBeam, RayGain, RaySeed, SeedBeam,
)

__all__ = ["synthetic_problem"]


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
