"""Scalar numpy oracle for single-ray propagation.

A straight-line, loop-based implementation of the physics used as the
unit-test anchor for every accelerated backend (SURVEY.md section 7 step 2).
It is a copy of ``raytrace_tpu.ops.oracle`` on this package's structures,
kept in numpy scalars (not torch) so that both packages' oracles round
alike and agree bitwise. It runs on the host and takes no device.
It mirrors the semantics of the reference kernel:

* ``propagate``        <- src/common/RayTraceImageHelper.h:270-313
* ``propagate2``       <- src/common/RayTraceImageHelper.h:318-351
* ``calc_ray``         <- ``RayTrace_calc_ray`` src/common/RayTraceImageHelper.h:379-595
* ``calc_seed``        <- ``calc_seed_inline``  src/common/RayTraceImageHelper.h:230-247
* ``interp_pchip``     <- src/common/RayTraceImageHelper.h:168-220
* ``find_first_single``<- src/common/RayTraceImageHelper.h:101-117
* ``find_index``       <- src/common/RayTraceImageHelper.h:131-143

Precision placement follows the reference's mixed fp32/fp64 scheme: ray
position/direction and stepping in float32, grids/``n``/seed tables and the
spectral amplification in float64. Arithmetic is done with numpy scalar types
so float32 operations round like the C float operations do (double-rounded
intermediates in the reference differ by at most 1 ulp; the golden-image
gate is norm-based at 5e-6 so this is far below tolerance).

This module is intentionally slow (pure Python): use it on a handful of rays.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from raytrace_tpu_torch.structures import RayGain, RaySeed

__all__ = [
    "N_MAX", "K_MAX", "N_SUB", "N_FAILED_MAX",
    "calc_ray", "calc_seed", "interp_pchip", "find_first_single", "find_index",
    "RayResult",
]

# Kernel limits (RayTraceImageHelper.h:29-32)
N_MAX = 20         # maximum number of length segments
K_MAX = 100        # maximum number of frequencies
N_SUB = 3          # sub-lengths per segment
N_FAILED_MAX = 32  # failed rays to retain for diagnostics

f32 = np.float32


def find_first_single(X: np.ndarray, Y: float) -> int:
    """First index i with X[i] >= Y via bisection; returns len(X) if none."""
    n = len(X)
    if Y < X[0]:
        return 0
    if Y > X[n - 1]:
        return n
    lower, upper = 0, n - 1
    while upper - lower != 1:
        mid = (upper + lower) // 2
        if X[mid] >= Y:
            upper = mid
        else:
            lower = mid
    return upper


def find_index(X: np.ndarray, Y: float) -> int:
    """Interpolation-interval index, clamped to 1..len(X)-1."""
    lower, upper = 0, len(X) - 1
    while upper - lower != 1:
        mid = (upper + lower) // 2
        if X[mid] >= Y:
            upper = mid
        else:
            lower = mid
    return upper


def _bilinear(dx, dy, f1, f2, f3, f4):
    """Bilinear blend in float32 (RayTraceImageHelper.h:153-158)."""
    dx, dy = f32(dx), f32(dy)
    dx2 = f32(1.0) - dx
    dy2 = f32(1.0) - dy
    return (dx * f32(f2) + dx2 * f32(f1)) * dy2 + (dx * f32(f4) + dx2 * f32(f3)) * dy


def _pchip_gradients(xi: np.ndarray, yi: np.ndarray, i: int):
    """Limited 3-point finite-difference gradients for interval i
    (normalized to the interval), as in interp_pchip."""
    N = len(xi)
    f1, f2 = yi[i - 1], yi[i]
    g1 = 0.0
    if i <= 1:
        g1 = f2 - f1
    elif (f1 < f2 and f1 > yi[i - 2]) or (f1 > f2 and f1 < yi[i - 2]):
        f0 = yi[i - 2]
        dx1 = xi[i - 1] - xi[i - 2]
        dx2 = xi[i] - xi[i - 1]
        a1 = (dx2 - dx1) / dx1
        a2 = dx1 / (dx1 + dx2)
        g1 = a1 * (f1 - f0) + a2 * (f2 - f0)
        fx1 = abs(f1 - f0) / dx1
        fx2 = abs(f2 - f1) / dx2
        g_max = 2 * dx2 * min(fx1, fx2)
        g1 = (1.0 if g1 >= 0 else -1.0) * min(abs(g1), g_max)
    g2 = 0.0
    if i >= N - 1:
        g2 = f2 - f1
    elif (f2 < f1 and f2 > yi[i + 1]) or (f2 > f1 and f2 < yi[i + 1]):
        f0 = yi[i + 1]
        dx1 = xi[i] - xi[i - 1]
        dx2 = xi[i + 1] - xi[i]
        a1 = -dx2 / (dx1 + dx2)
        a2 = (dx2 - dx1) / dx2
        g2 = a1 * (f1 - f0) + a2 * (f2 - f0)
        fx1 = abs(f2 - f1) / dx1
        fx2 = abs(f0 - f2) / dx2
        g_max = 2 * dx1 * min(fx1, fx2)
        g2 = (1.0 if g2 >= 0 else -1.0) * min(abs(g2), g_max)
    return g1, g2


def interp_pchip(xi: np.ndarray, yi: np.ndarray, x: float) -> float:
    """Monotone cubic-hermite interpolation with linear extrapolation."""
    N = len(xi)
    if x <= xi[0] or N <= 2:
        dx = (x - xi[0]) / (xi[1] - xi[0])
        return (1.0 - dx) * yi[0] + dx * yi[1]
    if x >= xi[N - 1]:
        dx = (x - xi[N - 2]) / (xi[N - 1] - xi[N - 2])
        return (1.0 - dx) * yi[N - 2] + dx * yi[N - 1]
    i = find_first_single(xi, x)
    f1, f2 = yi[i - 1], yi[i]
    dx = (x - xi[i - 1]) / (xi[i] - xi[i - 1])
    g1, g2 = _pchip_gradients(xi, yi, i)
    dx2 = dx * dx
    return f1 + dx2 * (2 * dx - 3) * (f1 - f2) + dx * g1 - dx2 * (g1 + (1 - dx) * (g1 + g2))


def calc_seed(seed: RaySeed, x, y, a, b) -> np.ndarray:
    """Seed intensity spectrum at a phase-space point: separable product of
    four pchip-interpolated factors times the frequency profile."""
    f = 0.0
    inside = (
        seed.x[0][0] <= x <= seed.x[0][seed.dim[0] - 1]
        and seed.x[1][0] <= y <= seed.x[1][seed.dim[1] - 1]
        and seed.x[2][0] <= a <= seed.x[2][seed.dim[2] - 1]
        and seed.x[3][0] <= b <= seed.x[3][seed.dim[3] - 1]
    )
    if inside:
        fx = interp_pchip(seed.x[0], seed.f[0], x)
        fy = interp_pchip(seed.x[1], seed.f[1], y)
        fa = interp_pchip(seed.x[2], seed.f[2], a)
        fb = interp_pchip(seed.x[3], seed.f[3], b)
        f = max(seed.f0 * fx * fy * fa * fb, 0.0)
    return f * np.asarray(seed.f[4], dtype=np.float64)


def _normalize(s):
    """Renormalize a near-unit direction vector in float32."""
    tmp = s[0] * s[0] + s[1] * s[1] + s[2] * s[2]
    tmp = f32(1.0 / math.sqrt(tmp))
    return [s[0] * tmp, s[1] * tmp, s[2] * tmp]


def _propagate(s, n0, dn_dx, dn_dy, dx_box, c, stats=None):
    """March a ray through a locally-linear index field n = n0 + x nx + y ny.

    Adaptive 2nd/3rd-order sub-stepping with four competing step limits
    (curvature, remaining z, bounded change of sx and sy); exits when the
    displacement leaves the |r| < dx_box region or n drifts by 0.05.
    Returns (r, s, path_length).
    """
    total = f32(0.0)
    dz_max = f32(c) * f32(1.00001) * dx_box[2]
    r = [f32(0.0), f32(0.0), f32(0.0)]
    n = f32(n0)
    c = f32(c)
    while (abs(r[0]) < dx_box[0] and abs(r[1]) < dx_box[1] and abs(r[2]) < dx_box[2]
           and abs(n - n0) < 0.05):
        if stats is not None:
            stats["micro_steps"] += 1
        n = n0 + r[0] * dn_dx + r[1] * dn_dy
        t = (s[0] * dn_dx + s[1] * dn_dy + f32(1e-12)) / n
        fv = [dn_dx / n - s[0] * t, dn_dy / n - s[1] * t, -s[2] * t]
        step = c * f32(0.1) / f32(abs(t))
        step = min(step, dz_max)
        step2 = f32(1.0001) * (dx_box[2] - f32(abs(r[2]))) / f32(abs(s[2]))
        step3 = c * f32(0.05) * (f32(abs(s[0])) + f32(5e-4)) / (f32(abs(fv[0])) + f32(1e-8))
        step4 = c * f32(0.05) * (f32(abs(s[1])) + f32(5e-4)) / (f32(abs(fv[1])) + f32(1e-8))
        step = min(step, step2, step3, step4)
        st = step * t
        c1 = f32(0.5) * step * step * (f32(1.0) - st / f32(3.0) + st * st / f32(12.0))
        r[0] += s[0] * step + c1 * fv[0]
        r[1] += s[1] * step + c1 * fv[1]
        r[2] += s[2] * step + c1 * fv[2]
        c2 = step * (f32(1.0) - f32(0.5) * st + st * st / f32(6.0))
        s = [s[0] + c2 * fv[0], s[1] + c2 * fv[1], s[2] + c2 * fv[2]]
        s = _normalize(s)
        total += step
    return r, s, total


def _propagate2(pos, s, dz, x2, y2_grid, cell_range, n4, abs_y, c, stats=None):
    """Walk a ray across one gain cell, re-interpolating n and its gradient
    bilinearly from the four float64 corner values each pass. ``abs_y``
    applies the half-plane mirror symmetry."""
    z = f32(0.0)
    ds_sum = f32(0.0)
    dxc = f32(x2[1] - x2[0])
    dyc = f32(y2_grid[1] - y2_grid[0])
    y_eff = f32(abs(pos[1])) if abs_y else pos[1]
    while (pos[0] > cell_range[0] and pos[0] < cell_range[1]
           and y_eff > cell_range[2] and y_eff < cell_range[3]
           and z < f32(0.999) * f32(dz)):
        if stats is not None:
            stats["interp_steps"] += 1
        y_eff = f32(abs(pos[1])) if abs_y else pos[1]
        dxi = f32((pos[0] - x2[0]) / (x2[1] - x2[0]))
        dyi = f32((y_eff - y2_grid[0]) / (y2_grid[1] - y2_grid[0]))
        n0 = _bilinear(dxi, dyi, n4[0], n4[1], n4[2], n4[3])
        # dn/dx is the x-gradient interpolated ALONG Y: weight (1 - dyi)
        # (RayTraceImageHelper.h:333). A (1 - dxi) transliteration slip
        # here survived three rounds sub-tolerance on the weak-gradient
        # synthetics and was caught by the round-4 fuzz on a refracting
        # non-uniform case (order-unity per-ray divergence, every batched
        # backend agreeing against the oracle).
        dn_dx = f32((1.0 - dyi) * (n4[1] - n4[0]) / (x2[1] - x2[0])
                    + dyi * (n4[3] - n4[2]) / (x2[1] - x2[0]))
        dn_dy = f32((1.0 - dxi) * (n4[2] - n4[0]) / (y2_grid[1] - y2_grid[0])
                    + dxi * (n4[3] - n4[1]) / (y2_grid[1] - y2_grid[0]))
        if abs_y and pos[1] < 0:
            dn_dy = -dn_dy
        dx_box = [f32(0.1) * dxc, f32(0.1) * dyc, f32(dz) - z]
        r, s, ds = _propagate(s, n0, dn_dx, dn_dy, dx_box, c, stats)
        ds_sum += ds
        pos = [pos[0] + r[0], pos[1] + r[1], pos[2] + r[2]]
        z += f32(abs(r[2]))
        y_eff = f32(abs(pos[1])) if abs_y else pos[1]
    return pos, s, ds_sum


@dataclass
class RayResult:
    Iv: np.ndarray          # (K,) float64 output spectrum
    ray_out: np.ndarray     # (4,) exit (x, y, a, b)
    error: int              # 0 ok, -1 perpendicular, -2 negative, -3 NaN
    stats: dict | None = None
    debug: np.ndarray | None = None  # (3, N_SUB*(N-1)+1) station x, y, I
    gvl: np.ndarray | None = None    # (N_MAX, N_SUB) path-integrated gain
    evl: np.ndarray | None = None
    ivl: np.ndarray | None = None


def calc_ray(ray, N, dz0, gains: list[RayGain], seed: RaySeed | None, K: int,
             method: int, c: float = 0.5, collect_stats: bool = False,
             debug_dv=None) -> RayResult:
    """Propagate a single ray through N-1 length segments and amplify.

    method 1 = backward (ASE), method 2 = forward (seeded). Per (segment,
    sub-length) the path-weighted gain/emissivity are accumulated, then the
    amplification ODE dI/dz = j + g I is applied per frequency in closed form.

    ``debug_dv``: frequency spacings; when given, per-station trajectories and
    running intensity are captured like the reference's RAY_DEBUG path
    (RayTraceImageHelper.h:419-426,505-511,536-567).
    """
    stats = {"micro_steps": 0, "interp_steps": 0, "cell_steps": 0} if collect_stats else None
    n_st = N_SUB * (N - 1) + 1
    debug = None if debug_dv is None else np.zeros((3, n_st), dtype=np.float32)
    gvl = np.zeros((N_MAX, N_SUB), dtype=np.float32)
    evl = np.zeros((N_MAX, N_SUB), dtype=np.float32)
    ivl = np.zeros((N_MAX, N_SUB), dtype=np.int64)
    Iv = np.zeros(K, dtype=np.float64)

    use_emis = gains[0].E0 is not None and seed is None

    pos = [f32(ray[0]), f32(ray[1]), f32(0.0)]
    s = [f32(math.tan(f32(1e-3) * f32(ray[2]))), f32(math.tan(f32(1e-3) * f32(ray[3]))), f32(1.0)]
    if method == 1:
        s = [-s[0], -s[1], -s[2]]
    s = _normalize(s)
    if debug is not None:
        st0 = (N - 1) * N_SUB if method == 1 else 0
        debug[0, st0] = pos[0]
        debug[1, st0] = pos[1]

    dz0 = f32(dz0)
    escaped = False
    for i in range(N - 1):
        if escaped:
            break
        ii = N - i - 1 if method == 1 else i + 1
        g = gains[ii]
        Nx, Ny = g.Nx, g.Ny
        rng = [f32(g.x[0]), f32(g.x[Nx - 1]), f32(g.y[0]), f32(g.y[Ny - 1])]
        abs_y = False
        if rng[2] >= 0:
            rng[2] = -rng[3]
            abs_y = True
        z = f32(0.0)
        for iz in range(N_SUB):
            isub = N_SUB - iz - 1 if method == 1 else iz
            z_stop = dz0 * f32(iz + 1.0) / f32(N_SUB)
            while z < f32(0.995) * z_stop:
                if (pos[0] < rng[0] or pos[0] > rng[1] or pos[1] < rng[2]
                        or pos[1] > rng[3] or s[2] * s[2] < 0.01):
                    escaped = True
                    break
                if stats is not None:
                    stats["cell_steps"] += 1
                y_eff = f32(abs(pos[1])) if abs_y else pos[1]
                k1 = find_index(g.x, pos[0])
                k2 = find_index(g.y, y_eff)
                i1 = (k1 - 1) + (k2 - 1) * Nx
                i2 = k1 + (k2 - 1) * Nx
                i3 = (k1 - 1) + k2 * Nx
                i4 = k1 + k2 * Nx
                x2 = (g.x[k1 - 1], g.x[k1])
                y2 = (g.y[k2 - 1], g.y[k2])
                n4 = (g.n[i1], g.n[i2], g.n[i3], g.n[i4])
                dxi = f32((pos[0] - x2[0]) / (x2[1] - x2[0]))
                dyi = f32((y_eff - y2[0]) / (y2[1] - y2[0]))
                g0 = _bilinear(dxi, dyi, g.g0[i1], g.g0[i2], g.g0[i3], g.g0[i4])
                E0 = f32(0.0)
                if use_emis:
                    E0 = _bilinear(dxi, dyi, g.E0[i1], g.E0[i2], g.E0[i3], g.E0[i4])
                    E0 = E0 if E0 >= 0 else f32(0.0)
                pos[2] = f32(0.0)
                cell_range = [
                    f32(x2[0] - 0.1 * (x2[1] - x2[0])),
                    f32(x2[1] + 0.1 * (x2[1] - x2[0])),
                    f32(y2[0] - 0.1 * (y2[1] - y2[0])),
                    f32(y2[1] + 0.1 * (y2[1] - y2[0])),
                ]
                if abs_y and k2 <= 1:
                    cell_range[2] = -cell_range[3]
                pos, s, ds_sum = _propagate2(
                    pos, s, z_stop - z, x2, y2, cell_range, n4, abs_y, c, stats)
                z += f32(abs(pos[2]))
                gvl[ii - 1][isub] += g0 * ds_sum
                evl[ii - 1][isub] += E0 * ds_sum
                ivl[ii - 1][isub] = i1
            if debug is not None:
                # stations are written even after escape, with frozen pos,
                # matching the reference loop structure (the escape only
                # breaks the innermost while; RayTraceImageHelper.h:460-512)
                st = N_SUB * (ii - 1) + isub + (0 if method == 1 else 1)
                debug[0, st] = pos[0]
                debug[1, st] = pos[1]

    if s[2] * s[2] < 0.01:
        return RayResult(Iv, np.zeros(4), -1, stats, debug, gvl, evl, ivl)

    ray_out = np.array([
        pos[0], pos[1],
        f32(math.atan(s[0] / s[2]) * 1e3), f32(math.atan(s[1] / s[2]) * 1e3),
    ], dtype=np.float64)

    if seed is not None and not escaped:
        if method == 1:
            Iv[:] = calc_seed(seed, pos[0], pos[1], ray_out[2], ray_out[3])[:K]
        elif method == 2:
            Iv[:] = calc_seed(seed, ray[0], ray[1], ray[2], ray[3])[:K]

    # Amplification: dI/dx = j + g I  =>  I = j/g (e^{gx}-1) + I0 e^{gx}
    if debug is not None:
        debug[2, 0] = np.float32(np.sum(2.0 * Iv * np.asarray(debug_dv)[:K]))
    if use_emis or debug is not None:
        for i in range(N - 1):
            g = gains[i + 1]
            for isub in range(N_SUB):
                gv_row = g.gv[ivl[i][isub] * K:(ivl[i][isub] + 1) * K].astype(np.float64)
                gl = np.float64(gvl[i][isub]) * gv_row
                el = np.float64(evl[i][isub]) * gv_row
                small = np.abs(gl) < 1e-3
                exp_gl = np.exp(np.where(small, 0.0, gl))
                with np.errstate(divide="ignore", invalid="ignore"):
                    big_val = el / gl * (exp_gl - 1.0) + Iv * exp_gl
                small_val = el * (1.0 + 0.5 * gl * (1.0 + 0.3333333333 * gl)) \
                    + Iv * (1.0 + gl * (1.0 + 0.5 * gl))
                Iv = np.where(small, small_val, big_val)
                if debug is not None:
                    st = N_SUB * i + isub + 1
                    debug[2, st] = np.float32(
                        np.sum(2.0 * Iv * np.asarray(debug_dv)[:K]))
    else:
        gl = np.zeros(K, dtype=np.float64)
        for i in range(N - 1):
            g = gains[i + 1]
            for isub in range(N_SUB):
                gv_row = g.gv[ivl[i][isub] * K:(ivl[i][isub] + 1) * K].astype(np.float64)
                gl += np.float64(gvl[i][isub]) * gv_row
        Iv = Iv * np.exp(gl)

    error = 0
    if np.any(Iv < 0.0):
        error = -2
    elif np.any(Iv != Iv):
        error = -3
    return RayResult(Iv, ray_out, error, stats, debug, gvl, evl, ivl)
