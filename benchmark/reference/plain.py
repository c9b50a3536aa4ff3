"""The plain reference: one ``create_image`` call in plain PyTorch, f64.

A frozen copy of the port's plain twins (``ops/stepper.py``,
``ops/interp.py``, ``ops/spectrum.py``'s f64 emissivity branch, the f64
form of ``ops/amplify_kernel.amplify_gain_plain``, ``ops/seed.py``,
``ops/binning.py`` with ``deposit_plain``, and the gain layout of
``models/problem.gain_arrays``), which follow the reference miniapp's
``RayTrace_calc_ray`` and ``RayTraceImageCPULoop`` operation for operation:

* the trace in the reference's precision placement: x/y grids, interval
  searches and cell-edge fractions in f64 rounded once to f32, the stepping
  state in f32 with one rounding per operation, ``tan``/``atan`` in f64;
* the spectrum in f64: the emissivity closed form with its Taylor branch
  (ASE, method 1), or the separable seed times ``exp`` of the f64 log-gain
  (seeded, method 2);
* the failure codes -1 (perpendicular exit), -2 (negative spectrum) and -3
  (NaN spectrum), whose rays deposit nothing;
* the deposit into an f64 image ``[nx*ny, nv]`` and I_ang ``[na*nb]`` with
  ``index_add_``.

It reads a work unit of plain numpy arrays (``benchmark/units.py``) and
imports nothing of the program. Beside the images it counts, per ray, the
trace's ``propagate`` micro-steps and cell entries, which the trace
roofline's operation count reads. Rays run in blocks of ``chunk``, so that
the largest unit fits; blocks change only the order of the f64 sums.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

__all__ = ["create_image"]

N_SUB = 3
MAX_CELL_STEPS = 1 << 16
f32 = np.float32


def _f(v) -> float:
    return float(np.float32(v))


# --- tables ------------------------------------------------------------------

def gain_tables(gains, device) -> SimpleNamespace:
    """Per-segment gain tables stacked and padded to the largest grid, with
    flat cell index ``i + j*Nx`` (``models/problem.gain_arrays``)."""
    nx_max = max(len(g.x) for g in gains)
    ny_max = max(len(g.y) for g in gains)
    K = np.asarray(gains[0].gv).size // (len(gains[0].x) * len(gains[0].y))
    cols = {k: [] for k in ("x", "y", "cdx", "cdy", "n4", "g0", "E0", "Gx",
                            "Gy", "gv", "range4")}
    abs_y, nxs, nys = [], [], []

    def grow(arr, n_to):
        if len(arr) == n_to:
            return arr
        step = arr[-1] - arr[-2] if len(arr) > 1 else 1.0
        return np.concatenate(
            [arr, arr[-1] + step * np.arange(1, n_to - len(arr) + 1)])

    def pad2(t, ny_t, nx_t):
        out = np.zeros((ny_t, nx_t), dtype=np.float32)
        out[: t.shape[0], : t.shape[1]] = t
        return out.reshape(-1)

    for g in gains:
        Nx, Ny = len(g.x), len(g.y)
        x64 = np.asarray(g.x, np.float64)
        y64 = np.asarray(g.y, np.float64)
        n64 = np.asarray(g.n, np.float64).reshape(Ny, Nx)
        r0, r1 = np.float32(x64[0]), np.float32(x64[-1])
        r2, r3 = np.float32(y64[0]), np.float32(y64[-1])
        mirror = bool(r2 >= 0)
        if mirror:
            r2 = np.float32(-r3)
        cols["range4"].append(np.array([r0, r1, r2, r3], np.float32))
        abs_y.append(mirror)
        nxs.append(Nx)
        nys.append(Ny)
        xp, yp = grow(x64, nx_max), grow(y64, ny_max)
        cols["x"].append(xp)
        cols["y"].append(yp)
        cols["cdx"].append(np.diff(xp).astype(np.float32))
        cols["cdy"].append(np.diff(yp).astype(np.float32))
        Gx = (n64[:, 1:] - n64[:, :-1]) / (x64[None, 1:] - x64[None, :-1])
        Gy = (n64[1:, :] - n64[:-1, :]) / (y64[1:, None] - y64[:-1, None])

        def cell2(arr):
            return pad2(np.asarray(arr, np.float32).reshape(Ny, Nx),
                        ny_max, nx_max)

        cols["n4"].append(pad2(n64.astype(np.float32), ny_max, nx_max))
        cols["g0"].append(cell2(g.g0))
        cols["E0"].append(cell2(g.E0 if g.E0 is not None
                                else np.zeros(Nx * Ny, np.float32)))
        cols["Gx"].append(pad2(Gx.astype(np.float32), ny_max, nx_max - 1))
        cols["Gy"].append(pad2(Gy.astype(np.float32), ny_max - 1, nx_max))
        gvp = np.zeros((ny_max, nx_max, K), np.float32)
        gvp[:Ny, :Nx] = np.asarray(g.gv, np.float32).reshape(Ny, Nx, K)
        cols["gv"].append(gvp.reshape(-1, K))
    t = {k: torch.from_numpy(np.stack(v)).to(device) for k, v in cols.items()}
    return SimpleNamespace(**t, abs_y=abs_y, nx=nxs, ny=nys)


def _pchip_coefficients(xi, yi):
    """Limited hermite gradients (g1, g2) per interval, f64 numpy
    (``interp_pchip``'s rule, RayTraceImageHelper.h:181-214)."""
    xi = np.asarray(xi, np.float64)
    yi = np.asarray(yi, np.float64)
    n = len(xi)
    f1, f2 = yi[:-1], yi[1:]
    g1 = np.zeros(n - 1)
    g2 = np.zeros(n - 1)
    g1[0] = f2[0] - f1[0]
    if n > 2:
        i = np.arange(2, n)
        fm, fa, fb = yi[i - 2], yi[i - 1], yi[i]
        monotone = ((fa < fb) & (fa > fm)) | ((fa > fb) & (fa < fm))
        dx1 = xi[i - 1] - xi[i - 2]
        dx2 = xi[i] - xi[i - 1]
        g = (dx2 - dx1) / dx1 * (fa - fm) + dx1 / (dx1 + dx2) * (fb - fm)
        g_max = 2 * dx2 * np.minimum(np.abs(fa - fm) / dx1,
                                     np.abs(fb - fa) / dx2)
        g_lim = np.where(g >= 0, 1.0, -1.0) * np.minimum(np.abs(g), g_max)
        g1[i - 1] = np.where(monotone, g_lim, 0.0)
    g2[n - 2] = f2[n - 2] - f1[n - 2]
    if n > 2:
        i = np.arange(1, n - 1)
        fa, fb, fp = yi[i - 1], yi[i], yi[i + 1]
        monotone = ((fb < fa) & (fb > fp)) | ((fb > fa) & (fb < fp))
        dx1 = xi[i] - xi[i - 1]
        dx2 = xi[i + 1] - xi[i]
        g = (-dx2 / (dx1 + dx2)) * (fa - fp) + (dx2 - dx1) / dx2 * (fb - fp)
        g_max = 2 * dx1 * np.minimum(np.abs(fb - fa) / dx1,
                                     np.abs(fp - fb) / dx2)
        g_lim = np.where(g >= 0, 1.0, -1.0) * np.minimum(np.abs(g), g_max)
        g2[i - 1] = np.where(monotone, g_lim, 0.0)
    return g1, g2


def _pchip_eval(xi, yi, g1, g2, x):
    """Batched hermite evaluation (``interp_pchip``,
    RayTraceImageHelper.h:168-220), f64 tensors."""
    n = xi.shape[0]
    i = find_first_single(xi, x).clamp(1, n - 1)
    f1, f2 = yi[i - 1], yi[i]
    dx = (x - xi[i - 1]) / (xi[i] - xi[i - 1])
    gg1, gg2 = g1[i - 1], g2[i - 1]
    dx2 = dx * dx
    hermite = (f1 + dx2 * (2 * dx - 3) * (f1 - f2) + dx * gg1
               - dx2 * (gg1 + (1 - dx) * (gg1 + gg2)))
    t_lo = (x - xi[0]) / (xi[1] - xi[0])
    lo = (1.0 - t_lo) * yi[0] + t_lo * yi[1]
    if n <= 2:
        return lo
    t_hi = (x - xi[n - 2]) / (xi[n - 1] - xi[n - 2])
    hi = (1.0 - t_hi) * yi[n - 2] + t_hi * yi[n - 1]
    return torch.where(x <= xi[0], lo, torch.where(x >= xi[n - 1], hi,
                                                   hermite))


def entry_seed_tables(seed, grids, K, device):
    """The seed's four factors at the f32 source grid points (zero outside
    the seed table's box) and its frequency profile, f64
    (``calc_seed_inline``, RayTraceImageHelper.h:230-247)."""
    tabs = []
    for axis, grid in enumerate(grids):
        xi = np.asarray(seed.x[axis], np.float64)
        fi = np.asarray(seed.f[axis], np.float64)
        g1, g2 = _pchip_coefficients(xi, fi)
        xs, fs, g1, g2 = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                          for a in (xi, fi, g1, g2))
        pts = grid.to(torch.float64)
        vals = _pchip_eval(xs, fs, g1, g2, pts)
        inside = (pts >= float(xi[0])) & (pts <= float(xi[-1]))
        tabs.append(torch.where(inside, vals, torch.zeros_like(vals)))
    fv = torch.from_numpy(np.asarray(seed.f[4], np.float64)).to(device)[:K]
    return tabs, fv, float(seed.f0)


# --- search and interpolation ------------------------------------------------

def find_first_single(grid, y):
    """First index i with grid[i] >= y (``findfirstsingle``,
    RayTraceImageHelper.h:101-117): 0 below the grid, n above it."""
    n = grid.shape[0]
    y = y.to(grid.dtype)
    mid = torch.searchsorted(grid, y.contiguous(), side="left").clamp(1, n - 1)
    return torch.where(y < grid[0], torch.zeros_like(mid),
                       torch.where(y > grid[n - 1], torch.full_like(mid, n),
                                   mid))


def find_index(grid, y):
    """Interpolation interval in [1, n-1] (``findindex``)."""
    return find_first_single(grid, y).clamp(1, grid.shape[0] - 1)


def bilinear(dx, dy, f1, f2, f3, f4):
    dx2 = 1.0 - dx
    dy2 = 1.0 - dy
    return (dx * f2 + dx2 * f1) * dy2 + (dx * f4 + dx2 * f3) * dy


# --- the trace ---------------------------------------------------------------

def _normalize(sx, sy, sz):
    inv = 1.0 / torch.sqrt(sx * sx + sy * sy + sz * sz)
    return sx * inv, sy * inv, sz * inv


def ray_directions(a, b, method):
    sx = torch.tan((_f(1e-3) * a).double()).float()
    sy = torch.tan((_f(1e-3) * b).double()).float()
    sz = torch.ones_like(sx)
    if method == 1:
        sx, sy, sz = -sx, -sy, -sz
    return _normalize(sx, sy, sz)


def _propagate(act, sx, sy, sz, n0, dndx, dndy, box0, box1, box2, c):
    """Adaptive micro-steps in a locally linear index field
    (``propagate``, RayTraceImageHelper.h:270-313); every division a tensor
    by a tensor, one rounding each."""
    cf = f32(c)
    dz_max = float(cf * f32(1.00001)) * box2

    def const(v):
        return torch.tensor(float(v), dtype=torch.float32, device=sx.device)

    c01, three, six, twelve = (const(cf * f32(0.1)), const(3), const(6),
                               const(12))
    c005 = float(cf * f32(0.05))
    rx = torch.zeros_like(sx)
    ry = torch.zeros_like(sx)
    rz = torch.zeros_like(sx)
    path = torch.zeros_like(sx)
    nst = torch.zeros(sx.shape, dtype=torch.int32, device=sx.device)
    act = act & (box0 > 0) & (box1 > 0) & (box2 > 0)
    while bool(act.any()):
        nst = nst + act.to(torch.int32)
        n = n0 + rx * dndx + ry * dndy
        t = (sx * dndx + sy * dndy + 1e-12) / n
        fx = dndx / n - sx * t
        fy = dndy / n - sy * t
        fz = -sz * t
        step = torch.minimum(c01 / torch.abs(t), dz_max)
        step2 = (_f(1.0001) * (box2 - torch.abs(rz))) / torch.abs(sz)
        step3 = (c005 * (torch.abs(sx) + 5e-4)) / (torch.abs(fx) + 1e-8)
        step4 = (c005 * (torch.abs(sy) + 5e-4)) / (torch.abs(fy) + 1e-8)
        step = torch.minimum(torch.minimum(step, step2),
                             torch.minimum(step3, step4))
        st = step * t
        c1 = 0.5 * step * step * (1.0 - st / three + st * st / twelve)
        nrx = rx + sx * step + c1 * fx
        nry = ry + sy * step + c1 * fy
        nrz = rz + sz * step + c1 * fz
        c2 = step * (1.0 - 0.5 * st + st * st / six)
        nsx, nsy, nsz = _normalize(sx + c2 * fx, sy + c2 * fy, sz + c2 * fz)
        rx = torch.where(act, nrx, rx)
        ry = torch.where(act, nry, ry)
        rz = torch.where(act, nrz, rz)
        sx = torch.where(act, nsx, sx)
        sy = torch.where(act, nsy, sy)
        sz = torch.where(act, nsz, sz)
        path = torch.where(act, path + step, path)
        act = (act & (torch.abs(rx) < box0) & (torch.abs(ry) < box1)
               & (torch.abs(rz) < box2) & (torch.abs(n - n0) < 0.05))
    return rx, ry, rz, sx, sy, sz, path, nst


def _cell_walk(seg, gain, ray, z, z_stop, c, use_emis):
    """The cell walk of one (segment, sub-length)
    (RayTraceImageHelper.h:460-512); updates ``ray`` in place, counts
    micro-steps and cell entries there, returns (z, gvl, evl, ivl)."""
    nx_pad = gain.x.shape[1]
    xg, yg = gain.x[seg], gain.y[seg]
    cdxg, cdyg = gain.cdx[seg], gain.cdy[seg]
    n4t, g0t, E0t = gain.n4[seg], gain.g0[seg], gain.E0[seg]
    Gxt, Gyt = gain.Gx[seg], gain.Gy[seg]
    r4 = [float(v) for v in gain.range4[seg].tolist()]
    absy = gain.abs_y[seg]
    nx_true, ny_true = gain.nx[seg], gain.ny[seg]
    z_stop995 = float(f32(0.995) * f32(z_stop))
    z_stop = float(z_stop)
    B = z.shape[0]
    gvl = torch.zeros(B, dtype=torch.float32, device=z.device)
    evl = torch.zeros_like(gvl)
    ivl = torch.zeros(B, dtype=torch.int32, device=z.device)
    finished = z >= z_stop995
    for _ in range(MAX_CELL_STEPS):
        if not bool((~finished).any()):
            break
        px, py, sx, sy, sz = (ray[k] for k in ("px", "py", "sx", "sy", "sz"))
        act = ~finished
        esc_now = act & ((px < r4[0]) | (px > r4[1]) | (py < r4[2])
                         | (py > r4[3]) | (sz * sz < _f(0.01)))
        ray["escaped"] = ray["escaped"] | esc_now
        work = act & ~esc_now
        ray["cells"] = ray["cells"] + work.to(torch.int32)
        y_eff = torch.abs(py) if absy else py
        k1 = find_index(xg, px.double()).clamp(max=nx_true - 1)
        k2 = find_index(yg, y_eff.double()).clamp(max=ny_true - 1)
        i1 = (k1 - 1) + (k2 - 1) * nx_pad
        i2 = k1 + (k2 - 1) * nx_pad
        i3 = (k1 - 1) + k2 * nx_pad
        i4 = k1 + k2 * nx_pad
        n1, n2, n3, n4 = n4t[i1], n4t[i2], n4t[i3], n4t[i4]
        xlo, xhi = xg[k1 - 1], xg[k1]
        ylo, yhi = yg[k2 - 1], yg[k2]
        cdx, cdy = cdxg[k1 - 1], cdyg[k2 - 1]
        dxi = ((px.double() - xlo) / (xhi - xlo)).float()
        dyi = ((y_eff.double() - ylo) / (yhi - ylo)).float()
        g0c = bilinear(dxi, dyi, g0t[i1], g0t[i2], g0t[i3], g0t[i4])
        if use_emis:
            E0c = torch.clamp_min(
                bilinear(dxi, dyi, E0t[i1], E0t[i2], E0t[i3], E0t[i4]), 0.0)
        else:
            E0c = torch.zeros_like(g0c)
        gx1 = Gxt[(k1 - 1) + (k2 - 1) * (nx_pad - 1)]
        gx2 = Gxt[(k1 - 1) + k2 * (nx_pad - 1)]
        gy1 = Gyt[(k1 - 1) + (k2 - 1) * nx_pad]
        gy2 = Gyt[k1 + (k2 - 1) * nx_pad]
        exlo = (xlo - 0.1 * (xhi - xlo)).float()
        exhi = (xhi + 0.1 * (xhi - xlo)).float()
        eyhi = (yhi + 0.1 * (yhi - ylo)).float()
        eylo = (ylo - 0.1 * (yhi - ylo)).float()
        if absy:
            eylo = torch.where(k2 <= 1, -eyhi, eylo)
        dz2 = z_stop - z
        l_px, l_py, l_sx, l_sy, l_sz = px, py, sx, sy, sz
        l_pz = torch.zeros_like(px)
        l_z2 = torch.zeros_like(px)
        l_ds = torch.zeros_like(px)
        lim = _f(0.999) * dz2
        act1 = (work & (px > exlo) & (px < exhi) & (y_eff > eylo)
                & (y_eff < eyhi) & (0.0 < lim))
        box0 = _f(0.1) * cdx
        box1 = _f(0.1) * cdy
        while bool(act1.any()):
            y2 = torch.abs(l_py) if absy else l_py
            dxi2 = ((l_px.double() - xlo) / (xhi - xlo)).float()
            dyi2 = ((y2.double() - ylo) / (yhi - ylo)).float()
            n0 = bilinear(dxi2, dyi2, n1, n2, n3, n4)
            dndx = (1.0 - dyi2) * gx1 + dyi2 * gx2
            dndy = (1.0 - dxi2) * gy1 + dxi2 * gy2
            if absy:
                dndy = torch.where(l_py < 0, -dndy, dndy)
            box2 = dz2 - l_z2
            rx, ry, rz, nsx, nsy, nsz, path, nst = _propagate(
                act1, l_sx, l_sy, l_sz, n0, dndx, dndy, box0, box1, box2, c)
            ray["nst"] = ray["nst"] + nst
            l_px = torch.where(act1, l_px + rx, l_px)
            l_py = torch.where(act1, l_py + ry, l_py)
            l_pz = torch.where(act1, l_pz + rz, l_pz)
            l_z2 = torch.where(act1, l_z2 + torch.abs(rz), l_z2)
            l_ds = torch.where(act1, l_ds + path, l_ds)
            l_sx = torch.where(act1, nsx, l_sx)
            l_sy = torch.where(act1, nsy, l_sy)
            l_sz = torch.where(act1, nsz, l_sz)
            y2n = torch.abs(l_py) if absy else l_py
            act1 = (act1 & (l_px > exlo) & (l_px < exhi) & (y2n > eylo)
                    & (y2n < eyhi) & (l_z2 < lim))
        z = torch.where(work, z + torch.abs(l_pz), z)
        gvl = torch.where(work, gvl + g0c * l_ds, gvl)
        evl = torch.where(work, evl + E0c * l_ds, evl)
        ivl = torch.where(work, i1.int(), ivl)
        for k, v in (("px", l_px), ("py", l_py), ("sx", l_sx), ("sy", l_sy),
                     ("sz", l_sz)):
            ray[k] = torch.where(work, v, ray[k])
        finished = ray["escaped"] | (z >= z_stop995)
    return z, gvl, evl, ivl


def trace(rays, N, dz0, gain, method, c, use_emis):
    """Propagate rays through the N-1 length segments; returns a namespace
    of the path integrals ``gvl, evl, ivl`` [B, N-1, 3], the exit ray,
    ``escaped``, ``perp`` and the per-ray counts ``steps`` and ``cells``."""
    B = rays["x"].shape[0]
    dev = rays["x"].device
    nseg = max(N - 1, 0)
    sx, sy, sz = ray_directions(rays["a"], rays["b"], method)
    zeros_i = torch.zeros(B, dtype=torch.int32, device=dev)
    ray = {"px": rays["x"].float(), "py": rays["y"].float(), "sx": sx,
           "sy": sy, "sz": sz, "nst": zeros_i, "cells": zeros_i,
           "escaped": torch.zeros(B, dtype=torch.bool, device=dev)}
    gvl_all = torch.zeros((B, nseg, N_SUB), dtype=torch.float32, device=dev)
    evl_all = torch.zeros_like(gvl_all)
    ivl_all = torch.zeros((B, nseg, N_SUB), dtype=torch.int32, device=dev)
    dz0_f = f32(dz0)
    for i in range(nseg):
        ii = N - i - 1 if method == 1 else i + 1
        z = torch.zeros(B, dtype=torch.float32, device=dev)
        for iz in range(N_SUB):
            isub = N_SUB - iz - 1 if method == 1 else iz
            z_stop = f32(dz0_f * f32(iz + 1.0) / f32(N_SUB))
            z, gvl, evl, ivl = _cell_walk(ii, gain, ray, z, z_stop, c,
                                          use_emis)
            gvl_all[:, ii - 1, isub] = gvl
            evl_all[:, ii - 1, isub] = evl
            ivl_all[:, ii - 1, isub] = ivl
    sx, sy, sz = ray["sx"], ray["sy"], ray["sz"]
    return SimpleNamespace(
        gvl=gvl_all, evl=evl_all, ivl=ivl_all, exit_x=ray["px"],
        exit_y=ray["py"],
        exit_a=torch.atan((sx / sz).double()).float() * 1e3,
        exit_b=torch.atan((sy / sz).double()).float() * 1e3,
        escaped=ray["escaped"], perp=sz * sz < _f(0.01),
        steps=ray["nst"], cells=ray["cells"])


# --- the spectrum ------------------------------------------------------------

def amplify_emissivity(res, K, gv, N):
    """The ASE spectrum from zero: ``I = j/g (e^g - 1) + I e^g`` per
    (segment, sub-length), the Taylor branch for |g| < 1e-3, in f64."""
    B = res.gvl.shape[0]
    Iv = torch.zeros((B, K), dtype=torch.float64, device=res.gvl.device)
    gvl = res.gvl.to(torch.float64)
    evl = res.evl.to(torch.float64)
    for i in range(max(N - 1, 0)):
        for isub in range(N_SUB):
            gv_row = gv[i][res.ivl[:, i, isub].long()].to(torch.float64)
            el = evl[:, i, isub, None] * gv_row
            gl = gvl[:, i, isub, None] * gv_row
            small = torch.abs(gl) < 1e-3
            exp_gl = torch.exp(torch.where(small, 0.0, gl))
            em1 = exp_gl - 1.0
            gl_safe = torch.where(small, 1.0, gl)
            big = el / gl_safe * em1 + Iv * exp_gl
            taylor = (el * (1.0 + 0.5 * gl * (1.0 + 0.3333333333 * gl))
                      + Iv * (1.0 + gl * (1.0 + 0.5 * gl)))
            Iv = torch.where(small, taylor, big)
    return Iv


def amplify_seeded(f, fv, res, gv):
    """The seeded spectrum: ``where(escaped, 0, f * fv) * exp(sum gvl *
    gv[cell])``, the log-gain summed in f64, segments outer."""
    B, nseg, nsub = res.ivl.shape
    gl = torch.zeros((B, gv.shape[2]), dtype=torch.float64,
                     device=res.ivl.device)
    gvl64 = res.gvl.to(torch.float64)
    for i in range(nseg):
        for isub in range(nsub):
            gv_row = gv[i][res.ivl[:, i, isub].long()].to(torch.float64)
            gl = gl + gvl64[:, i, isub, None] * gv_row
    Iv0 = torch.where(res.escaped[:, None], 0.0, f[:, None] * fv[None, :])
    return Iv0 * torch.exp(gl)


# --- binning -----------------------------------------------------------------

def _get_index(grid, d, y):
    """``getIndex`` (RayTraceImageCPU.cpp:11-16) in f64, -1 outside."""
    y = y.to(torch.float64)
    n = grid.shape[0]
    idx = find_first_single(grid, y - 0.5 * d)
    bad = (y < grid[0] - 0.5 * d) | (y > grid[n - 1] + 0.5 * d)
    return torch.where(bad, torch.full_like(idx, -1), idx)


def deposit(Iv, coords, ok, beam, method, scale, image, i_ang):
    """Add the rays' spectra into the image and I_ang in place: method 2
    bins the exit ray with negated angles, y mirrored on a half-plane
    beam."""
    nx, ny = beam.x.shape[0], beam.y.shape[0]
    na, nb = beam.a.shape[0], beam.b.shape[0]
    bx, by, ba, bb = coords
    if method == 2:
        if beam.y0_nonneg:
            by = torch.where(by < 0, -by, by)
        ba, bb = -ba, -bb
    i1 = _get_index(beam.x, beam.dx, bx)
    i2 = _get_index(beam.y, beam.dy, by)
    i3 = _get_index(beam.a, beam.da, ba)
    i4 = _get_index(beam.b, beam.db, bb)
    img = i1 + i2 * nx
    img_ok = ok & (i1 >= 0) & (i2 >= 0) & (img < nx * ny)
    ang = i3 + i4 * na
    ang_ok = ok & (i3 >= 0) & (i4 >= 0) & (ang < na * nb)
    image.index_add_(0, img[img_ok], (Iv * scale)[img_ok])
    i_ang.index_add_(0, ang[ang_ok], (Iv @ (2.0 * beam.dv))[ang_ok])


# --- the call ----------------------------------------------------------------

#: rays a block of the reference works at once: what one card's memory
#: holds beside the program's freed state at every cell's size
CHUNK = 1 << 22


def create_image(unit, device="cpu", chunk=CHUNK, c=0.5):
    """One call on ``unit``: ``(image [nx*ny*nv], I_ang [na*nb], counts)``
    as f64 numpy arrays in the reference's flat layouts, and ``counts`` a
    dict of the call's ``rays``, ``failed`` rays, trace ``steps`` and
    ``cells`` in all."""
    dev = torch.device(device)
    beam = unit.euv_beam
    seeded = unit.seed is not None
    src = unit.seed_beam if seeded else beam
    method = 2 if seeded else 1
    K = len(beam.v)
    scale = (1.0 if method == 1 else
             (src.dx * src.dy * src.da * src.db) / (beam.dx * beam.dy))
    use_emis = unit.gain[0].E0 is not None and not seeded
    gain = gain_tables(unit.gain, dev)
    gv = gain.gv[1:]
    grids = [torch.from_numpy(np.asarray(g, np.float64).astype(np.float32))
             .to(dev) for g in (src.x, src.y, src.a, src.b)]
    if seeded:
        (tx, ty, ta, tb), fv, f0 = entry_seed_tables(unit.seed, grids, K, dev)
    f64 = dict(dtype=torch.float64, device=dev)
    dbeam = SimpleNamespace(
        **{k: torch.from_numpy(np.asarray(getattr(beam, k), np.float64))
           .to(dev) for k in ("x", "y", "a", "b", "dv")},
        dx=float(beam.dx), dy=float(beam.dy), da=float(beam.da),
        db=float(beam.db), y0_nonneg=bool(beam.y[0] >= 0.0))
    dims = (len(src.x), len(src.y), len(src.a), len(src.b))
    total = dims[0] * dims[1] * dims[2] * dims[3]
    image = torch.zeros((len(beam.x) * len(beam.y), K), **f64)
    i_ang = torch.zeros(len(beam.a) * len(beam.b), **f64)
    counts = dict(rays=total, failed=0, steps=0, cells=0)
    for start in range(0, total, chunk):
        ijkm = torch.arange(start, min(start + chunk, total), device=dev)
        m = ijkm % dims[3]
        k = (ijkm // dims[3]) % dims[2]
        j = (ijkm // (dims[2] * dims[3])) % dims[1]
        i = ijkm // (dims[1] * dims[2] * dims[3])
        rays = {"x": grids[0][i], "y": grids[1][j], "a": grids[2][k],
                "b": grids[3][m]}
        res = trace(rays, unit.N, beam.dz, gain, method, c, use_emis)
        if use_emis:
            Iv = amplify_emissivity(res, K, gv, unit.N)
        else:
            f = (torch.clamp_min(f0 * tx[i] * ty[j] * ta[k] * tb[m], 0.0)
                 if seeded else torch.zeros(len(ijkm), **f64))
            Iv = amplify_seeded(f, fv if seeded else torch.ones(K, **f64),
                                res, gv)
        bad = res.perp | torch.any(Iv < 0.0, dim=1) | torch.any(Iv != Iv,
                                                                 dim=1)
        coords = ((rays["x"], rays["y"], rays["a"], rays["b"]) if method == 1
                  else (res.exit_x, res.exit_y, res.exit_a, res.exit_b))
        deposit(Iv, coords, ~bad, dbeam, method, scale, image, i_ang)
        counts["failed"] += int(bad.sum())
        counts["steps"] += int(res.steps.sum(dtype=torch.int64))
        counts["cells"] += int(res.cells.sum(dtype=torch.int64))
    return (image.reshape(-1).cpu().numpy(), i_ang.cpu().numpy(), counts)
