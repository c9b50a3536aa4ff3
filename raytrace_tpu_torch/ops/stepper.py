"""Plain PyTorch ray trace: the CPU path and the twin of the trace kernel.

A vectorised port of ``raytrace_tpu.ops.stepper.trace_batch`` (the
``lax-exact`` semantics, itself the batched form of the reference's
``RayTrace_calc_ray``, src/common/RayTraceImageHelper.h:379-521). The whole
batch advances through the same three nested loops -- cell walk ->
per-cell re-interpolation (``propagate2``) -> adaptive micro-steps
(``propagate``) -- with per-ray masks, so each ray follows exactly the
sequence a scalar loop would.

Precision placement (part of the spec, tests/test_torch_trace.py):

* x/y grids are f64; ``findindex`` bisects them in f64 and the cell-edge
  fractions ``dxi``/``dyi`` and extended cell ranges are computed in f64
  and rounded to f32 once;
* the stepping state (position, direction, steps, path integrals) is f32,
  one rounding per operation in the reference's operation order;
* direction from angles with ``tan`` in f64, exit angles with ``atan`` in
  f64.

:func:`raytrace_tpu_torch.ops.trace_kernel.trace_batch` launches the CUDA
kernel for CUDA tensors and calls :func:`trace_batch_plain` for CPU tensors;
the kernel computes, per ray, what this module computes per lane.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytrace_tpu_torch.models.problem import DeviceGain
from raytrace_tpu_torch.ops.interp import bilinear, find_index

__all__ = ["TraceResult", "trace_batch_plain", "ray_directions", "N_SUB",
           "MAX_CELL_STEPS"]

N_SUB = 3  # sub-lengths per segment (RayTraceImageHelper.h:31)

#: cap on cell-walk rounds per (segment, sub-length). Real rays take ~12
#: cells per whole trace; the cap only ends a walk whose state went
#: non-finite (NaN z never reaches the stop distance), which would otherwise
#: never terminate. The kernel applies the same cap.
MAX_CELL_STEPS = 1 << 16

f32 = np.float32


def _f(v) -> float:
    """The f32 value of ``v`` as a Python float (exact), for use as a
    tensor scalar."""
    return float(np.float32(v))


class TraceResult(NamedTuple):
    gvl: torch.Tensor      # [B, NSEG, N_SUB] f32 path-integrated gain
    evl: torch.Tensor      # [B, NSEG, N_SUB] f32 path-integrated emissivity
    ivl: torch.Tensor      # [B, NSEG, N_SUB] i32 cell (padded layout) of last visit
    exit_x: torch.Tensor   # [B] f32
    exit_y: torch.Tensor   # [B] f32
    exit_a: torch.Tensor   # [B] f32 output angle (mrad)
    exit_b: torch.Tensor   # [B] f32
    escaped: torch.Tensor  # [B] bool ray left the plasma column
    perp: torch.Tensor     # [B] bool s_z^2 < 0.01 at exit (error -1)


def _normalize(sx, sy, sz):
    """normalize_s (RayTraceImageHelper.h:73-89): f32 sum of squares,
    1/sqrt, scale."""
    tmp = sx * sx + sy * sy + sz * sz
    inv = 1.0 / torch.sqrt(tmp)
    return sx * inv, sy * inv, sz * inv


def ray_directions(a, b, method: int):
    """Unit direction from angles in mrad (RayTraceImageHelper.h:404-418):
    ``tan`` of the f32 angle in f64, rounded to f32; reversed for the
    backward method."""
    sx = torch.tan((_f(1e-3) * a).double()).float()
    sy = torch.tan((_f(1e-3) * b).double()).float()
    sz = torch.ones_like(sx)
    if method == 1:
        sx, sy, sz = -sx, -sy, -sz
    return _normalize(sx, sy, sz)


def _propagate(act, sx, sy, sz, n0, dndx, dndy, box0, box1, box2, c):
    """Batched ``propagate`` (RayTraceImageHelper.h:270-313): adaptive
    sub-steps in a locally linear index field until the displacement leaves
    the |r| < box region or n drifts 0.05. Returns (rx, ry, rz, sx, sy, sz,
    path).

    Every division is a tensor by a tensor, one rounding each: PyTorch
    computes ``scalar / tensor`` as ``reciprocal(tensor) * scalar`` and, on
    CUDA, ``tensor / scalar`` as a product with the scalar's reciprocal,
    both of which round twice."""
    cf = f32(c)
    dz_max = float(cf * f32(1.00001)) * box2

    def const(v):
        return torch.tensor(float(v), dtype=torch.float32, device=sx.device)

    c01, three, six, twelve = const(cf * f32(0.1)), const(3), const(6), \
        const(12)
    c005 = float(cf * f32(0.05))
    rx = torch.zeros_like(sx)
    ry = torch.zeros_like(sx)
    rz = torch.zeros_like(sx)
    path = torch.zeros_like(sx)
    # entry test: r = 0 and n = n0 make it hold whenever every box is > 0
    act = act & (box0 > 0) & (box1 > 0) & (box2 > 0)
    while bool(act.any()):
        n = n0 + rx * dndx + ry * dndy
        t = (sx * dndx + sy * dndy + 1e-12) / n
        fx = dndx / n - sx * t
        fy = dndy / n - sy * t
        fz = -sz * t
        step = c01 / torch.abs(t)
        step = torch.minimum(step, dz_max)
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
        # exit test with the n of this body (the reference tests the n
        # computed one body earlier, RayTraceImageHelper.h:279)
        act = (act & (torch.abs(rx) < box0) & (torch.abs(ry) < box1)
               & (torch.abs(rz) < box2) & (torch.abs(n - n0) < 0.05))
    return rx, ry, rz, sx, sy, sz, path


def _cell_walk(seg: int, gain: DeviceGain, ray: dict, z, z_stop,
               c: float, use_emis: bool):
    """Cell walk for one (segment, sub-length) (RayTraceImageHelper.h:
    460-512). ``ray`` holds px, py, sx, sy, sz (f32) and escaped (bool) and
    is updated in place; returns (z, gvl, evl, ivl)."""
    nx_pad = gain.x.shape[1]
    xg, yg = gain.x[seg], gain.y[seg]
    cdxg, cdyg = gain.cdx[seg], gain.cdy[seg]
    n4t, g0t, E0t = gain.n4[seg], gain.g0[seg], gain.E0[seg]
    Gxt, Gyt = gain.Gx[seg], gain.Gy[seg]
    r4 = [float(v) for v in gain.range4[seg].tolist()]
    absy = bool(gain.abs_y[seg])
    nx_true, ny_true = int(gain.nx[seg]), int(gain.ny[seg])
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
        # escape test (RayTraceImageHelper.h:465-469)
        esc_now = act & ((px < r4[0]) | (px > r4[1]) | (py < r4[2])
                         | (py > r4[3]) | (sz * sz < _f(0.01)))
        ray["escaped"] = ray["escaped"] | esc_now
        work = act & ~esc_now

        # cell entry: f64 bisection + corner fetches
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
            E0c = bilinear(dxi, dyi, E0t[i1], E0t[i2], E0t[i3], E0t[i4])
            E0c = torch.clamp_min(E0c, 0.0)
        else:
            E0c = torch.zeros_like(g0c)
        gx1 = Gxt[(k1 - 1) + (k2 - 1) * (nx_pad - 1)]
        gx2 = Gxt[(k1 - 1) + k2 * (nx_pad - 1)]
        gy1 = Gyt[(k1 - 1) + (k2 - 1) * nx_pad]
        gy2 = Gyt[k1 + (k2 - 1) * nx_pad]
        # extended cell range (RayTraceImageHelper.h:492-497): f64, one cast
        exlo = (xlo - 0.1 * (xhi - xlo)).float()
        exhi = (xhi + 0.1 * (xhi - xlo)).float()
        eyhi = (yhi + 0.1 * (yhi - ylo)).float()
        eylo = (ylo - 0.1 * (yhi - ylo)).float()
        if absy:
            eylo = torch.where(k2 <= 1, -eyhi, eylo)
        dz2 = z_stop - z

        # walk within the cell (propagate2, RayTraceImageHelper.h:318-351)
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
            rx, ry, rz, nsx, nsy, nsz, path = _propagate(
                act1, l_sx, l_sy, l_sz, n0, dndx, dndy, box0, box1, box2, c)
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

        # close the cell: advance z, accumulate g*ds and E*ds
        z = torch.where(work, z + torch.abs(l_pz), z)
        gvl = torch.where(work, gvl + g0c * l_ds, gvl)
        evl = torch.where(work, evl + E0c * l_ds, evl)
        ivl = torch.where(work, i1.int(), ivl)
        for k, v in (("px", l_px), ("py", l_py), ("sx", l_sx), ("sy", l_sy),
                     ("sz", l_sz)):
            ray[k] = torch.where(work, v, ray[k])
        finished = ray["escaped"] | (z >= z_stop995)
    return z, gvl, evl, ivl


def trace_batch_plain(rays: dict, N: int, dz0: float, gain: DeviceGain,
                      method: int, c: float = 0.5,
                      use_emis: bool = True) -> TraceResult:
    """Propagate a batch of rays through all N-1 length segments.

    ``rays``: dict of f32 tensors ``x, y, a, b`` of shape [B] (entry
    position, angles in mrad) on the gain tables' device. ``method``: 1 =
    backward (ASE), 2 = forward (seeded). Returns per-(segment,
    sub-length) path integrals and the exit ray. ``N = 1`` gives empty
    ``[B, 0, 3]`` path integrals and the entry ray as the exit ray.
    """
    B = rays["x"].shape[0]
    dev = rays["x"].device
    nseg = max(N - 1, 0)
    sx, sy, sz = ray_directions(rays["a"], rays["b"], method)
    ray = {"px": rays["x"].float(), "py": rays["y"].float(),
           "sx": sx, "sy": sy, "sz": sz,
           "escaped": torch.zeros(B, dtype=torch.bool, device=dev)}
    gvl_all = torch.zeros((B, nseg, N_SUB), dtype=torch.float32, device=dev)
    evl_all = torch.zeros_like(gvl_all)
    ivl_all = torch.zeros((B, nseg, N_SUB), dtype=torch.int32, device=dev)
    dz0_f = f32(dz0)
    for i in range(nseg):
        # high-energy-side segment indexing (RayTraceImageHelper.h:430-441)
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
    return _exit_ray(ray, gvl_all, evl_all, ivl_all)


def _exit_ray(ray, gvl, evl, ivl) -> TraceResult:
    """Output ray (RayTraceImageHelper.h:514-521): ``atan`` in f64."""
    sx, sy, sz = ray["sx"], ray["sy"], ray["sz"]
    perp = sz * sz < _f(0.01)
    exit_a = torch.atan((sx / sz).double()).float() * 1e3
    exit_b = torch.atan((sy / sz).double()).float() * 1e3
    return TraceResult(gvl=gvl, evl=evl, ivl=ivl,
                       exit_x=ray["px"], exit_y=ray["py"],
                       exit_a=exit_a, exit_b=exit_b,
                       escaped=ray["escaped"], perp=perp)
