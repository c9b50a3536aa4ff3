"""Device-side problem representation: stacked, padded tensors.

The reference hands its kernel an array-of-structs with raw pointers
(``ray_gain_struct*``, src/RayTraceStructures.h:218-272) and deep-copies it
to the device per call (src/RayTraceImageCuda.cu:225-289). The port builds
the struct-of-arrays layout of ``raytrace_tpu.models.problem`` on the host
in numpy and copies it to the requested device once per call:

* per-segment gain tables stacked to ``[N, ...]`` and padded to the largest
  (Nx, Ny), with flat cell index ``i + j*Nx`` like the reference;
* x/y grids stay **float64** (``findindex`` and the cell edges compare in
  f64, RayTraceStructures.h:215-217); n, g0, E0 are f32; the edge gradients
  Gx/Gy are computed from f64 differences and stored f32; cdx/cdy are the
  f32 casts of f64 differences;
* the separable seed factors with their pchip gradients.

A call writes its tables into one host buffer (pinned for a CUDA device)
and copies that buffer to the device at once: :func:`table_layout` places
each table from the shapes alone, and :func:`write_tables` writes each one
straight into its place, so that the buffer may be one a CUDA graph reads
(``models/ray_tracer.py``). Its plain twin builds the tables as host numpy
arrays (``*_arrays``, :func:`table_arrays`) and copies them in
(:func:`pack_arrays`). :func:`unpack_arrays` cuts the device copy back into
tensors (views of the one buffer), and the ``*_from_tensors`` functions
assemble the device structures from them.

Every function takes an explicit ``device``; nothing here keeps global
device state.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from raytrace_tpu_torch.ops import interp
from raytrace_tpu_torch.structures import RayGain, RaySeed

__all__ = ["DeviceGain", "DeviceSeed", "DeviceBeam", "gain_arrays",
           "gain_to_device", "prepare_gain", "seed_arrays", "seed_scalars",
           "seed_from_tensors", "beam_arrays", "beam_scalars",
           "beam_from_tensors", "prepare_beam",
           "pack_arrays", "unpack_arrays", "layout_nbytes",
           "table_arrays", "table_layout", "table_views", "write_tables"]


class DeviceGain(NamedTuple):
    """Stacked per-segment gain tables (leading dim = segment 0..N-1)."""

    x: torch.Tensor        # [N, Nx]  f64 grid
    y: torch.Tensor        # [N, Ny]  f64
    cdx: torch.Tensor      # [N, Nx-1] f32 cell widths (f32 of f64 difference)
    cdy: torch.Tensor      # [N, Ny-1] f32
    n4: torch.Tensor       # [N, Nx*Ny] f32 index of refraction
    g0: torch.Tensor       # [N, Nx*Ny] f32 gain at line centre
    E0: torch.Tensor       # [N, Nx*Ny] f32 emissivity (zeros if absent)
    Gx: torch.Tensor       # [N, (Nx-1)*Ny] f32 dn/dx per x-edge, f64-accurate
    Gy: torch.Tensor       # [N, Nx*(Ny-1)] f32 dn/dy per y-edge
    gv: torch.Tensor       # [N, Nx*Ny, K] f32 lineshape (cell-major rows)
    gv0: torch.Tensor      # [N, Nx*Ny] f32 lineshape at line centre
    range4: torch.Tensor   # [N, 4] f32 plasma extents (x0, x1, y0_mirrored, y1)
    abs_y: torch.Tensor    # [N] bool half-plane mirror flag
    nx: torch.Tensor       # [N] i32 true Nx per segment (<= padded)
    ny: torch.Tensor       # [N] i32


class DeviceSeed(NamedTuple):
    """Separable seed tables with pchip gradients (ray_seed_struct)."""

    xs: tuple              # 4x [dim_i] f64 grids (x, y, a, b)
    fs: tuple              # 4x [dim_i] f64 factors
    g1s: tuple             # 4x [dim_i - 1] f64 gradients at interval starts
    g2s: tuple             # 4x [dim_i - 1] f64 gradients at interval ends
    fv: torch.Tensor       # [K] f64 frequency profile f[4]
    f0: float
    lo: tuple              # 4 grid lower bounds
    hi: tuple              # 4 grid upper bounds


class DeviceBeam(NamedTuple):
    """EUV output-beam grids needed on the device for binning."""

    x: torch.Tensor   # [nx] f64
    y: torch.Tensor   # [ny] f64
    a: torch.Tensor   # [na] f64
    b: torch.Tensor   # [nb] f64
    dv: torch.Tensor  # [nv] f64
    dx: float
    dy: float
    da: float
    db: float
    y0_nonneg: bool   # beam.y[0] >= 0: the mirror rule for binning


def gain_arrays(gains: list[RayGain]) -> dict:
    """Host numpy arrays of the DeviceGain layout, field by field the same
    values ``raytrace_tpu.models.problem.prepare_gain`` builds."""
    nx_max = max(g.Nx for g in gains)
    ny_max = max(g.Ny for g in gains)
    K = gains[0].Nv
    cols = {name: [] for name in DeviceGain._fields}
    for g in gains:
        Nx, Ny = g.Nx, g.Ny
        x64 = np.asarray(g.x, dtype=np.float64)
        y64 = np.asarray(g.y, dtype=np.float64)
        n64 = np.asarray(g.n, dtype=np.float64).reshape(Ny, Nx)  # [j, i]
        # plasma extents: a half-plane grid (y[0] >= 0) mirrors y
        r0, r1 = np.float32(x64[0]), np.float32(x64[-1])
        r2, r3 = np.float32(y64[0]), np.float32(y64[-1])
        abs_y = bool(r2 >= 0)
        if abs_y:
            r2 = np.float32(-r3)
        cols["range4"].append(np.array([r0, r1, r2, r3], dtype=np.float32))
        cols["abs_y"].append(abs_y)
        cols["nx"].append(Nx)
        cols["ny"].append(Ny)

        def grow(arr, n_to):
            # padded grid points keep increasing; the physics stays on the
            # true grid through range4 and the nx/ny clamps
            if len(arr) == n_to:
                return arr
            step = arr[-1] - arr[-2] if len(arr) > 1 else 1.0
            return np.concatenate(
                [arr, arr[-1] + step * np.arange(1, n_to - len(arr) + 1)])

        xp = grow(x64, nx_max)
        yp = grow(y64, ny_max)
        cols["x"].append(xp)
        cols["y"].append(yp)
        cols["cdx"].append(np.diff(xp).astype(np.float32))
        cols["cdy"].append(np.diff(yp).astype(np.float32))

        Gx = (n64[:, 1:] - n64[:, :-1]) / (x64[None, 1:] - x64[None, :-1])
        Gy = (n64[1:, :] - n64[:-1, :]) / (y64[1:, None] - y64[:-1, None])

        def pad2(t, ny_t, nx_t):
            out = np.zeros((ny_t, nx_t), dtype=np.float32)
            out[: t.shape[0], : t.shape[1]] = t
            return out.reshape(-1)

        def cell2(arr):
            return pad2(np.asarray(arr, np.float32).reshape(Ny, Nx),
                        ny_max, nx_max)

        cols["n4"].append(pad2(n64.astype(np.float32), ny_max, nx_max))
        cols["g0"].append(cell2(g.g0))
        cols["E0"].append(cell2(g.E0 if g.E0 is not None
                                else np.zeros(Nx * Ny, np.float32)))
        cols["Gx"].append(pad2(Gx.astype(np.float32), ny_max, nx_max - 1))
        cols["Gy"].append(pad2(Gy.astype(np.float32), ny_max - 1, nx_max))
        gvp = np.zeros((ny_max, nx_max, K), dtype=np.float32)
        gvp[:Ny, :Nx] = np.asarray(g.gv, np.float32).reshape(Ny, Nx, K)
        cols["gv"].append(gvp.reshape(-1, K))
        cols["gv0"].append(cell2(g.gv0))
    out = {k: np.stack(v) for k, v in cols.items()
           if k not in ("abs_y", "nx", "ny")}
    out["abs_y"] = np.asarray(cols["abs_y"], bool)
    out["nx"] = np.asarray(cols["nx"], np.int32)
    out["ny"] = np.asarray(cols["ny"], np.int32)
    return out


def gain_to_device(arrays, device) -> DeviceGain:
    """DeviceGain from host arrays (a mapping or an object with the
    DeviceGain field names), each copied to ``device`` unchanged."""
    get = (arrays.__getitem__ if isinstance(arrays, dict)
           else lambda k: getattr(arrays, k))
    return DeviceGain(**{
        k: torch.from_numpy(np.ascontiguousarray(np.asarray(get(k))))
        .to(device) for k in DeviceGain._fields})


def prepare_gain(gains: list[RayGain], device="cpu") -> DeviceGain:
    """Stacked gain tables of ``gains`` on ``device``."""
    return gain_to_device(gain_arrays(gains), device)


def seed_arrays(seed: RaySeed) -> dict:
    """Host f64 arrays of the DeviceSeed layout, with the pchip gradients
    computed here: ``x<a>``, ``f<a>``, ``g1_<a>``, ``g2_<a>`` per axis a of
    (x, y, a, b), and the frequency profile ``fv``."""
    out = {}
    for axis in range(4):
        xi = np.asarray(seed.x[axis], np.float64)
        fi = np.asarray(seed.f[axis], np.float64)
        g1, g2 = interp.pchip_coefficients(xi, fi)
        out.update({f"x{axis}": xi, f"f{axis}": fi, f"g1_{axis}": g1,
                    f"g2_{axis}": g2})
    out["fv"] = np.asarray(seed.f[4], np.float64)
    return out


def seed_scalars(seed: RaySeed) -> tuple:
    """The DeviceSeed fields that are host scalars: ``(f0, lo, hi)``."""
    return (float(seed.f0), tuple(float(seed.x[i][0]) for i in range(4)),
            tuple(float(seed.x[i][-1]) for i in range(4)))


def seed_from_tensors(t: dict, scalars: tuple) -> DeviceSeed:
    """DeviceSeed from the tensors of :func:`seed_arrays` and the
    :func:`seed_scalars` of its seed."""
    f0, lo, hi = scalars
    return DeviceSeed(
        xs=tuple(t[f"x{a}"] for a in range(4)),
        fs=tuple(t[f"f{a}"] for a in range(4)),
        g1s=tuple(t[f"g1_{a}"] for a in range(4)),
        g2s=tuple(t[f"g2_{a}"] for a in range(4)),
        fv=t["fv"], f0=f0, lo=lo, hi=hi)


def beam_arrays(beam) -> dict:
    """Host f64 arrays of the DeviceBeam grids."""
    return {k: np.asarray(getattr(beam, k), np.float64)
            for k in ("x", "y", "a", "b", "dv")}


def beam_scalars(beam) -> tuple:
    """The DeviceBeam fields that are host scalars: ``(dx, dy, da, db,
    y0_nonneg)``."""
    return (float(beam.dx), float(beam.dy), float(beam.da), float(beam.db),
            bool(beam.y[0] >= 0.0))


def beam_from_tensors(t: dict, scalars: tuple) -> DeviceBeam:
    """DeviceBeam from the tensors of :func:`beam_arrays` and the
    :func:`beam_scalars` of its beam."""
    dx, dy, da, db, y0_nonneg = scalars
    return DeviceBeam(x=t["x"], y=t["y"], a=t["a"], b=t["b"], dv=t["dv"],
                      dx=dx, dy=dy, da=da, db=db, y0_nonneg=y0_nonneg)


def prepare_beam(beam, device="cpu") -> DeviceBeam:
    """The EUV beam's grids on ``device``."""
    return beam_from_tensors({k: torch.as_tensor(v, device=device)
                              for k, v in beam_arrays(beam).items()},
                             beam_scalars(beam))


#: byte alignment of each array in a packed buffer (>= every itemsize, so
#: every view of the buffer is aligned for its dtype)
_ALIGN = 16


def _padded(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


def _layout_of(fields) -> list:
    """The packed layout of ``(name, dtype, shape)`` fields, in their
    order: ``(name, offset, dtype, shape)`` each, every offset a multiple
    of ``_ALIGN``."""
    layout, off = [], 0
    for name, dtype, shape in fields:
        dtype = np.dtype(dtype)
        layout.append((name, off, dtype, tuple(shape)))
        off += _padded(math.prod(shape) * dtype.itemsize)
    return layout


def layout_nbytes(layout) -> int:
    """The bytes of a buffer packed by ``layout``."""
    if not layout:
        return _ALIGN
    _name, off, dtype, shape = layout[-1]
    return max(off + _padded(math.prod(shape) * dtype.itemsize), _ALIGN)


def pack_arrays(arrays: dict, pin: bool = False):
    """Pack named host arrays into one uint8 tensor (page-locked with
    ``pin``, so that a copy to a CUDA device can run asynchronously).
    Returns ``(buffer, layout)`` for :func:`unpack_arrays`."""
    arrays = {name: np.asarray(a) for name, a in arrays.items()}
    layout = _layout_of((name, a.dtype, a.shape)
                        for name, a in arrays.items())
    buf = torch.empty(layout_nbytes(layout), dtype=torch.uint8,
                      pin_memory=pin)
    view = buf.numpy()
    for (_name, o, _dtype, _shape), a in zip(layout, arrays.values()):
        a = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        view[o:o + a.size] = a
    return buf, layout


def table_arrays(gains: list[RayGain], beam, src, seed=None) -> dict:
    """A call's tables as named host arrays, in the order they are packed:
    the gain tables (``gain.*``, :func:`gain_arrays`), the EUV beam's grids
    (``beam.*``), the source beam's grids as f32 (``grid.x`` .. ``grid.b``)
    and, with a ``seed``, its tables (``seed.*``, :func:`seed_arrays`).
    ``pack_arrays`` of them is the plain twin of :func:`write_tables`."""
    arrays = {f"gain.{k}": v for k, v in gain_arrays(gains).items()}
    arrays.update({f"beam.{k}": v for k, v in beam_arrays(beam).items()})
    for axis, grid in zip("xyab", (src.x, src.y, src.a, src.b)):
        arrays[f"grid.{axis}"] = np.asarray(grid, np.float64).astype(
            np.float32)
    if seed is not None:
        arrays.update({f"seed.{k}": v for k, v in seed_arrays(seed).items()})
    return arrays


def table_layout(gains: list[RayGain], beam, src, seed=None) -> list:
    """The layout :func:`pack_arrays` gives :func:`table_arrays`, from the
    tables' shapes alone (no value is read): the segment count, the largest
    Nx and Ny, K, the beams' grids and the seed's dims."""
    f64, f32 = np.float64, np.float32
    N = len(gains)
    nx = max(g.Nx for g in gains)
    ny = max(g.Ny for g in gains)
    K = gains[0].Nv
    cells = (N, nx * ny)
    fields = [("gain.x", f64, (N, nx)), ("gain.y", f64, (N, ny)),
              ("gain.cdx", f32, (N, nx - 1)), ("gain.cdy", f32, (N, ny - 1)),
              ("gain.n4", f32, cells), ("gain.g0", f32, cells),
              ("gain.E0", f32, cells), ("gain.Gx", f32, (N, ny * (nx - 1))),
              ("gain.Gy", f32, (N, (ny - 1) * nx)),
              ("gain.gv", f32, cells + (K,)), ("gain.gv0", f32, cells),
              ("gain.range4", f32, (N, 4)), ("gain.abs_y", np.bool_, (N,)),
              ("gain.nx", np.int32, (N,)), ("gain.ny", np.int32, (N,))]
    fields += [(f"beam.{k}", f64, np.shape(getattr(beam, k)))
               for k in ("x", "y", "a", "b", "dv")]
    fields += [(f"grid.{axis}", f32, np.shape(grid))
               for axis, grid in zip("xyab", (src.x, src.y, src.a, src.b))]
    if seed is not None:
        for a in range(4):
            n = len(seed.x[a])
            fields += [(f"seed.x{a}", f64, (n,)),
                       (f"seed.f{a}", f64, np.shape(seed.f[a])),
                       (f"seed.g1_{a}", f64, (n - 1,)),
                       (f"seed.g2_{a}", f64, (n - 1,))]
        fields.append(("seed.fv", f64, np.shape(seed.f[4])))
    return _layout_of(fields)


def table_views(buf, layout) -> dict:
    """Numpy views of the uint8 tensor or array ``buf``, one a field of
    ``layout`` (:func:`table_layout`), for :func:`write_tables`; the gain
    tables by cell are shaped by their grid: ``[N, Ny, Nx]`` (``n4``,
    ``g0``, ``E0``, ``gv0``), ``[N, Ny, Nx - 1]`` (``Gx``), ``[N, Ny - 1,
    Nx]`` (``Gy``) and ``[N, Ny, Nx, K]`` (``gv``)."""
    mem = buf.numpy() if isinstance(buf, torch.Tensor) else buf
    v = {name: np.ndarray(shape, dtype, buffer=mem, offset=off)
         for name, off, dtype, shape in layout}
    N, nx = v["gain.x"].shape
    ny = v["gain.y"].shape[1]
    K = v["gain.gv"].shape[2]
    for k in ("n4", "g0", "E0", "gv0"):
        v[f"gain.{k}"] = v[f"gain.{k}"].reshape(N, ny, nx)
    v["gain.Gx"] = v["gain.Gx"].reshape(N, ny, nx - 1)
    v["gain.Gy"] = v["gain.Gy"].reshape(N, ny - 1, nx)
    v["gain.gv"] = v["gain.gv"].reshape(N, ny, nx, K)
    return v


def write_tables(views: dict, gains: list[RayGain], beam, src,
                 seed=None) -> None:
    """Write a call's tables into their buffer, each straight into its view
    (:func:`table_views`): over every field's bytes, what
    :func:`pack_arrays` of :func:`table_arrays` holds. Every cell is
    written, the zeros of a segment padded to the largest grid too, so the
    buffer may hold an earlier call's tables."""
    v = views
    n4, g0, E0, gv0, Gx, Gy, gv = (v[f"gain.{k}"] for k in (
        "n4", "g0", "E0", "gv0", "Gx", "Gy", "gv"))
    xs, ys, r = v["gain.x"], v["gain.y"], v["gain.range4"]
    ny, nx, K = gv.shape[1:]
    for s, g in enumerate(gains):
        Nx, Ny = g.Nx, g.Ny
        x64 = np.asarray(g.x, np.float64)
        y64 = np.asarray(g.y, np.float64)
        n64 = np.asarray(g.n, np.float64).reshape(Ny, Nx)
        for grid, dst in ((x64, xs[s]), (y64, ys[s])):
            # padded grid points keep increasing by the last step
            dst[:len(grid)] = grid
            if len(grid) < len(dst):
                step = grid[-1] - grid[-2] if len(grid) > 1 else 1.0
                dst[len(grid):] = grid[-1] + step * np.arange(
                    1, len(dst) - len(grid) + 1)
        # plasma extents, f32, mirrored below
        r[s] = (x64[0], x64[-1], y64[0], y64[-1])
        # n and its edge gradients in f64, cast to f32 into the views
        n4[s, :Ny, :Nx] = n64
        np.divide(n64[:, 1:] - n64[:, :-1], x64[1:] - x64[:-1],
                  out=Gx[s, :Ny, :Nx - 1], casting="unsafe")
        np.divide(n64[1:] - n64[:-1], (y64[1:] - y64[:-1])[:, None],
                  out=Gy[s, :Ny - 1, :Nx], casting="unsafe")
        for dst, arr in ((g0[s], g.g0), (E0[s], g.E0), (gv0[s], g.gv0)):
            if arr is None:  # no emissivity: E0 is zeros
                dst[...] = 0
            else:
                dst[:Ny, :Nx] = np.asarray(arr).reshape(Ny, Nx)
        gv[s, :Ny, :Nx] = np.asarray(g.gv).reshape(Ny, Nx, K)
        if (Ny, Nx) != (ny, nx):
            # the cells beyond the segment's grid are zeros
            for t, ty, tx in ((n4, Ny, Nx), (Gx, Ny, Nx - 1),
                              (Gy, Ny - 1, Nx), (g0, Ny, Nx), (E0, Ny, Nx),
                              (gv0, Ny, Nx), (gv, Ny, Nx)):
                t[s, ty:] = 0
                t[s, :ty, tx:] = 0
    for grid, cd in ((xs, v["gain.cdx"]), (ys, v["gain.cdy"])):
        np.subtract(grid[:, 1:], grid[:, :-1], out=cd, casting="unsafe")
    # a half-plane grid (y[0] >= 0) mirrors y
    abs_y = v["gain.abs_y"]
    np.greater_equal(r[:, 2], 0, out=abs_y)
    r[abs_y, 2] = -r[abs_y, 3]
    v["gain.nx"][:] = [g.Nx for g in gains]
    v["gain.ny"][:] = [g.Ny for g in gains]
    for k in ("x", "y", "a", "b", "dv"):
        v[f"beam.{k}"][...] = np.asarray(getattr(beam, k), np.float64)
    for axis, grid in zip("xyab", (src.x, src.y, src.a, src.b)):
        v[f"grid.{axis}"][...] = np.asarray(grid, np.float64)
    if seed is not None:
        for k, a in seed_arrays(seed).items():
            v[f"seed.{k}"][...] = a


def unpack_arrays(buf: torch.Tensor, layout) -> dict:
    """Tensors of a packed buffer (on whatever device ``buf`` lies), views
    of it by the ``layout`` of :func:`pack_arrays`."""
    out = {}
    for name, off, dtype, shape in layout:
        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        out[name] = buf[off:off + nbytes].view(tdtype).reshape(shape)
    return out
