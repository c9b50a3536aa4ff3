"""Image binning: deposit per-ray spectra into the near-field image and the
far-field angular image (the scatter-add of ``RayTraceImageCPULoop``,
src/RayTraceImageCPU.cpp:37-68).

* backward (ASE, method 1) rays bin at their *entry* coordinates;
* forward (seeded, method 2) rays bin at their *exit* coordinates, angles
  negated and y mirrored onto a half-plane beam grid;
* ``getIndex`` = half-cell-shifted first-greater search in f64, -1 outside
  the half-cell-padded extent (src/RayTraceImageCPU.cpp:11-16);
* ``image[nv*(i1 + i2*nx) + iv] += Iv*scale``,
  ``I_ang[i3 + i4*na] += sum_v 2 dv Iv``.

The index math here is the plain version; :func:`bin_images` hands a chunk
to one binning deposit (kernel B2, which computes the bins itself, or its
plain twin, ``ops/deposit_kernel.py``) that adds straight into the call's
f64 accumulators; rays that failed or bin outside the grid deposit nothing.
"""

from __future__ import annotations

import torch

from raytrace_tpu_torch.models.problem import DeviceBeam
from raytrace_tpu_torch.ops.interp import find_first_single

__all__ = ["get_index", "source_coords", "bin_indices", "bin_images"]


def get_index(grid: torch.Tensor, d: float, y: torch.Tensor) -> torch.Tensor:
    """Vectorised ``getIndex`` (RayTraceImageCPU.cpp:11-16) in f64:
    findfirstsingle(grid, y - d/2), or -1 outside the padded extent."""
    y = y.to(torch.float64)
    n = grid.shape[0]
    idx = find_first_single(grid, y - 0.5 * d)
    bad = (y < grid[0] - 0.5 * d) | (y > grid[n - 1] + 0.5 * d)
    return torch.where(bad, torch.full_like(idx, -1), idx)


def source_coords(res, rays: dict, method: int):
    """The [B] f32 coordinates (x, y, a, b) a chunk bins from: the entry
    rays for method 1, the trace's exit rays for method 2."""
    if method == 1:
        return rays["x"], rays["y"], rays["a"], rays["b"]
    return res.exit_x, res.exit_y, res.exit_a, res.exit_b


def bin_indices(coords, ok, beam: DeviceBeam, method: int) -> torch.Tensor:
    """[B, 2] i32: each ray's image bin ``i1 + i2*nx`` and angle bin
    ``i3 + i4*na``, -1 where the ray is not ``ok`` or lands outside that
    grid (what kernel B2 writes to its optional bins output). ``coords``
    from :func:`source_coords`; method 2 bins them with negated angles and,
    on a half-plane beam, y mirrored."""
    nx, ny = beam.x.shape[0], beam.y.shape[0]
    na, nb = beam.a.shape[0], beam.b.shape[0]
    bx, by, ba, bb = coords
    if method == 2:
        if beam.y0_nonneg:
            by = torch.where(by < 0, -by, by)
        ba, bb = -ba, -bb
    i1 = get_index(beam.x, beam.dx, bx)
    i2 = get_index(beam.y, beam.dy, by)
    i3 = get_index(beam.a, beam.da, ba)
    i4 = get_index(beam.b, beam.db, bb)
    img = i1 + i2 * nx
    img = torch.where(ok & (i1 >= 0) & (i2 >= 0) & (img < nx * ny), img, -1)
    ang = i3 + i4 * na
    ang = torch.where(ok & (i3 >= 0) & (i4 >= 0) & (ang < na * nb), ang, -1)
    return torch.stack([img, ang], dim=1).to(torch.int32)


def bin_images(Iv, res, rays: dict, beam: DeviceBeam, method: int,
               scale: float, valid, image_acc, iang_acc, deposit) -> None:
    """Deposit a batch of spectra into the call's accumulators, in place.

    ``Iv``: [B, K] f64, or f32 for the f32 spectrum; ``valid``: [B] bool (failed rays are left out, as
    the reference ``continue``s on error); ``image_acc``: [nx*ny, K] f64
    in cell-major reference layout; ``iang_acc``: [na*nb, 1] f64;
    ``deposit``: ``deposit_kernel.bin_deposit`` (kernel B2) or its twin
    ``bin_deposit_plain``.
    """
    deposit(Iv, source_coords(res, rays, method), valid, beam, method, scale,
            image_acc, iang_acc)
