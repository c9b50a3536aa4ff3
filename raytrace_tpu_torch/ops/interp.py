"""Search and interpolation primitives on tensors.

Tensor versions of ``raytrace_tpu.ops.interp`` (the reference's scalar
helpers, src/common/RayTraceImageHelper.h:101-220):

* :func:`find_first_single` -- batched ``findfirstsingle``
* :func:`find_index`        -- batched ``findindex``
* :func:`bilinear`          -- float32 bilinear blend
* :func:`interp_linear`     -- batched ``interp::interp_linear``
* :func:`pchip_coefficients` / :func:`pchip_eval` -- monotone cubic hermite
  with the limited gradients precomputed per interval on the host

For a sorted grid, ``count(grid < y)`` is the first index with
``grid[idx] >= y``, which is what the reference's bisection returns;
``torch.searchsorted(..., side="left")`` computes that count directly.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["find_first_single", "find_index", "bilinear", "interp_linear",
           "pchip_coefficients", "pchip_eval"]


def find_first_single(grid: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """First index i with grid[i] >= y; len(grid) if none (int64).

    Matches ``findfirstsingle`` (RayTraceImageHelper.h:101-117) including
    its edges: y < grid[0] -> 0, y > grid[-1] -> n, and otherwise the
    bisection result in [1, n-1] (1, not 0, for y == grid[0]).
    """
    n = grid.shape[0]
    y = y.to(grid.dtype)
    count = torch.searchsorted(grid, y.contiguous(), side="left")
    mid = count.clamp(1, n - 1)
    return torch.where(y < grid[0], torch.zeros_like(mid),
                       torch.where(y > grid[n - 1], torch.full_like(mid, n),
                                   mid))


def find_index(grid: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Interpolation-interval index in [1, n-1] (``findindex``,
    RayTraceImageHelper.h:131-143)."""
    n = grid.shape[0]
    return find_first_single(grid, y).clamp(1, n - 1)


def bilinear(dx, dy, f1, f2, f3, f4):
    """float32 bilinear blend (RayTraceImageHelper.h:153-158), evaluated in
    the reference's operation order."""
    dx2 = 1.0 - dx
    dy2 = 1.0 - dy
    return (dx * f2 + dx2 * f1) * dy2 + (dx * f4 + dx2 * f3) * dy


def interp_linear(xi: torch.Tensor, yi: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """Batched linear interpolation on the interval ``find_first_single``
    picks, clamped to [1, n-1], so it extrapolates linearly past both ends
    (``interp::interp_linear``, src/AtomicModel/interp.cpp:9-22)."""
    i = find_first_single(xi, x).clamp(1, xi.shape[0] - 1)
    x0 = xi[i - 1]
    dx = (x - x0) / (xi[i] - x0)
    return (1.0 - dx) * yi[i - 1] + dx * yi[i]


def pchip_coefficients(xi, yi):
    """Limited hermite gradients (g1, g2) for every interval, as float64
    numpy arrays indexed by interval - 1 (``interp_pchip``'s gradient rule,
    RayTraceImageHelper.h:181-214, computed once on the host)."""
    xi = np.asarray(xi, dtype=np.float64)
    yi = np.asarray(yi, dtype=np.float64)
    n = len(xi)
    if n < 2:
        raise ValueError("pchip needs at least 2 points")
    f1 = yi[:-1]
    f2 = yi[1:]
    g1 = np.zeros(n - 1)
    g2 = np.zeros(n - 1)

    # gradient at the interval start; interval 1 has no left neighbour
    g1[0] = f2[0] - f1[0]
    if n > 2:
        i = np.arange(2, n)
        fm, fa, fb = yi[i - 2], yi[i - 1], yi[i]
        monotone = ((fa < fb) & (fa > fm)) | ((fa > fb) & (fa < fm))
        dx1 = xi[i - 1] - xi[i - 2]
        dx2 = xi[i] - xi[i - 1]
        a1 = (dx2 - dx1) / dx1
        a2 = dx1 / (dx1 + dx2)
        g = a1 * (fa - fm) + a2 * (fb - fm)
        g_max = 2 * dx2 * np.minimum(np.abs(fa - fm) / dx1,
                                     np.abs(fb - fa) / dx2)
        g_lim = np.where(g >= 0, 1.0, -1.0) * np.minimum(np.abs(g), g_max)
        g1[i - 1] = np.where(monotone, g_lim, 0.0)

    # gradient at the interval end; the last interval has no right neighbour
    g2[n - 2] = f2[n - 2] - f1[n - 2]
    if n > 2:
        i = np.arange(1, n - 1)
        fa, fb, fp = yi[i - 1], yi[i], yi[i + 1]
        monotone = ((fb < fa) & (fb > fp)) | ((fb > fa) & (fb < fp))
        dx1 = xi[i] - xi[i - 1]
        dx2 = xi[i + 1] - xi[i]
        a1 = -dx2 / (dx1 + dx2)
        a2 = (dx2 - dx1) / dx2
        g = a1 * (fa - fp) + a2 * (fb - fp)
        g_max = 2 * dx1 * np.minimum(np.abs(fb - fa) / dx1,
                                     np.abs(fp - fb) / dx2)
        g_lim = np.where(g >= 0, 1.0, -1.0) * np.minimum(np.abs(g), g_max)
        g2[i - 1] = np.where(monotone, g_lim, 0.0)
    return g1, g2


def pchip_eval(xi, yi, g1, g2, x):
    """Batched hermite evaluation matching ``interp_pchip``
    (RayTraceImageHelper.h:168-220): linear extrapolation at both ends and
    the linear fallback for two-point grids. All arguments are float64
    tensors on one device."""
    n = xi.shape[0]
    i = find_first_single(xi, x).clamp(1, n - 1)
    f1 = yi[i - 1]
    f2 = yi[i]
    dx = (x - xi[i - 1]) / (xi[i] - xi[i - 1])
    gg1 = g1[i - 1]
    gg2 = g2[i - 1]
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
