"""Single-ray diagnostic APIs mirroring ``src/RayTrace.h:37-95``.

* :func:`calc_ray`      <- ``RayTrace::calc_ray``      (RayTraceImage.cpp:189-204)
* :func:`calc_seed`     <- ``RayTrace::calc_seed``     (RayTraceImage.cpp:210-214)
* :func:`calc_ray_path` <- ``RayTrace::calc_ray_path`` (RayTraceImage.cpp:440-477)

These run the scalar numpy oracle (:mod:`raytrace_tpu_torch.ops.oracle`,
the kernel math loop for loop) on the host and take no device; they are
test surfaces and debugging tools, not hot paths. They take and return
numpy arrays, as ``raytrace_tpu.api`` does.
"""

from __future__ import annotations

import numpy as np

from raytrace_tpu_torch.ops import oracle
from raytrace_tpu_torch.structures import RayGain, RaySeed

__all__ = ["calc_ray", "calc_ray_path", "calc_seed"]


def calc_ray(ray_in, N: int, dz0: float, gain: list[RayGain],
             seed: RaySeed | None, K: int, method: int):
    """Propagate a single ray on the host; returns (error, Iv [K],
    ray_out [4])."""
    res = oracle.calc_ray(tuple(ray_in), N, dz0, gain, seed, K, method)
    return res.error, res.Iv, res.ray_out


def calc_seed(seed: RaySeed, x: float, y: float, a: float, b: float):
    """Seed spectrum at a phase-space point, on the host; returns Iv
    [dim[4]]."""
    return oracle.calc_seed(seed, x, y, a, b)


def calc_ray_path(x, y, a, b, N: int, dz: float, gain: list[RayGain],
                  seed: RaySeed | None, K: int, dv, method: int, c: float = 0.5):
    """Trajectories + running intensity at every sub-length station for the
    full (x, y, a, b) grid of rays, traced one by one on the host.

    Returns (n_errors, xr, yr, Ir), each array shaped
    [len(x), len(y), len(a), len(b), N_SUB*(N-1)+1] (the reference returns
    the same data flattened station-fastest, RayTraceImage.cpp:463-468).
    """
    x, y, a, b = (np.atleast_1d(np.asarray(v, np.float64)) for v in (x, y, a, b))
    dv = np.asarray(dv, np.float64)
    n_st = oracle.N_SUB * (N - 1) + 1
    shape = (len(x), len(y), len(a), len(b), n_st)
    xr = np.zeros(shape, np.float32)
    yr = np.zeros(shape, np.float32)
    ir = np.zeros(shape, np.float32)
    n_errors = 0
    for i in range(len(x)):
        for j in range(len(y)):
            for k in range(len(a)):
                for m in range(len(b)):
                    res = oracle.calc_ray(
                        (x[i], y[j], a[k], b[m]), N, dz, gain, seed, K, method,
                        c=c, debug_dv=dv)
                    xr[i, j, k, m] = res.debug[0]
                    yr[i, j, k, m] = res.debug[1]
                    ir[i, j, k, m] = res.debug[2]
                    if res.error:
                        n_errors += 1
    return n_errors, xr, yr, ir
