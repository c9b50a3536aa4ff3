"""Replay a ``Failed_RayTrace_rays.dat`` dump through the scalar oracle.

The failure pipeline (``utils/errors.py``, mirroring write_failures at
src/RayTraceImage.cpp:140-183) dumps the failed rays together with the
full gain tables so the failure is reproducible offline. The reference
ships no reader for its own dump; this tool closes the loop:

* parse the dump (``utils.errors.read_failures``),
* re-trace every captured ray with ``ops.oracle.calc_ray`` (the scalar
  ground-truth implementation of RayTrace_calc_ray,
  src/common/RayTraceImageHelper.h:379-595),
* report each ray's error code (-1 perpendicular, -2 negative intensity,
  -3 NaN), its exit state, and per-segment gain sums.

The dump carries no seed tables (the reference's doesn't either), so a
seeded run's rays replay with Iv0 = 0 -- trace-level behavior (step
sequence, escape, gain accumulation, code -1) is identical; codes
-2/-3 that arose from seed-dependent amplification may not reproduce,
and the tool says so when method == 2.

Runs on the host and needs no device. Usage:

    python -m raytrace_tpu_torch.tools.replay_failed_rays [Failed_RayTrace_rays.dat]

Exit code = number of rays that did NOT reproduce a failure.
"""

import sys

import numpy as np


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "Failed_RayTrace_rays.dat"
    from raytrace_tpu_torch.ops import oracle
    from raytrace_tpu_torch.utils.errors import (failure_messages,
                                                 read_failures)

    rays, method, N, dz, gains = read_failures(path)
    K = gains[1].Nv if len(gains) > 1 and gains[1].Nv else 1
    print(f"{path}: {rays.shape[0]} failed ray(s), method={method}, "
          f"N={N}, dz={dz}, K={K}, "
          f"grids={[(g.Nx, g.Ny) for g in gains]}")
    if method == 2:
        print("NOTE: seeded dump replays with Iv0=0 (the dump format "
              "carries no seed tables); -2/-3 codes that depended on the "
              "seed amplitude may not reproduce.")

    not_reproduced = 0
    for t, (x, y, a, b) in enumerate(rays):
        res = oracle.calc_ray((x, y, a, b), N, dz, gains, None, K, method)
        msgs = failure_messages(1 << -res.error) if res.error else []
        status = (f"error {res.error} ({'; '.join(msgs)})" if res.error
                  else "no failure reproduced")
        if not res.error:
            not_reproduced += 1
        gsum = np.asarray(res.gvl[: N - 1], np.float64).sum()
        ro = np.asarray(res.ray_out, np.float64).reshape(-1)
        print(f"  ray[{t}] ({x:+.5g}, {y:+.5g}, {a:+.5g}, {b:+.5g}): "
              f"{status}; exit ({ro[0]:+.4g}, {ro[1]:+.4g}, {ro[2]:+.4g}, "
              f"{ro[3]:+.4g}), sum(gvl)={gsum:.4g}, "
              f"Iv range [{np.min(res.Iv):.3g}, {np.max(res.Iv):.3g}]")
    if not_reproduced:
        print(f"{not_reproduced} ray(s) did not reproduce a failure "
              "(seed-dependent, or fixed by an f64 oracle where the f32 "
              "batched path failed)")
    return not_reproduced


if __name__ == "__main__":
    raise SystemExit(main())
