"""Benchmark statistics + stability gates + golden validation.

Rebuild of the reference harness helpers (src/CreateImageHelpers.cpp):

* min/max/avg/stddev of per-call wall times (:146-192)
* ``check_ans``: the golden-image gate -- one-sided relative-norm comparison
  at 5e-6 (the reference's documented tolerance for its single-precision
  internals, :66-100)
* timing-stability gates: stddev <= 10% of avg and max <= avg + 15%
  (src/CreateImage.cpp:174-181); violations count as test errors
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

__all__ = ["TimingStats", "check_ans", "stability_ok", "stability_errors",
           "GOLDEN_TOL"]

GOLDEN_TOL = 5e-6  # CreateImageHelpers.cpp:89-90


@dataclass
class TimingStats:
    avg: float
    min: float
    max: float
    std: float

    @staticmethod
    def of(times) -> "TimingStats":
        t = np.asarray(times, dtype=np.float64)
        return TimingStats(avg=float(t.mean()), min=float(t.min()),
                           max=float(t.max()),
                           std=float(math.sqrt(np.mean((t - t.mean()) ** 2))))


def check_ans(image0, i_ang0, image, i_ang, verbose: bool = True) -> bool:
    """Golden validation (check_ans, CreateImageHelpers.cpp:66-100).

    The pass criterion compares *norms* one-sidedly:
    (||golden|| - ||computed||) / ||golden|| <= 5e-6 for both outputs.
    """
    image0 = np.asarray(image0)
    i_ang0 = np.asarray(i_ang0)
    norm0 = [np.linalg.norm(image0), np.linalg.norm(i_ang0)]
    norm1 = [np.linalg.norm(image), np.linalg.norm(i_ang)]
    err = [np.linalg.norm(image0 - image) / norm0[0],
           np.linalg.norm(i_ang0 - i_ang) / norm0[1]]
    ok = ((norm0[0] - norm1[0]) / norm0[0] <= GOLDEN_TOL
          and (norm0[1] - norm1[1]) / norm0[1] <= GOLDEN_TOL)
    if not ok and verbose:
        print("  Answers do not match:")
        print(f"    image: {err[0]} {norm0[0]} {norm1[0]}")
        print(f"    I_ang: {err[1]} {norm0[1]} {norm1[1]}")
    return bool(ok)


def stability_ok(stats: TimingStats) -> bool:
    """Pure-predicate form of the timing reproducibility gates
    (stddev <= 10% of avg AND max <= avg + 15%, CreateImage.cpp:174-181);
    use where stdout must stay clean (bench.py's one-JSON-line contract)."""
    return stats.std <= 0.1 * stats.avg and stats.max <= 1.15 * stats.avg


def stability_errors(stats: TimingStats) -> int:
    """Timing reproducibility gates (CreateImage.cpp:174-181)."""
    n = 0
    if stats.std > 0.1 * stats.avg:
        print("  Standard deviation of run times is larger than 10%")
        n += 1
    if stats.max > stats.avg * 1.15:
        print("  Maximum run time is more than 15% greater than the average")
        n += 1
    return n
