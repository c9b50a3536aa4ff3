"""Move state across from the JAX package without importing it.

* :func:`problem_from_jax` copies a ``raytrace_tpu`` ``CreateImageProblem``
  field by field into this package's dataclasses. It duck-types the object,
  so this module never imports ``raytrace_tpu`` (or jax).
* :func:`gain_from_numpy` turns the host arrays of
  ``raytrace_tpu.models.problem.prepare_gain(gains, as_numpy=True)`` into
  this package's :class:`~raytrace_tpu_torch.models.problem.DeviceGain`,
  so a test can feed both packages bit-identical tables.
"""

from __future__ import annotations

import copy

from raytrace_tpu_torch.models.problem import DeviceGain, gain_to_device
from raytrace_tpu_torch.structures import (
    CreateImageProblem, EUVBeam, RayGain, RaySeed, SeedBeam, SeedBeamShape,
)

__all__ = ["problem_from_jax", "gain_from_numpy"]


def _copy_fields(src, cls):
    """A ``cls`` instance whose dataclass fields are deep copies of the
    same-named attributes of ``src``."""
    out = cls()
    for name in cls.__dataclass_fields__:
        setattr(out, name, copy.deepcopy(getattr(src, name)))
    return out


def problem_from_jax(p) -> CreateImageProblem:
    """This package's copy of a ``raytrace_tpu`` work unit ``p``."""
    out = CreateImageProblem(N=p.N, N_start=p.N_start,
                             N_parallel=p.N_parallel)
    out.euv_beam = (None if p.euv_beam is None
                    else _copy_fields(p.euv_beam, EUVBeam))
    if p.seed_beam is not None:
        sb = _copy_fields(p.seed_beam, SeedBeam)
        sb.seed_shape = [_copy_fields(s, SeedBeamShape)
                         for s in p.seed_beam.seed_shape]
        out.seed_beam = sb
    out.gain = [_copy_fields(g, RayGain) for g in p.gain]
    out.seed = None if p.seed is None else _copy_fields(p.seed, RaySeed)
    out.image = copy.deepcopy(p.image)
    out.I_ang = copy.deepcopy(p.I_ang)
    return out


def gain_from_numpy(d, device="cpu") -> DeviceGain:
    """DeviceGain on ``device`` from the JAX package's numpy gain tables
    (any object with the DeviceGain field names, values copied as they
    are)."""
    return gain_to_device(d, device)
