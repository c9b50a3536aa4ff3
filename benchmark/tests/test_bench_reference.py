"""The plain reference against the program's plain CPU path (its twins) on
tiny units of each configuration: the same images, and the trace counts
of the program's own plain trace."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import units
from benchmark.reference import plain

CASES = {
    "ase": dict(),
    "seeded": dict(seeded=True),
    "ase-scaled": dict(nx=6, ny=4, na=4, nb=3),
    "seeded-full-grid": dict(seeded=True, nx=5, ny=6, na=4, nb=4, nv=9,
                             gain_nx=22, gain_ny=9, seed_dim=13, N=4),
    "seeded-warped": dict(seeded=True, non_uniform_gain=0.8),
}


def _unit(case):
    unit = units.synthetic_unit(**CASES[case])
    if case == "ase-scaled":
        units.scale_unit(unit, 2.0)
    return units.call_unit(unit, units.gain_factors(3, 1, unit.N, 0.005))


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_program_twins(case):
    from raytrace_tpu_torch.models.ray_tracer import create_image

    unit = _unit(case)
    image, i_ang = create_image(units.to_program(unit), "cpu", None,
                                torch.float64, 0.5, "auto", device="cpu")
    r_img, r_ang, counts = plain.create_image(unit, device="cpu", chunk=700)
    assert counts["rays"] == units.ray_count(unit) and counts["failed"] == 0
    np.testing.assert_allclose(r_img, image, rtol=1e-13, atol=0)
    np.testing.assert_allclose(r_ang, i_ang, rtol=1e-13, atol=0)
    assert np.linalg.norm(image) > 0 and np.linalg.norm(i_ang) > 0


@pytest.mark.parametrize("case", ["ase", "seeded"])
def test_reference_counts_match_program_trace(case):
    from raytrace_tpu_torch.models.problem import prepare_gain
    from raytrace_tpu_torch.ops.stepper import trace_batch_plain
    from raytrace_tpu_torch.testing import source_rays

    unit = _unit(case)
    p = units.to_program(unit)
    method = 2 if unit.seed is not None else 1
    _res, steps = trace_batch_plain(
        source_rays(p), p.N, p.euv_beam.dz, prepare_gain(p.gain), method,
        0.5, method == 1, counts=True)
    _img, _ang, counts = plain.create_image(unit)
    assert counts["steps"] == int(steps.sum())
    assert 0 < counts["cells"] < counts["steps"]


def test_chunks_change_only_the_order_of_sums():
    unit = _unit("seeded")
    a = plain.create_image(unit, chunk=1 << 22)
    b = plain.create_image(unit, chunk=97)
    np.testing.assert_allclose(a[0], b[0], rtol=1e-13)
    np.testing.assert_allclose(a[1], b[1], rtol=1e-13)
    assert a[2] == b[2]
