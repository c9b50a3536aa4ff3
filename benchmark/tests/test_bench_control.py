"""The control of ``correct`` at a size a test run holds: the program with
its own lower-precision path switched on (the f32 spectrum, the step below
the configurations' f64) fails a cell's limits, where the program as the
configuration states it passes them."""

from __future__ import annotations

import pytest

from benchmark.control import readings

CELLS = ["ase-small-sync", "seeded-sync", "ase-scale64-mesh4",
         "seeded-small-stream"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_program_passes(name, tiny):
    cell = tiny(name)
    limits = cell["limits"]
    sound = readings(cell, 2**31 + 11, 0.3, False, device="cpu")
    assert sound["correct"], sound
    assert all(sound[k] <= v for k, v in limits.items())
    control = readings(cell, 2**31 + 12, 0.3, True, device="cpu")
    assert not control["correct"], control
    assert any(control[k] > v for k, v in limits.items())
    assert control["failed"] == 0
