"""Helpers of the benchmark's CPU tests: a cell cut to a tiny unit that the
plain twins run on the CPU in a fraction of a second a call."""

from __future__ import annotations

import pytest

TINY = dict(nx=8, ny=5, na=5, nb=4, nv=6, gain_nx=30, gain_ny=12)
#: cases of the tests that no cell of ``BENCHMARK.json`` runs: a cell's
#: configuration under another traffic mix
VARIANTS = {"seeded-sync": ("seeded-small-stream", "sync")}


def tiny_cell(name: str, check_calls: int = 2) -> dict:
    """The cell ``name`` as ``BENCHMARK.json`` gives it (or a case of
    :data:`VARIANTS`), its unit cut to a few hundred rays at scale 1 and its
    warm-up to one call."""
    from benchmark import harness

    if name in VARIANTS:
        base, mix = VARIANTS[name]
        cell = harness.load_cell(base)
        cell["traffic_spec"] = harness._json(
            harness.BENCH / "traffic" / f"{mix}.json")
        cell["name"] = name
    else:
        cell = harness.load_cell(name)
    shape = cell["config_spec"]["shape"]
    shape.update(TINY)
    if "seed_dim" in shape:
        shape["seed_dim"] = 21
    for key in ("seed_nx", "seed_ny", "seed_na", "seed_nb"):
        shape.pop(key, None)  # the seed grid tied to the tiny EUV grid
    cell["traffic_spec"].update(scale=1, warmup_calls=1, trace_skip=1,
                                trace_calls=2)
    cell["check_calls"] = check_calls
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
