"""The work units: deterministic from the seed, fresh gain tables on every
call, the cells' ray counts."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import harness, units

SEEDS = [0, 7, 2**31 + 5, 2**33 + 17]


def _arrays(unit):
    out = {}
    for k, v in vars(unit.euv_beam).items():
        out["beam." + k] = v
    for s, g in enumerate(unit.gain):
        for k, v in vars(g).items():
            out[f"gain{s}.{k}"] = v
    return out


@pytest.mark.parametrize("name", ["ase", "seeded"])
def test_base_unit_deterministic(name):
    cfg = harness.load_cell({"ase": "ase-small-sync",
                             "seeded": "seeded-small-stream"}[name])
    a = _arrays(units.base_unit(cfg["config_spec"]))
    b = _arrays(units.base_unit(cfg["config_spec"]))
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


@pytest.mark.parametrize("seed", SEEDS)
def test_gain_factors_from_seed_and_call(seed):
    f = [units.gain_factors(seed, i, 3, 0.005) for i in range(50)]
    again = [units.gain_factors(seed, i, 3, 0.005) for i in range(50)]
    assert all(np.array_equal(x, y) for x, y in zip(f, again))
    assert len({x.tobytes() for x in f}) == 50
    assert all(x.dtype == np.float32 and np.all(np.abs(x - 1) <= 0.005)
               for x in f)
    other = units.gain_factors(seed + 1, 0, 3, 0.005)
    assert not np.array_equal(other, f[0])


def test_call_units_distinct_g0_shared_rest():
    base = units.synthetic_unit(seeded=True)
    seen = set()
    for i in range(20):
        u = units.call_unit(base, units.gain_factors(11, i, base.N, 0.005))
        for g, g0 in zip(u.gain, base.gain):
            assert g.n is g0.n and g.gv is g0.gv
            assert g.g0.dtype == np.float32
        seen.add(b"".join(g.g0.tobytes() for g in u.gain))
    assert len(seen) == 20


@pytest.mark.parametrize("cell,rays", [("ase-small-sync", 399000),
                                       ("ase-scale64-mesh4", 24452610),
                                       ("seeded-small-stream", 7803000)])
def test_ray_counts(cell, rays):
    c = harness.load_cell(cell)
    unit = units.base_unit(c["config_spec"], c["traffic_spec"]["scale"])
    assert units.ray_count(unit) == rays
    if "rays" in c["config_spec"] and c["traffic_spec"]["scale"] == 1:
        assert c["config_spec"]["rays"] == rays


def test_to_program_shares_arrays():
    unit = units.synthetic_unit(seeded=True)
    p = units.to_program(unit)
    assert p.euv_beam.x is unit.euv_beam.x and p.gain[1].g0 is unit.gain[1].g0
    assert p.seed.f0 == unit.seed.f0
    assert p.seed_beam.nx == len(unit.seed_beam.x)
    assert p.N == unit.N and p.gain[0].Nv == len(unit.euv_beam.v)


def test_seed_grid_sized_apart_from_euv_grid():
    c = harness.load_cell("seeded-small-stream")
    unit = units.base_unit(c["config_spec"])
    b, s = unit.euv_beam, unit.seed_beam
    assert [len(b.x), len(b.y), len(b.a), len(b.b)] == [60, 25, 19, 14]
    assert [len(s.x), len(s.y), len(s.a), len(s.b)] == [120, 25, 51, 51]
    tied = units.synthetic_unit(nx=6, ny=3, na=4, nb=5, seeded=True)
    assert [len(tied.seed_beam.x), len(tied.seed_beam.a),
            len(tied.seed_beam.b)] == [8, 5, 6]
