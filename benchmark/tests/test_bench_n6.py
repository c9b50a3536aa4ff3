"""The five-segment ASE cell ``ase-n6-stream``: its configuration against
``ase``'s, the plain reference at a tiny N = 6 unit against the program's
plain twins and the scalar oracle, the ``pack.gbps`` reader, and the
program's ``pack.bytes`` value against the buffer a pack writes."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import harness, units
from benchmark.reference import plain

CELL = "ase-n6-stream"
SEED = 2**31 + 613
#: a tiny N = 6 unit (refraction on) whose rays leave the grid mid-path
TINY6 = dict(nx=5, ny=3, na=4, nb=3, nv=5, N=6)
#: the JAX package's tests' bound for trajectories that refraction makes
#: diverge by an ulp a step (``tests/test_create_image.py``)
JITTER_TOL = 2e-3


def test_config_is_ase_with_six_tables():
    m = harness.manifest()
    entry = {c["name"]: c for c in m["configs"]}["ase-n6"]
    assert entry["reduced"] == []
    spec = harness.load_cell(CELL)["config_spec"]
    ase = harness.load_cell("ase-small-sync")["config_spec"]
    assert {**spec["shape"], "N": 3} == ase["shape"] and spec["shape"]["N"] == 6
    assert spec["spectrum_dtype"] == "float64"
    assert spec["guarantees"] == ase["guarantees"]
    assert any("N = 6" in a for a in spec["assumed"])
    base = units.base_unit(spec)
    assert units.ray_count(base) == 399000 and len(base.gain) == 6


def test_cell_reports():
    cell = harness.load_cell(CELL)
    assert cell["traffic_spec"] == harness.load_cell(
        "ase-f32-small-stream")["traffic_spec"]
    assert {m["name"] for m in cell["end_to_end"]} == {
        "rays_per_s", "peak_reserved_gib", "setup_s"}
    per_layer = {m["name"] for m in cell["per_layer"]}
    assert {"trace_roofline", "amplify_roofline", "deposit_roofline",
            "device.idle_share", "pack.gbps"} <= per_layer
    with open(harness.BENCH / "workloads" / f"{CELL}.json") as f:
        assert json.load(f)["limits"]["image_rel_l2"] == 1e-10


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def test_plain_reference_at_n6_against_the_twins_and_the_oracle():
    """The plain reference on a tiny N = 6 unit: within 1e-13 of the
    program's plain twins (the same per-ray arithmetic, f64 sums in other
    orders) and within the jitter bound of the scalar oracle; some ray
    leaves the grid before the last segment."""
    from raytrace_tpu_torch.models import ray_tracer
    from raytrace_tpu_torch.ops import oracle
    from raytrace_tpu_torch.testing import oracle_images

    unit = units.synthetic_unit(**TINY6)
    r_img, r_ang, counts = plain.create_image(unit)
    assert counts["failed"] == 0 and counts["rays"] == 5 * 3 * 4 * 3
    img, ang = ray_tracer.create_image(units.to_program(unit), "cpu")
    assert _rel(img, r_img) < 1e-13 and _rel(ang, r_ang) < 1e-13
    p = units.to_program(unit)
    o_img, o_ang = oracle_images(p, 1)
    assert _rel(r_img, o_img) < JITTER_TOL
    assert _rel(r_ang, o_ang) < JITTER_TOL
    b = p.euv_beam
    walks = [oracle.calc_ray(tuple(np.float32(v) for v in ray), p.N, b.dz,
                             p.gain, None, b.nv, 1).gvl[:p.N - 1]
             for ray in ((b.x[-1], b.y[-1], b.a[0], b.b[0]),
                         (b.x[0], b.y[0], b.a[-1], b.b[-1]))]
    rows = [np.abs(g).sum(axis=1) for g in walks]
    assert any(np.any(r == 0.0) and np.any(r > 0.0) for r in rows)


def test_tiny_cell_is_correct_and_reads_pack_gbps(tiny):
    out = harness.run_cell(tiny(CELL), SEED, 0.5, True, "cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["pack.gbps"]["value"] > 0


def _view(totals: dict, counts: dict) -> dict:
    return dict(timer=dict(totals=totals, counts=counts))


def test_pack_gbps_reader():
    gbps = harness.load_reader("pack.gbps")
    assert gbps.read(_view({}, {})) is None
    assert gbps.read(_view({"pack": 0.004}, {"pack": 4})) is None
    assert gbps.read(_view({"pack.bytes": 4e6}, {"pack.bytes": 2})) is None
    v = _view({"pack": 0.004, "pack.bytes": 4 * 3844704.0},
              {"pack": 4, "pack.bytes": 4})
    assert gbps.read(v) == pytest.approx(3844704 / 1e-3 / 1e9)


@pytest.mark.parametrize("config", ["ase", "ase-n6", "seeded"])
def test_pack_bytes_is_the_buffer_written(config):
    """One ``pack.bytes`` value a call: the size of the buffer the pack
    wrote, which is the layout's (``table_layout``); the ``ase-n6`` unit's
    tables are twice ``ase``'s."""
    from raytrace_tpu_torch.models import ray_tracer
    from raytrace_tpu_torch.models.problem import layout_nbytes, table_layout
    from raytrace_tpu_torch.utils.timer import profiler

    spec = json.loads((harness.ROOT / "benchmark" / "configs"
                       / f"{config}.json").read_text())
    shape = dict(spec["shape"], nx=6, ny=4, na=4, nb=3)
    if shape.get("seeded"):
        shape.update(seed_nx=8, seed_ny=4, seed_na=5, seed_nb=4, seed_dim=21)
    p = units.to_program(units.synthetic_unit(**shape))
    src = ray_tracer._source_beam(p)
    profiler.reset()
    prep = ray_tracer.prepare_pipeline(p, "cpu", device=torch.device("cpu"))
    (buf,) = prep.operands
    assert profiler.counts["pack.bytes"] == 1
    assert profiler.totals["pack.bytes"] == buf.numel() == layout_nbytes(
        table_layout(p.gain, p.euv_beam, src, p.seed))
    profiler.reset()


def test_n6_tables_are_twice_the_shipped_ones():
    from raytrace_tpu_torch.models.problem import layout_nbytes, table_layout

    def nbytes(config):
        p = units.to_program(units.base_unit(
            harness.load_cell(config)["config_spec"]))
        return layout_nbytes(table_layout(p.gain, p.euv_beam, p.euv_beam))

    assert nbytes("ase-small-sync") == 1923312
    assert nbytes(CELL) == 3844704


@pytest.mark.gpu
def test_traced_run_on_the_card():
    """A short traced run of the cell on the card: correct, no failed
    call, and the device readers and ``pack.gbps`` read values, no share
    above 100%. Needs a CUDA device; it decides inside the test."""
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELL,
         "--seed", "2147484263", "--seconds", "2", "--trace", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0, result["checks"]
    metrics = result["metrics"]
    for name in ("trace_roofline", "amplify_roofline", "deposit_roofline"):
        assert 0 < metrics[name]["value"] <= 100
    assert metrics["pack.gbps"]["value"] > 0
    assert "device.idle_share" in metrics
