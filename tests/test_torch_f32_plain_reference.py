"""The port's f32 spectrum on an ASE unit against the benchmark's plain f64
reference (``benchmark/reference/plain.py``, which imports nothing of the
program), within the limits of the cell ``ase-f32-small-stream``, on the
CPU at a tiny unit of ``benchmark.units``: ``create_image`` and
``create_image_stream`` in f32 and in f64 pass, an image rounded to
bfloat16 (the step below f32) fails. This file imports no JAX."""

from __future__ import annotations

import ast
import json
from pathlib import Path

import pytest
import torch

from benchmark import units
from benchmark.control_bf16 import bf16
from benchmark.harness import rel_l2
from benchmark.reference import plain
from raytrace_tpu_torch.models.ray_tracer import (create_image,
                                                  create_image_stream)

ROOT = Path(__file__).resolve().parents[1]
CELL = json.loads(
    (ROOT / "benchmark" / "workloads" / "ase-f32-small-stream.json")
    .read_text())
CONFIG = json.loads(
    (ROOT / "benchmark" / "configs" / f"{CELL['config']}.json").read_text())
LIMITS = CELL["limits"]
TINY = dict(nx=8, ny=5, na=5, nb=4, nv=6, gain_nx=30, gain_ny=12)
SEED = 2**31 + 23
CALLS = 3


@pytest.fixture(scope="module")
def calls():
    """Three calls of the tiny unit with fresh gain factors, each with the
    reference's image and I_ang."""
    base = units.synthetic_unit(**{**CONFIG["shape"], **TINY})
    out = []
    for i in range(CALLS):
        unit = units.call_unit(base, units.gain_factors(SEED, i, base.N,
                                                        0.005))
        image, i_ang, counts = plain.create_image(unit,
                                                  device=torch.device("cpu"))
        assert counts["failed"] == 0
        out.append((unit, image, i_ang))
    return out


def _run(entry, dtype, calls, tmp_path):
    path = str(tmp_path / "failed.dat")
    if entry == "create_image":
        return [create_image(units.to_program(u), "cpu", None, dtype,
                             failed_ray_path=path, device="cpu")
                for u, _, _ in calls]
    return list(create_image_stream(
        (units.to_program(u) for u, _, _ in calls), "cpu", None, dtype,
        0.5, "auto", 2, path, device="cpu"))


def test_the_cell_states_f32():
    assert CONFIG["spectrum_dtype"] == "float32"
    assert LIMITS["ref_failed_rays"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("entry", ["create_image", "create_image_stream"])
def test_within_the_limits_of_the_reference(entry, dtype, calls, tmp_path):
    for (image, i_ang), (_, r_img, r_ang) in zip(
            _run(entry, dtype, calls, tmp_path), calls):
        img_rel, ang_rel = rel_l2(image, r_img), rel_l2(i_ang, r_ang)
        assert img_rel <= LIMITS["image_rel_l2"] / 10
        assert ang_rel <= LIMITS["i_ang_rel_l2"] / 10
        if dtype == torch.float64:
            assert img_rel < 1e-13 and ang_rel < 1e-13
        else:
            # f32 rounding shows: the limit is not met by the f64 path alone
            assert img_rel > 1e-10


def test_bf16_rounded_image_fails(calls, tmp_path):
    (image, i_ang), = _run("create_image", torch.float32, calls[:1],
                           tmp_path)
    _, r_img, r_ang = calls[0]
    assert rel_l2(bf16(image), r_img) > 10 * LIMITS["image_rel_l2"]
    assert rel_l2(bf16(i_ang), r_ang) > 10 * LIMITS["i_ang_rel_l2"]


def test_imports_no_jax():
    tree = ast.parse(Path(__file__).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names and not names & {"jax", "jaxlib", "flax", "raytrace_tpu"}
