"""The port's data layer against the JAX package's: both fixtures unpack to
the same field values and re-pack to identical bytes, and the port's
synthetic_problem builds the same work unit field by field."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import raytrace_tpu  # noqa: F401  (JAX package: x64 + CPU config)
from raytrace_tpu.io import loader as jax_loader
from raytrace_tpu.io import serialization as jax_ser
from raytrace_tpu.testing import synthetic_problem as jax_synthetic

from raytrace_tpu_torch.convert import problem_from_jax
from raytrace_tpu_torch.io import loader, serialization
from raytrace_tpu_torch.testing import synthetic_problem

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def assert_same_fields(a, b, path="problem"):
    """Recursive field-by-field equality of two work units (dataclasses,
    lists, arrays, scalars), exact."""
    if dataclasses.is_dataclass(a):
        assert dataclasses.is_dataclass(b), path
        names_a = [f.name for f in dataclasses.fields(a)]
        names_b = [f.name for f in dataclasses.fields(b)]
        assert names_a == names_b, path
        for name in names_a:
            assert_same_fields(getattr(a, name), getattr(b, name),
                               f"{path}.{name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_fields(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, path


@pytest.mark.parametrize("fixture", ["golden_ase.dat", "golden_seed.dat"])
def test_fixture_unpacks_like_jax(fixture):
    path = os.path.join(FIXTURES, fixture)
    p, img, ang = loader.load_input(path)
    pj, imgj, angj = jax_loader.load_input(path)
    assert_same_fields(p, problem_from_jax(pj))
    np.testing.assert_array_equal(img, imgj)
    np.testing.assert_array_equal(ang, angj)


@pytest.mark.parametrize("fixture", ["golden_ase.dat", "golden_seed.dat"])
def test_fixture_repacks_to_identical_bytes(fixture, tmp_path):
    path = os.path.join(FIXTURES, fixture)
    with open(path, "rb") as f:
        raw = f.read()
    p, img, ang = loader.load_input(path)
    p.image, p.I_ang = img, ang
    out = tmp_path / "copy.dat"
    loader.save_input(out, p)
    assert out.read_bytes() == raw
    pj, imgj, angj = jax_loader.load_input(path)
    pj.image, pj.I_ang = imgj, angj
    assert serialization.pack_create_image(p) == jax_ser.pack_create_image(pj)


@pytest.mark.parametrize("compression", [1, 2])
def test_compressed_seed_beam_roundtrip(compression):
    """The seed-beam shape blobs under both zero-stripping compressions
    write the same bytes as the JAX package and read back."""
    from raytrace_tpu.structures import SeedBeamShape as JShape

    from raytrace_tpu_torch.structures import SeedBeamShape

    rng = np.random.default_rng(3)
    T = rng.standard_normal(12)
    It = np.where(rng.random(36) < 0.7, 0.0, rng.standard_normal(36))
    Ivt = np.where(rng.random(36 * 4) < 0.8, 0.0, rng.random(36 * 4))
    s = SeedBeamShape(T=T, It=It, Ivt=Ivt, nv=4)
    sj = JShape(T=T, It=It, Ivt=Ivt, nv=4)
    blob = serialization.pack_seed_beam_shape(s, compression)
    assert blob == jax_ser.pack_seed_beam_shape(sj, compression)
    back = serialization.unpack_seed_beam_shape(blob)
    tol = 0 if compression == 1 else 1e-6
    np.testing.assert_allclose(back.Ivt, Ivt, rtol=tol, atol=0)


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(seeded=True),
    dict(refraction_free=True, full_plane=True),
    dict(non_uniform_gain=True, rng=5),
    dict(nx=60, ny=25, na=19, nb=14, nv=52, N=3, gain_nx=106, gain_ny=26),
])
def test_synthetic_problem_matches_jax(kwargs):
    assert_same_fields(synthetic_problem(**kwargs),
                       problem_from_jax(jax_synthetic(**kwargs)))


def test_scale_problem_matches_jax():
    from raytrace_tpu.io.loader import scale_problem as jax_scale

    p = synthetic_problem(seeded=True)
    pj = jax_synthetic(seeded=True)
    loader.scale_problem(p, 2.5)
    jax_scale(pj, 2.5)
    assert_same_fields(p, problem_from_jax(pj))
