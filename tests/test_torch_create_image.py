"""The port's create_image main path on the CPU (the plain twins of the
kernels): golden gates on both fixtures, agreement with the JAX package,
long gain columns against the scalar oracle, the stride contract, the
limits and the failure path."""

import os

import numpy as np
import pytest
import torch

import raytrace_tpu
from raytrace_tpu.testing import synthetic_problem as jax_synthetic
from raytrace_tpu.utils.errors import RayTraceError as JaxRayTraceError

from raytrace_tpu_torch import create_image, load_input
from raytrace_tpu_torch.models import ray_tracer
from raytrace_tpu_torch.models.ray_tracer import (generate_ray_indices,
                                                  resolve_method)
from raytrace_tpu_torch.ops import oracle
from raytrace_tpu_torch.testing import (oracle_images, physical_gain,
                                        synthetic_problem)
from raytrace_tpu_torch.utils.errors import RayTraceError, read_failures
from raytrace_tpu_torch.utils.stats import check_ans

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("fixture", ["golden_ase.dat", "golden_seed.dat"])
def test_fixture_golden_and_jax(fixture):
    path = os.path.join(FIXTURES, fixture)
    p, image0, i_ang0 = load_input(path)
    image, i_ang = create_image(p, "cpu")
    assert check_ans(image0, i_ang0, image, i_ang)
    assert _rel(image, image0) < 1e-5 and _rel(i_ang, i_ang0) < 1e-5
    pj, _, _ = raytrace_tpu.load_input(path)
    image_j, i_ang_j = raytrace_tpu.create_image(pj, "lax-exact")
    assert _rel(image, image_j) < 1e-5 and _rel(i_ang, i_ang_j) < 1e-5
    assert p.image is image and p.I_ang is i_ang


@pytest.mark.parametrize("seeded", [False, True])
def test_chunking_does_not_change_the_result(seeded):
    """Ragged chunks accumulate into the same f64 images."""
    img1, ang1 = create_image(synthetic_problem(seeded=seeded), "cpu")
    img2, ang2 = create_image(synthetic_problem(seeded=seeded), "cpu",
                              chunk_size=97)
    assert _rel(img2, img1) < 1e-13 and _rel(ang2, ang1) < 1e-13


@pytest.mark.parametrize("seeded", [False, True])
def test_stride_decomposition_contract(seeded):
    """N_start/N_parallel stride workers partition the full result."""
    img_full, ang_full = create_image(synthetic_problem(seeded=seeded), "cpu")
    img_sum = np.zeros_like(img_full)
    ang_sum = np.zeros_like(ang_full)
    P = 3
    for w in range(P):
        pw = synthetic_problem(seeded=seeded)
        pw.N_start, pw.N_parallel = w, P
        img_w, ang_w = create_image(pw, "cpu", chunk_size=50)
        img_sum += img_w
        ang_sum += ang_w
    assert _rel(img_sum, img_full) < 1e-13
    assert _rel(ang_sum, ang_full) < 1e-13


def test_ray_indices_match_jax():
    from raytrace_tpu.models.ray_tracer import \
        generate_ray_indices as jax_indices

    for start, skip in ((0, 1), (2, 3), (5, 7), (0, 10 ** 6)):
        p, pj = synthetic_problem(), jax_synthetic()
        p.N_start = pj.N_start = start
        p.N_parallel = pj.N_parallel = skip
        np.testing.assert_array_equal(generate_ray_indices(p),
                                      jax_indices(pj))


def test_small_synthetic_vs_jax_lax_exact():
    """A refracting synthetic of both methods against the JAX package's
    lax-exact backend (the same semantics, a different implementation)."""
    for seeded in (False, True):
        p = synthetic_problem(nx=6, ny=4, na=4, nb=3, nv=5, seeded=seeded)
        pj = jax_synthetic(nx=6, ny=4, na=4, nb=3, nv=5, seeded=seeded)
        img, ang = create_image(p, "cpu")
        img_j, ang_j = raytrace_tpu.create_image(pj, "lax-exact")
        assert _rel(img, img_j) < 1e-5 and _rel(ang, ang_j) < 1e-5


#: the JAX package's tests' bound against the scalar oracle, where
#: refraction lets trajectories part by an ulp a step
#: (``tests/test_create_image.py``)
_JITTER_TOL = 2e-3


def _escapes_mid_path(p, method):
    """True if some edge ray's oracle walk stops before the last segment:
    a zero ``gvl`` row beside a nonzero one (the synthetic's g0 is positive
    everywhere on the grid)."""
    b = p.euv_beam
    src = p.seed_beam if method == 2 else b
    for x in (src.x[0], src.x[-1]):
        for y in (src.y[0], src.y[-1]):
            for a in src.a:
                for bb in src.b:
                    ray = tuple(np.float32(v) for v in (x, y, a, bb))
                    res = oracle.calc_ray(ray, p.N, b.dz, p.gain,
                                          p.seed if method == 2 else None,
                                          b.nv, method)
                    rows = np.abs(res.gvl[: p.N - 1]).sum(axis=1)
                    if np.any(rows == 0.0) and np.any(rows > 0.0):
                        return True
    return False


@pytest.mark.parametrize("case", ["ase-n6", "ase-n20", "seeded-n20"])
def test_long_gain_column_vs_oracle(case):
    """Gain columns past the shipped N = 3 against the scalar oracle, with
    rays leaving the grid mid-path: N = 6 with refraction on (the
    ``ase-n6`` unit's length), and N = N_MAX = 20 refraction-free at the
    saturated gain (``physical_gain``) for both methods."""
    seeded = case.startswith("seeded")
    method = 2 if seeded else 1
    if case == "ase-n6":
        def make():
            return synthetic_problem(nx=5, ny=3, na=4, nb=3, nv=5, N=6)
    else:
        def make():
            return physical_gain(synthetic_problem(
                nx=5, ny=3, na=4, nb=3, nv=5, N=20, seeded=seeded,
                refraction_free=True))
    p = make()
    assert _escapes_mid_path(p, method), "no ray leaves the grid mid-path"
    want_img, want_ang = oracle_images(p, method)
    img, ang = create_image(make(), "cpu")
    assert _rel(img, want_img) < _JITTER_TOL
    assert _rel(ang, want_ang) < _JITTER_TOL


def regrid(p, seg, nx, ny):
    """Give segment ``seg`` its own nx x ny gain grid (ragged segments:
    the device tables pad every segment to the largest grid)."""
    g = p.gain[seg]
    gx = np.linspace(g.x[0], g.x[-1], nx)
    gy = np.linspace(g.y[0], g.y[-1], ny)
    X, Y = np.meshgrid(gx, gy)
    blob = np.exp(-((X - 2.5e-3) ** 2) / (3e-3) ** 2 - (Y / 2.5e-3) ** 2)
    prof = 1.0 / (1.0 + np.linspace(-2, 2, g.Nv) ** 2)
    g.x, g.y = gx, gy
    g.n = (1.0 - 2e-5 * blob).reshape(-1)
    g.g0 = (60.0 * blob).astype(np.float32).reshape(-1)
    g.E0 = (1e-4 * blob).astype(np.float32).reshape(-1)
    g.gv = np.tile(prof.astype(np.float32), nx * ny)
    g.gv0 = np.full(nx * ny, prof.max(), np.float32)


@pytest.mark.parametrize("seeded", [False, True])
def test_ragged_gain_grids_vs_jax(seeded):
    """Segments with different grid sizes: the padded cell layout, the
    per-segment bisection bounds and the lineshape rows read by ``ivl``
    must agree with the JAX package."""
    from raytrace_tpu_torch.convert import problem_from_jax

    pj = jax_synthetic(N=4, seeded=seeded)
    regrid(pj, 1, 35, 14)
    regrid(pj, 2, 22, 9)
    img, ang = create_image(problem_from_jax(pj), "cpu")
    img_j, ang_j = raytrace_tpu.create_image(pj, "lax-exact")
    assert _rel(img, img_j) < 1e-5 and _rel(ang, ang_j) < 1e-5


def test_failure_path(tmp_path):
    """A near-perpendicular ray triggers error -1 -> failed-ray dump + abort
    (RayTraceImage.cpp:427-430); the dump reads back."""
    p = synthetic_problem()
    p.euv_beam.a = p.euv_beam.a + 1500.0  # tan(1.5 rad) -> s_z^2 < 0.01
    dump = tmp_path / "failed.dat"
    with pytest.raises(RayTraceError):
        create_image(p, "cpu", failed_ray_path=str(dump))
    rays, method, N, dz, gains = read_failures(str(dump))
    assert method == 1 and N == p.N and dz == float(p.euv_beam.dz)
    assert rays.shape[1] == 4 and 1 <= rays.shape[0] <= 32
    assert len(gains) == p.N
    # the dump names real rays of the work unit
    assert np.all(np.isin(rays[:, 2].astype(np.float32),
                          p.euv_beam.a.astype(np.float32)))


def test_limits():
    p = synthetic_problem()
    p.N = 25
    with pytest.raises(RayTraceError):
        create_image(p, "cpu")
    p = synthetic_problem(nv=100)
    with pytest.raises(RayTraceError):
        create_image(p, "cpu")


@pytest.mark.parametrize("beam", ["euv", "seed"])
def test_non_uniform_grid_rejected(beam):
    p = synthetic_problem(seeded=True)
    b = p.euv_beam if beam == "euv" else p.seed_beam
    b.x = b.x.copy()
    b.x[3] += 1e-4
    with pytest.raises(RayTraceError):
        create_image(p, "cpu")


def test_single_segment_problem():
    """N = 1: no propagation segments, the (seedless) image is zero."""
    p = synthetic_problem(N=1)
    img, ang = create_image(p, "cpu")
    assert img.shape == (p.euv_beam.nx * p.euv_beam.ny * p.euv_beam.nv,)
    assert np.all(img == 0.0) and np.all(ang == 0.0)


def test_method_resolution():
    """``resolve_method(problem, name, *, device)`` names the method a call
    runs, as ``raytrace_tpu``'s does; ``_route`` gives it with its
    device."""
    p = synthetic_problem()
    assert resolve_method(p, "cpu") == "cpu"
    assert ray_tracer._route("cpu") == ("cpu", torch.device("cpu"))
    assert resolve_method(p, "openmp", device="cpu") == "cpu"
    assert resolve_method(p, "auto", device="cpu") == "cpu"
    assert resolve_method(p, "kokkos-cuda", device="cuda") == "cuda"
    with pytest.raises(RayTraceError):
        # the kernels need a CUDA device
        resolve_method(p, "cuda", device="cpu")
    with pytest.raises(RayTraceError):
        resolve_method(p, "no-such-method")


@pytest.mark.parametrize("bad", ["negative", "nan"])
def test_seeded_failure_path_vs_jax(tmp_path, bad):
    """Seeded (gain-only) failure codes -2 and -3 now come from B3's
    per-ray flags: a negative or a NaN entry of the seed's frequency
    profile fails every ray that did not escape, as the JAX package's
    [B, K] checks do, and the dumps name the same rays."""
    kw = dict(seeded=True, refraction_free=True, nx=6, ny=4, na=4, nb=3,
              nv=5)
    pj = jax_synthetic(**kw)
    pj.seed.f[4][2] = -0.5 if bad == "negative" else np.nan
    from raytrace_tpu_torch.convert import problem_from_jax

    p = problem_from_jax(pj)
    dump, dump_j = tmp_path / "port.dat", tmp_path / "jax.dat"
    with pytest.raises(RayTraceError):
        create_image(p, "cpu", failed_ray_path=str(dump))
    with pytest.raises(JaxRayTraceError):
        raytrace_tpu.create_image(pj, "lax-exact",
                                  failed_ray_path=str(dump_j))
    rays, method, N, _dz, _gains = read_failures(str(dump))
    rays_j = read_failures(str(dump_j))[0]
    assert method == 2 and N == p.N and len(rays) > 0
    np.testing.assert_array_equal(rays, rays_j)
