"""The deposit (the plain twin of CUDA kernel B2 and its index_add_
building block) and the binning index math against the JAX package. The
Pallas deposit and segment_sum of f32 contributions accumulate in f32, the
port in f64, hence 1e-6 relative there; JAX's f64 bin_images and the twin
agree to 1e-12; get_index is exact f64 math on both sides."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import raytrace_tpu  # noqa: F401  (JAX package: x64 + CPU config)
import jax
import jax.numpy as jnp
from raytrace_tpu.ops import binning as jax_binning
from raytrace_tpu.ops.deposit_kernel import deposit_tiles
from raytrace_tpu.testing import synthetic_problem

from raytrace_tpu_torch.models.problem import prepare_beam
from raytrace_tpu_torch.ops import binning, deposit_kernel
from raytrace_tpu_torch.ops.deposit_kernel import deposit_plain

torch.set_num_threads(2)


def _inputs(B, K, C, seed):
    rng = np.random.default_rng(seed)
    contrib = rng.random((B, K)).astype(np.float32)
    bins = rng.integers(0, C + 1, B).astype(np.int32)  # C = trash bin
    return contrib, bins


def _plain(contrib, bins, C):
    out = torch.zeros((C, contrib.shape[1]), dtype=torch.float64)
    return deposit_plain(out, torch.from_numpy(contrib.astype(np.float64)),
                         torch.from_numpy(bins)).numpy()


@pytest.mark.parametrize("K,C", [(10, 50), (1, 37)])
def test_deposit_vs_pallas_interpret(K, C):
    contrib, bins = _inputs(2048, K, C, 0)
    want = np.asarray(deposit_tiles(jnp.asarray(contrib), jnp.asarray(bins),
                                    C + 1, interpret=True))[:C]
    got = _plain(contrib, bins, C)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("K,C", [(10, 50), (1, 37)])
def test_deposit_vs_segment_sum(K, C):
    contrib, bins = _inputs(3000, K, C, 1)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(contrib),
                                          jnp.asarray(bins),
                                          num_segments=C + 1))[:C]
    got = _plain(contrib, bins, C)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _bin_case(method, full_plane, B=2500, seed=3, nan_share=0.01):
    """The same numpy inputs for the JAX package and the port: spectra
    (NaN or negative on rays that are not ok), binning coordinates over
    the padded grids and beyond, runs of equal bins (testing.deposit_inputs)."""
    from raytrace_tpu_torch.testing import deposit_inputs

    p = synthetic_problem(nx=9, ny=6, na=7, nb=5, nv=6,
                          full_plane=full_plane)
    Iv, coords, ok = deposit_inputs(p.euv_beam, B, seed, nan_share=nan_share)
    return p, Iv, coords, ok


def _accumulators(beam, K, fill=0.0):
    return (torch.full((beam.x.shape[0] * beam.y.shape[0], K), fill,
                       dtype=torch.float64),
            torch.full((beam.a.shape[0] * beam.b.shape[0], 1), fill,
                       dtype=torch.float64))


@pytest.mark.parametrize("full_plane", [False, True],
                         ids=["half-plane", "full-plane"])
@pytest.mark.parametrize("method", [1, 2])
def test_bin_deposit_plain_vs_jax_bin_images(method, full_plane):
    """The twin of kernel B2 against ``raytrace_tpu.ops.binning.bin_images``
    (scatter) on the same inputs, both in f64: entry binning (method 1),
    exit binning with negated angles and the half-plane mirror (method 2);
    rays that are not ok carry NaN or negative spectra and must not reach
    a cell. No NaN coordinates: the two packages' searches bin them in
    different intervals."""
    p, Iv, coords, ok = _bin_case(method, full_plane, nan_share=0.0)
    scale = 0.37
    names = ("x", "y", "a", "b")
    if method == 1:
        rays = dict(zip(names, (jnp.asarray(c) for c in coords)))
        res = None
    else:
        rays = None
        res = SimpleNamespace(**{f"exit_{n}": jnp.asarray(c)
                                 for n, c in zip(names, coords)})
    jbeam = raytrace_tpu.models.problem.prepare_beam(p.euv_beam)
    want_img, want_ang = jax_binning.bin_images(
        jnp.asarray(Iv), res, rays, jbeam, method, scale, jnp.asarray(ok))
    beam = prepare_beam(p.euv_beam)
    image, i_ang = _accumulators(beam, Iv.shape[1])
    deposit_kernel.bin_deposit_plain(
        torch.from_numpy(Iv), tuple(torch.from_numpy(c) for c in coords),
        torch.from_numpy(ok), beam, method, scale, image, i_ang)
    assert np.isfinite(image.numpy()).all()
    assert np.isfinite(i_ang.numpy()).all()
    assert np.count_nonzero(image.numpy()) > 50
    np.testing.assert_allclose(image.numpy(), np.asarray(want_img),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(i_ang.numpy()[:, 0], np.asarray(want_ang),
                               rtol=1e-12, atol=0)


def test_deposit_adds_in_place_and_skips_trash():
    """``bin_deposit`` on CPU tensors adds into the accumulators it is
    given (not over them), and rays that are not ok deposit nothing even
    with NaN spectra: the result equals a sum over the ok rays alone."""
    p, Iv, coords, ok = _bin_case(2, False, B=800, seed=4)
    beam = prepare_beam(p.euv_beam)
    tc = tuple(torch.from_numpy(c) for c in coords)
    image, i_ang = _accumulators(beam, Iv.shape[1], 1.0)
    deposit_kernel.bin_deposit(torch.from_numpy(Iv), tc, torch.from_numpy(ok),
                               beam, 2, 0.5, image, i_ang)
    keep = np.nonzero(ok)[0]
    want = _accumulators(beam, Iv.shape[1])
    deposit_kernel.bin_deposit_plain(
        torch.from_numpy(Iv[keep]), tuple(c[keep] for c in tc),
        torch.ones(len(keep), dtype=torch.bool), beam, 2, 0.5, *want)
    for got, w in zip((image, i_ang), want):
        assert not got.isnan().any()
        np.testing.assert_allclose(got.numpy(), 1.0 + w.numpy(), rtol=1e-12)


def test_deposit_wrapper_checks_inputs():
    p, Iv, coords, ok = _bin_case(1, False, B=20)
    beam = prepare_beam(p.euv_beam)
    args = (torch.from_numpy(Iv), tuple(torch.from_numpy(c) for c in coords),
            torch.from_numpy(ok), beam, 1, 1.0)
    image, i_ang = _accumulators(beam, Iv.shape[1])
    bad = [
        # f64 and f32 spectra are taken (the two instantiations); no other
        (args[0].half(),) + args[1:] + (image, i_ang),
        (args[0].to(torch.bfloat16),) + args[1:] + (image, i_ang),
        args[:1] + (args[1][:3],) + args[2:] + (image, i_ang),
        args[:1] + (tuple(c.double() for c in args[1]),) + args[2:]
        + (image, i_ang),
        args[:2] + (args[2].to(torch.uint8),) + args[3:] + (image, i_ang),
        args + (image[:-1], i_ang),
        args + (image, i_ang[:, 0]),
        args + (image.t(), i_ang),
    ]
    for a in bad:
        with pytest.raises(ValueError):
            deposit_kernel.bin_deposit(*a)


@pytest.mark.parametrize("full_plane", [False, True])
def test_get_index_matches_jax(full_plane):
    p = synthetic_problem(nx=9, ny=6, na=7, nb=5, full_plane=full_plane)
    b = p.euv_beam
    jb = raytrace_tpu.models.problem.prepare_beam(b)
    tb = prepare_beam(b)
    rng = np.random.default_rng(4)
    for grid, d, jg, tg in ((b.x, b.dx, jb.x, tb.x), (b.y, b.dy, jb.y, tb.y),
                            (b.a, b.da, jb.a, tb.a), (b.b, b.db, jb.b, tb.b)):
        lo, hi = grid[0] - d, grid[-1] + d
        # random points, the grid points, the half-cell edges and beyond
        ys = np.concatenate([rng.uniform(lo, hi, 400), grid,
                             grid - 0.5 * d, grid + 0.5 * d, [lo, hi]])
        ys32 = ys.astype(np.float32)  # rays bin f32 coordinates
        want = np.asarray(jax_binning.get_index(jg, d, jnp.asarray(ys32)))
        got = binning.get_index(tg, d, torch.from_numpy(ys32)).numpy()
        np.testing.assert_array_equal(got, want)
