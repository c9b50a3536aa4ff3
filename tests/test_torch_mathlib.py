"""The port's host math library (``raytrace_tpu_torch/ops/mathlib.py``):
the cases of ``tests/test_mathlib.py`` on the port's copy, each run again
on ``raytrace_tpu.ops.mathlib`` with the same inputs and its outputs held
bitwise equal (``np.array_equal``) to the port's. The tolerances inside the
cases are those of ``tests/test_mathlib.py``."""

import numpy as np
import pytest

import raytrace_tpu  # noqa: F401
from raytrace_tpu.ops import mathlib as jax_ml
from raytrace_tpu.utils import pio as jax_pio

from raytrace_tpu_torch.ops import mathlib as port_ml
from raytrace_tpu_torch.utils.pio import pout


def interp_linear(ml):
    xi = np.array([0.0, 1.0, 3.0])
    yi = np.array([0.0, 2.0, 4.0])
    out = [ml.interp_linear(xi, yi, x) for x in (0.5, 2.0, 4.0)]
    assert out[0] == pytest.approx(1.0)
    assert out[1] == pytest.approx(3.0)
    assert out[2] == pytest.approx(5.0)  # linear extrapolation
    return out


def bilinear_trilinear_exact_on_linear_fields(ml):
    x1 = np.linspace(0, 1, 5)
    x2 = np.linspace(0, 2, 7)
    f = x1[:, None] * 2 + x2[None, :] * 3 + 1
    bi = ml.bilinear(x1, x2, f, 0.33, 1.21)
    assert bi == pytest.approx(0.33 * 2 + 1.21 * 3 + 1, rel=1e-12)
    x3 = np.linspace(-1, 1, 4)
    f3 = (x1[:, None, None] + 2 * x2[None, :, None] + 3 * x3[None, None, :])
    tri = ml.trilinear(x1, x2, x3, f3, 0.4, 0.9, 0.1)
    assert tri == pytest.approx(0.4 + 2 * 0.9 + 3 * 0.1, rel=1e-12)
    return bi, tri


def n_linear_matches_trilinear(ml):
    rng = np.random.default_rng(0)
    grids = [np.sort(rng.random(5)) for _ in range(3)]
    f = rng.random((5, 5, 5))
    pt = [0.4, 0.5, 0.45]
    a = ml.n_linear(grids, f, pt)
    b = ml.trilinear(grids[0], grids[1], grids[2], f, *pt)
    assert a == pytest.approx(b, rel=1e-12)
    return a, b


def quicksort_dual_and_unique(ml):
    x = np.array([3.0, 1.0, 2.0, 1.0])
    y = np.array([30, 10, 20, 11])
    xs, ys = ml.quicksort(x, y)
    assert np.array_equal(xs, [1.0, 1.0, 2.0, 3.0])
    assert np.array_equal(ys, [10, 11, 20, 30])
    u = ml.unique(x)
    assert np.array_equal(u, [1.0, 2.0, 3.0])
    return xs, ys, u


def unique_index_maps(ml):
    """The (Y, I, J) overload contract (interp.hpp:411-436): X[I[j]] == Y[j]
    and Y[J[i]] == X[i]."""
    rng = np.random.default_rng(7)
    x = rng.integers(0, 10, size=37).astype(np.float64)
    y, i_map, j_map = ml.unique_index(x)
    assert np.array_equal(y, np.unique(x))
    assert np.array_equal(x[i_map], y)
    assert np.array_equal(y[j_map], x)
    y1, i1, j1 = ml.unique_index(np.array([5.0]))
    assert np.array_equal(y1, [5.0]) and i1[0] == 0 and j1[0] == 0
    return y, i_map, j_map, y1, i1, j1


def calc_width_gaussian(ml):
    """FWHM of a Gaussian should come back as ~2.355 sigma."""
    sigma = 0.7
    x = np.linspace(-10, 10, 4001)
    y = np.exp(-0.5 * (x / sigma) ** 2)
    w = ml.calc_width(x, y)
    assert w == pytest.approx(2.3548 * sigma, rel=2e-2)
    return w


def bisection(ml):
    root = ml.bisection(lambda x: x ** 3 - 2.0, 0.0, 2.0)
    assert root == pytest.approx(2.0 ** (1 / 3), rel=1e-8)
    return root


def fast_pow(ml):
    x = np.array([0.5, 1.7, 42.0], np.float32)
    got = ml.fast_pow(x, 1.5)
    np.testing.assert_allclose(got, x.astype(np.float64) ** 1.5, rtol=1e-3)
    return got


def integration(ml):
    f = np.sin
    exact = 2.0  # integral of sin over [0, pi]
    out = (ml.integrate_simpson(f, 0.0, np.pi, 200),
           ml.integrate_adaptive(f, 0.0, np.pi),
           ml.integrate_midpoint(f, 0.0, np.pi, 2001))
    assert out[0] == pytest.approx(exact, rel=1e-8)
    assert out[1] == pytest.approx(exact, rel=1e-9)
    assert out[2] == pytest.approx(exact, rel=1e-5)
    return out


def calc_width_reference_semantics(ml):
    """The reference minimizes the 76.0968%-energy window over every
    starting sample (interp.cpp:190-198) -- an asymmetric profile must get
    the narrowest window, not the mean-centered one."""
    x = np.linspace(0.0, 10.0, 2001)
    y = np.exp(-0.5 * ((x - 2.0) / 0.2) ** 2) + 0.02
    w = ml.calc_width(x, y)
    assert 0 < w < 8.0
    centered = ml._calc_width_centered(x, y)
    assert w < centered + 1e-9
    errors = [ml.calc_width([1.0], [1.0]),
              ml.calc_width([0.0, 1.0], [1.0, -1.0]),
              ml.calc_width([1.0, 0.5], [1.0, 1.0]),
              ml.calc_width([0.0, 1.0], [0.0, 0.0])]
    assert errors == [-1.0] * 4  # the reference's error returns
    return w, centered, errors


def fast_exp_avg_geomean(ml):
    """fast_exp_avg = exp2(sum ai*log2 xi): the log-domain weighted average
    (interp.hpp:502-533), NOT a linear lerp."""
    got = ml.fast_exp_avg(np.array([0.5, 0.5]), np.array([4.0, 16.0]))
    assert got == pytest.approx(8.0, rel=1e-3)  # geometric mean
    one = ml.fast_exp_avg([1.0], [7.3])
    assert one == pytest.approx(7.3, rel=1e-3)
    return got, one


def get_interp_ratio_log(ml):
    out = (ml.get_interp_ratio(0.0, 4.0, 1.0),
           ml.get_interp_ratio(0.0, 4.0, 9.0),
           ml.get_interp_ratio(0.0, 4.0, 9.0, extrap=True),
           ml.get_interp_ratio(1.0, 100.0, 10.0, use_log=True))
    assert out[0] == pytest.approx(0.25)
    assert out[1] == 1.0  # clamped
    assert out[2] == pytest.approx(2.25)
    assert out[3] == pytest.approx(0.5, abs=2e-3)
    return out


def fast_pow_reference_bit_semantics(ml):
    """fast_pow mirrors the reference's IEEE-754 expression graph
    (interp.hpp:475-498): +0 base and exponent-underflow return exactly 0,
    accuracy ~1e-3 in the normal range."""
    assert ml.fast_pow(0.0, 2.0) == 0.0
    assert ml.fast_pow(1e-300, 2.0) == 0.0  # w < -1022 underflow path
    x = np.array([0.001, 0.5, 1.7, 42.0, 1e20])
    up, down = ml.fast_pow(x, 1.5), ml.fast_pow(x, -0.7)
    np.testing.assert_allclose(up, x ** 1.5, rtol=2e-3)
    np.testing.assert_allclose(down, x ** -0.7, rtol=2e-3)
    return up, down


def quicksort_matches_numpy(ml):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 40, 5000).astype(np.float64)
    y = x * 2.0 + 0.25  # key-linked payload: pairing must survive the sort
    xs, ys = ml.quicksort(x, y)
    assert np.array_equal(xs, np.sort(x))
    assert np.allclose(ys, xs * 2.0 + 0.25)
    u = ml.unique(x)
    assert np.array_equal(u, np.unique(x))
    return xs, ys, u


def bisection_reference_protocol(ml):
    """The modified bisection keeps every evaluation and proposes via
    bisection_coeff (midpoint -> uneven boundary step -> pchip inverse
    interpolation, interp.cpp:205-268)."""
    root = ml.bisection(lambda x: x ** 3 - 2.0, 0.0, 2.0, tol1=1e-13,
                        tol2=1e-13)
    assert root == pytest.approx(2.0 ** (1 / 3), rel=1e-9)
    # boundary-hugging root exercises the 80/20 uneven branch
    edge = ml.bisection(lambda x: np.tanh(50 * (x - 0.02)), 0.0, 1.0,
                        tol1=1e-12, tol2=1e-10)
    assert edge == pytest.approx(0.02, abs=1e-8)
    with pytest.raises(ValueError):
        ml.bisection(lambda x: 1.0 + x * x, -1.0, 1.0)
    y, (lo, hi) = ml.bisection_coeff([0.0, 1.0], [-1.0, 1.0])
    assert lo == 0.0 and hi == 1.0 and y == 0.5
    return root, edge, y


def integrate_nested(ml):
    # int_0^1 int_0^2 x*y dy dx = (1/2)*(2) = 1
    v = ml.integrate_adaptive_2d(lambda x, y: x * y, (0.0, 1.0, 0.0, 2.0))
    assert v == pytest.approx(1.0, rel=1e-8)
    v3 = ml.integrate_adaptive_3d(
        lambda x, y, z: x + y + z, (0.0, 1.0, 0.0, 1.0, 0.0, 1.0))
    assert v3 == pytest.approx(1.5, rel=1e-6)
    return v, v3


def findfirst_variants(ml):
    X = np.array([1.0, 3.0, 5.0, 7.0])
    Y = np.array([0.0, 3.0, 4.0, 8.0])
    loop = ml.find_first_loop(X, Y)
    # loop/single semantics: first index with X >= y, len(X) on miss
    assert np.array_equal(loop, [0, 1, 2, 4])
    # hash boundary quirk: above-the-table queries return len(X) - 1
    hashed = ml.find_first_hash(X, Y)
    assert np.array_equal(hashed, [0, 1, 2, 3])
    # loop variant is scan-order first on UNSORTED tables
    unsorted = ml.find_first_loop(np.array([5.0, 1.0, 3.0]),
                                  np.array([2.0, 9.0]))
    assert np.array_equal(unsorted, [0, 3])
    return loop, hashed, unsorted


CASES = [interp_linear, bilinear_trilinear_exact_on_linear_fields,
         n_linear_matches_trilinear, quicksort_dual_and_unique,
         unique_index_maps, calc_width_gaussian, bisection, fast_pow,
         integration, calc_width_reference_semantics, fast_exp_avg_geomean,
         get_interp_ratio_log, fast_pow_reference_bit_semantics,
         quicksort_matches_numpy, bisection_reference_protocol,
         integrate_nested, findfirst_variants]


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    return np.array_equal(a, b)


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_mathlib_case(case):
    got = case(port_ml)
    assert _equal(got, case(jax_ml))


def test_pout_streams(capsys):
    """The port's rank-0 stream prints what ``raytrace_tpu``'s ``printp``
    prints (the other pio streams: ``tests/test_torch_pio.py``)."""
    pout.write("hello %d\n" % 42)
    got = capsys.readouterr().out
    jax_pio.printp("hello %d\n", 42)
    assert got == capsys.readouterr().out == "hello 42\n"
