"""General math utilities: the reference's ``interp`` namespace
(src/AtomicModel/interp.{h,hpp,cpp}, SURVEY.md U2) on the host.

The reference ships a header math library used across the full production
app: grid interpolation (bilinear/trilinear/N-linear), FWHM estimation,
a modified bisection root finder, fast power/exp approximations, and
midpoint/Simpson/adaptive-Simpson quadrature. These are the vectorized
equivalents; scalar-loop algorithms (quicksort with index tracking,
findfirst variants) map onto numpy primitives with identical results.

A copy of ``raytrace_tpu.ops.mathlib`` in numpy, without its native sort
tier: :func:`quicksort` and :func:`unique` are numpy's stable argsort and
``np.unique``. Every function takes numpy arrays or Python scalars.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "interp_linear", "bilinear", "trilinear", "n_linear",
    "find_first_loop", "find_first_hash",
    "quicksort", "unique", "unique_index", "calc_width",
    "bisection", "bisection_coeff",
    "fast_pow", "fast_exp_avg", "get_interp_ratio",
    "integrate_midpoint", "integrate_simpson", "integrate_adaptive",
    "integrate_adaptive_2d", "integrate_adaptive_3d",
]


# ---------------------------------------------------------------------------
# grid interpolation (interp.cpp:9-93, interp.hpp:48-62)
# ---------------------------------------------------------------------------

def _bracket(xi, x):
    """Interval index in [1, len(xi)-1] (findfirstsingle clamped)."""
    xi = np.asarray(xi)
    i = np.searchsorted(xi, x, side="left")
    return np.clip(i, 1, len(xi) - 1)


def interp_linear(xi, yi, x):
    """1-D linear interpolation with linear extrapolation at the ends
    (interp::interp_linear, interp.cpp:9-22)."""
    xi = np.asarray(xi, np.float64)
    yi = np.asarray(yi, np.float64)
    x = np.asarray(x, np.float64)
    i = _bracket(xi, x)
    dx = (x - xi[i - 1]) / (xi[i] - xi[i - 1])
    return (1.0 - dx) * yi[i - 1] + dx * yi[i]


def bilinear(x1, x2, f, y1, y2):
    """Full-grid bilinear interpolation f(x1, x2) -> points (y1, y2)
    (interp::bilinear, interp.cpp:26-56). ``f`` shaped [len(x1), len(x2)]."""
    x1 = np.asarray(x1, np.float64)
    x2 = np.asarray(x2, np.float64)
    f = np.asarray(f, np.float64).reshape(len(x1), len(x2))
    i = _bracket(x1, y1)
    j = _bracket(x2, y2)
    dx = (np.asarray(y1) - x1[i - 1]) / (x1[i] - x1[i - 1])
    dy = (np.asarray(y2) - x2[j - 1]) / (x2[j] - x2[j - 1])
    return ((1 - dx) * (1 - dy) * f[i - 1, j - 1] + dx * (1 - dy) * f[i, j - 1]
            + (1 - dx) * dy * f[i - 1, j] + dx * dy * f[i, j])


def trilinear(x1, x2, x3, f, y1, y2, y3):
    """Full-grid trilinear interpolation (interp::trilinear,
    interp.cpp:60-93). ``f`` shaped [len(x1), len(x2), len(x3)]."""
    x1, x2, x3 = (np.asarray(v, np.float64) for v in (x1, x2, x3))
    f = np.asarray(f, np.float64).reshape(len(x1), len(x2), len(x3))
    i = _bracket(x1, y1)
    j = _bracket(x2, y2)
    k = _bracket(x3, y3)
    dx = (np.asarray(y1) - x1[i - 1]) / (x1[i] - x1[i - 1])
    dy = (np.asarray(y2) - x2[j - 1]) / (x2[j] - x2[j - 1])
    dz = (np.asarray(y3) - x3[k - 1]) / (x3[k] - x3[k - 1])
    out = 0.0
    for di, wx in ((0, 1 - dx), (1, dx)):
        for dj, wy in ((0, 1 - dy), (1, dy)):
            for dk, wz in ((0, 1 - dz), (1, dz)):
                out = out + wx * wy * wz * f[i - 1 + di, j - 1 + dj, k - 1 + dk]
    return out


def n_linear(grids, f, point):
    """N-dimensional multilinear interpolation (interp::n_linear,
    interp.hpp:48-62)."""
    grids = [np.asarray(g, np.float64) for g in grids]
    f = np.asarray(f, np.float64).reshape([len(g) for g in grids])
    nd = len(grids)
    idx = [int(_bracket(g, p)) for g, p in zip(grids, point)]
    w = [(point[d] - grids[d][idx[d] - 1])
         / (grids[d][idx[d]] - grids[d][idx[d] - 1]) for d in range(nd)]
    out = 0.0
    for corner in range(1 << nd):
        sel = tuple(idx[d] - 1 + ((corner >> d) & 1) for d in range(nd))
        weight = 1.0
        for d in range(nd):
            weight *= w[d] if (corner >> d) & 1 else (1.0 - w[d])
        out += weight * f[sel]
    return out


# ---------------------------------------------------------------------------
# sorting (interp.hpp:146-436) -- numpy-native with identical semantics
# ---------------------------------------------------------------------------

def find_first_loop(X, Y):
    """Batch find-first-element >= Y[j] by linear-scan semantics
    (interp::findfirstloop, interp.hpp:77-91): unlike the bisection
    variants this does NOT assume X sorted -- it returns the first index in
    scan order, len(X) on a miss."""
    X = np.asarray(X)
    Y = np.asarray(Y)
    M = X[None, :] >= Y[:, None]
    hit = M.any(axis=1)
    return np.where(hit, M.argmax(axis=1), len(X))


def find_first_hash(X, Y):
    """Batch find-first via per-query bisection (interp::findfirsthash,
    interp.hpp:93-117). Boundary quirk faithfully kept: queries ABOVE the
    table's last element return len(X) - 1 here, while the loop/single
    variants return len(X)."""
    X = np.asarray(X)
    Y = np.asarray(Y)
    idx = np.searchsorted(X, Y, side="left")
    return np.where(X[-1] < Y, len(X) - 1, idx)


def quicksort(x, y=None):
    """Sort x ascending; optionally co-sort a payload array (the dual-array
    quicksort, interp.hpp:146-358). Returns (x_sorted[, y_sorted]). A
    stable argsort: equal keys keep their payloads in input order."""
    x = np.asarray(x)
    order = np.argsort(x, kind="stable")
    if y is None:
        return x[order]
    return x[order], np.asarray(y)[order]


def unique(x):
    """Sort + deduplicate (interp::unique, interp.hpp:361-436)."""
    return np.unique(np.asarray(x))


def unique_index(x):
    """Sort + deduplicate with index maps (the (Y, I, J) overload of
    interp::unique, interp.hpp:411-436).

    Returns ``(Y, I, J)`` where ``Y`` is the sorted unique values,
    ``I[j]`` is an original index such that ``X[I[j]] == Y[j]`` (the
    forward map), and ``J[i]`` is the position of ``X[i]`` in ``Y`` (the
    backward map, ``Y[J[i]] == X[i]``).
    """
    x = np.asarray(x)
    y, idx, inv = np.unique(x, return_index=True, return_inverse=True)
    return y, idx.astype(np.intp), inv.reshape(x.shape).astype(np.intp)


# ---------------------------------------------------------------------------
# FWHM via 76% energy width (interp::calc_width, interp.cpp:157-201)
# ---------------------------------------------------------------------------

def calc_width(x, y):
    """Gaussian-equivalent FWHM of a profile (interp::calc_width,
    interp.cpp:157-201): the narrowest window [x[i], x2] containing
    f = erf(sqrt(ln 2)) = 76.0968% of the energy, minimized over every
    starting sample (NOT centered on the mean -- asymmetric profiles keep
    the reference's sliding-window semantics). Trapezoid cumulative on the
    (possibly non-uniform) grid; window end found by linear interpolation
    of the normalized cumulative. Returns -1.0 on the reference's error
    cases (fewer than 2 points, negative y, unsorted x, all-zero y)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = len(x)
    if n < 2 or np.any(y < 0.0) or np.any(np.diff(x) <= 0.0):
        return -1.0
    ys = np.concatenate([[0.0], np.cumsum(np.diff(x) * 0.5
                                          * (y[1:] + y[:-1]))])
    if ys[-1] == 0.0:
        return -1.0
    ys = ys / ys[-1]
    f = 0.760968108550488  # erf(sqrt(log(2)))
    fwhm = x[-1] - x[0]
    for i in range(n):
        if ys[i] > 1.0 - f:
            break
        x2 = float(interp_linear(ys, x, ys[i] + f))
        if x2 - x[i] < fwhm:
            fwhm = x2 - x[i]
    return float(fwhm)


def _calc_width_centered(x, y):
    """The centered-window variant kept for comparison/diagnostics (same
    76.1% mass, window centered on the distribution mean)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    tot = np.trapezoid(y, x)
    if tot <= 0:
        return 0.0
    mean = np.trapezoid(x * y, x) / tot
    target = 0.760968108550488  # erf(sqrt(ln 2)) -- central mass of a
    # Gaussian within +-FWHM/2

    def frac(w):
        lo, hi = mean - 0.5 * w, mean + 0.5 * w
        xs = np.linspace(lo, hi, 513)
        ys = np.interp(xs, x, y, left=0.0, right=0.0)
        return np.trapezoid(ys, xs) / tot

    span = x[-1] - x[0]
    lo, hi = 0.0, 2.0 * span
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if frac(mid) < target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


# ---------------------------------------------------------------------------
# modified bisection root finder (interp::bisection, interp.cpp:205-268)
# ---------------------------------------------------------------------------

def bisection_coeff(x_in, r_in):
    """Next evaluation point for the modified bisection (interp::
    bisection_coeff, interp.cpp:205-268): sign-normalize the residuals so
    the bracket minimum maps to negative r, co-sort (r, x), tighten the
    bracket around the sign change, then pick the next point by the
    reference's staged policy -- plain midpoint for the first few
    evaluations, an uneven 80/20 step at a bracket boundary, and pchip
    inverse interpolation of x(r) at r = 0 (pulled 10% toward the bracket
    midpoint) once 5+ samples exist. Returns (y, (range0, range1))."""
    x = np.array(x_in, np.float64, copy=True)
    r = np.array(r_in, np.float64, copy=True)
    n = len(x)
    if n < 2:
        raise ValueError("bisection_coeff: N < 2")
    if r[int(np.argmin(x))] > 0:
        r = -r
    r, x = quicksort(r, x)
    if r[0] > 0.0 or r[-1] < 0.0:
        raise ValueError("r does not have two different signs")
    index = int(np.searchsorted(r, 0.0, side="left"))
    index = max(1, min(index, n - 1))
    lo = max(np.max(x[:index]), x[index - 1])
    hi = min(np.min(x[index:]), x[index])
    if n < 5:
        y = 0.5 * (lo + hi)
    elif index == 1:
        y = 0.8 * x[0] + 0.2 * x[1]
    elif index == n - 1:
        y = 0.2 * x[n - 2] + 0.8 * x[n - 1]
    else:
        from raytrace_tpu_torch.ops.oracle import interp_pchip

        y = float(interp_pchip(r, x, 0.0))
        y = max(min(y, hi), lo)
        y = 0.9 * y + 0.1 * (0.5 * (lo + hi))
    return y, (lo, hi)


def bisection(fn, lb, ub, tol1=1e-12, tol2=1e-12, max_iter=500):
    """Find x in [lb, ub] with fn(x) = 0, assuming a sign change over the
    bracket (interp::bisection, interp.hpp:440-470): every evaluation is
    kept and each step's guess comes from :func:`bisection_coeff` over the
    full history; stops when |f| <= tol1 or the bracket width <= tol2.

    .. note:: tolerance semantics follow the reference (tol1 bounds |f|,
       tol2 bounds the bracket width). Earlier revisions of this module had
       the two swapped; positional callers written against those get
       different convergence behavior."""
    xs = [float(lb), float(ub)]
    fs = [float(fn(lb)), float(fn(ub))]
    if abs(fs[0]) < tol1 or abs(fs[1]) < tol1:
        return xs[0] if abs(fs[0]) < tol1 else xs[1]
    if (fs[0] < 0) == (fs[1] < 0):
        raise ValueError("bisection: sign(f(lb)) == sign(f(ub))")
    lo, hi = lb, ub
    while (hi - lo) > tol2:
        y, (lo, hi) = bisection_coeff(xs, fs)
        xs.append(y)
        fs.append(float(fn(y)))
        if abs(fs[-1]) < tol1:
            break
        if len(xs) > max_iter:
            raise RuntimeError("bisection: excessive number of iterations")
    return xs[-1]


# ---------------------------------------------------------------------------
# fast approximate pow/exp (interp.hpp:475-576)
# ---------------------------------------------------------------------------

def _fast_log2(v):
    """The reference's cubic-polynomial log2 on the raw IEEE-754 bits
    (interp.hpp:475-498): exponent field minus bias plus a 3rd-order fit of
    log2(1 + fraction). ~4e-3 absolute accuracy, branch-free."""
    bits = np.atleast_1d(np.asarray(v, np.float64)).view(np.uint64)
    e = ((bits >> np.uint64(52)) & np.uint64(0x7FF)).astype(np.float64) - 1023.0
    m = 2.220446049250313e-16 * (bits & np.uint64(0xFFFFFFFFFFFFF)).astype(np.float64)
    return e + m * (1.420864533971306
                    + m * (0.156386111143355 * m - 0.577250645114661))


def _fast_exp2(t):
    """The matching exp2: exact 2^w via the exponent field times a cubic
    2^fraction fit; w computed with the reference's int-cast convention
    ((int)(t - 1) for negative t). Returns 0 below the normal range."""
    t = np.atleast_1d(np.asarray(t, np.float64))
    w = np.where(t < 0, t - 1.0, t).astype(np.int64)  # C (int) truncation
    f = t - w
    f2 = 1.0 + f * (0.693147180559945
                    + f * (0.230508889200065 + 0.076343930239989 * f))
    pw = ((w + 1023).astype(np.uint64) << np.uint64(52)).view(np.float64)
    return np.where(w < -1022, 0.0, f2 * pw)


def fast_pow(x, y):
    """Approximate x**y = exp2(y * log2(x)) via the reference's IEEE-754
    bit manipulation (interp::fast_pow, interp.hpp:475-498): same log2 and
    exp2 polynomials, same int-cast power split, same x == +0 special case.
    Faithful to the reference's double-precision expression graph
    (agreement to the last rounding of each step)."""
    xa = np.atleast_1d(np.asarray(x, np.float64))
    x_zero = xa.view(np.uint64) == 0
    out = _fast_exp2(_fast_log2(xa) * np.float64(y))
    out = np.where(x_zero, 0.0, out)
    return out if np.ndim(x) else float(out[0])


def fast_exp_avg(ai, xi):
    """Fast approximate weighted geometric mean exp2(sum ai * log2(xi))
    (interp::fast_exp_avg, interp.hpp:502-533): the log2-domain weighted
    sum with the same polynomial log2/exp2 pair. The weights ``ai`` are the
    averaging coefficients (sum to 1 for a true average)."""
    ai = np.asarray(ai, np.float64)
    xi = np.asarray(xi, np.float64)
    t = float(np.sum(ai * _fast_log2(xi)))
    return float(_fast_exp2(t)[0])


def get_interp_ratio(x0, x1, x, use_log=False, extrap=False):
    """Interpolation coordinate of x in [x0, x1] (interp::get_interp_ratio,
    interp.hpp:537-576): linear ratio, or the log-grid ratio computed with
    the polynomial log2 (log(x/x0)/log(x1/x0)); clamped to [0, 1] unless
    ``extrap``."""
    if not use_log:
        y = (np.asarray(x, np.float64) - x0) / (x1 - x0)
    else:
        y = _fast_log2(np.asarray(x, np.float64) / x0) / _fast_log2(x1 / x0)
        if np.ndim(x) == 0:
            y = y[0]
    if not extrap:
        y = np.clip(y, 0.0, 1.0)
    return y


# ---------------------------------------------------------------------------
# quadrature (interp.hpp:582-695)
# ---------------------------------------------------------------------------

def integrate_midpoint(fn, a, b, n=101):
    """Midpoint rule."""
    h = (b - a) / n
    xs = a + (np.arange(n) + 0.5) * h
    return float(np.sum([fn(x) for x in xs]) * h)


def integrate_simpson(fn, a, b, n=100):
    """Composite Simpson rule (n even)."""
    n = n + (n % 2)
    xs = np.linspace(a, b, n + 1)
    ys = np.array([fn(x) for x in xs])
    h = (b - a) / n
    return float(h / 3 * (ys[0] + ys[-1] + 4 * ys[1:-1:2].sum()
                          + 2 * ys[2:-1:2].sum()))


def integrate_adaptive(fn, a, b, tol=1e-10, max_depth=30):
    """Adaptive Simpson quadrature (interp's adaptive integrator)."""

    def simpson(fa, fm, fb, a_, b_):
        return (b_ - a_) / 6 * (fa + 4 * fm + fb)

    def recurse(a_, b_, fa, fm, fb, whole, eps, depth):
        m = 0.5 * (a_ + b_)
        lm, rm = 0.5 * (a_ + m), 0.5 * (m + b_)
        flm, frm = fn(lm), fn(rm)
        left = simpson(fa, flm, fm, a_, m)
        right = simpson(fm, frm, fb, m, b_)
        if depth <= 0 or abs(left + right - whole) <= 15 * eps:
            return left + right + (left + right - whole) / 15
        return (recurse(a_, m, fa, flm, fm, left, eps / 2, depth - 1)
                + recurse(m, b_, fm, frm, fb, right, eps / 2, depth - 1))

    m = 0.5 * (a + b)
    fa, fm, fb = fn(a), fn(m), fn(b)
    return float(recurse(a, b, fa, fm, fb, simpson(fa, fm, fb, a, b),
                         tol, max_depth))


def integrate_adaptive_2d(fn, range4, tol=1e-8):
    """2-D adaptive Simpson as nested 1-D passes (the reference's 4-range
    ``interp::integrate`` overload, interp.hpp:654-672): the outer variable
    integrates a closure that adaptively integrates the inner one."""
    x0, x1, y0, y1 = range4
    return integrate_adaptive(
        lambda y: integrate_adaptive(lambda x: fn(x, y), x0, x1, tol),
        y0, y1, tol)


def integrate_adaptive_3d(fn, range6, tol=1e-6):
    """3-D adaptive Simpson (the 6-range overload, interp.hpp:673-693):
    nested over the 2-D integrator exactly like the reference."""
    x0, x1, y0, y1, z0, z1 = range6
    return integrate_adaptive(
        lambda z: integrate_adaptive_2d(lambda x, y: fn(x, y, z),
                                        (x0, x1, y0, y1), tol),
        z0, z1, tol)
