"""Two-float f32 arithmetic of the f32 spectrum (``raytrace_tpu``'s
``ops/spectrum.py:35-121``, the port's own copy).

The f32 spectrum carries a log-gain as an unevaluated pair ``(hi, lo)`` of
f32 values: ``exp`` turns an argument's rounding into a relative error of
the result (d exp / exp = dg), so a plain f32 ``exp`` of an f32 log-gain is
off by about ``|g| * 6e-8``; the pair keeps the error near 1e-7 whatever
``|g|``. The helpers:

* :func:`two_sum`: Knuth's error-free sum, ``a + b = s + err`` exactly;
* :func:`split_prod`: Dekker's error-free product, each factor split at a
  mask of 12 high significand bits so the four partial products are exact;
* :func:`exp_fast2`: ``exp(hi + lo)`` by range reduction ``n ln2 + f`` with
  split-ln2 constants, a degree-7 Horner polynomial of ``f`` in f32 and an
  exact scaling by ``2^n``;
* :func:`expm1_from_exp`: ``expm1`` from that ``exp``, by the polynomial
  where ``|hi| <= ln2 / 2``.

Every product and sum is its own PyTorch operation: an error-free
transform is error-free only where no product and sum are fused into one
rounding (``csrc/amplify.cu`` is compiled with ``-fmad=false`` for the same
reason). Constants that are not f32 values are rounded to f32 first, so a
scalar operation rounds as the f32 operation of the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["two_sum", "split_prod", "exp_fast2", "expm1_from_exp",
           "ldexp_f32", "f32c", "LOG2E", "LN2_HI", "LN2_LO", "RCP"]


def f32c(x: float) -> float:
    """``x`` rounded to the nearest f32, as a Python float."""
    return float(np.float32(x))


LOG2E = f32c(1.4426950408889634)
# ln2 = LN2_HI + LN2_LO with LN2_HI carrying 12 trailing zero significand
# bits, so n * LN2_HI is exact for the |n| <= 2^11 of the range reduction
LN2_HI = f32c(0.693145751953125)
LN2_LO = f32c(1.42860677e-06)
#: half ln2 in f32: the bound of expm1's direct polynomial
HALF_LN2 = f32c(0.5 * 0.6931471805599453)
#: 0xFFFFF000 as an int32: sign, exponent and 11 stored significand bits
_SPLIT_MASK = -4096
#: Horner coefficients 1/k rounded to f32 (the JAX package's ``_RCP``)
RCP = {k: f32c(1.0 / k) for k in (2, 3, 4, 5, 6, 7)}
#: the scale 2^n is applied as two exact powers of two, 2^(n // 2) and
#: 2^(n - n // 2); |n| beyond this gives 0 or inf as the true result does
_N_MAX = 252


def two_sum(a: torch.Tensor, b: torch.Tensor):
    """Error-free f32 addition: ``(s, err)`` with ``a + b = s + err``."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _split(a: torch.Tensor) -> torch.Tensor:
    """The high part of ``a``: its 12 high significand bits."""
    return (a.view(torch.int32) & _SPLIT_MASK).view(torch.float32)


def split_prod(a: torch.Tensor, b: torch.Tensor):
    """Error-free f32 product (Dekker): ``(p, err)`` with ``a * b = p +
    err``."""
    ah = _split(a)
    al = a - ah
    bh = _split(b)
    bl = b - bh
    p = a * b
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _pow2(n: torch.Tensor) -> torch.Tensor:
    """``2^n`` as f32 for int32 ``n`` in [-126, 127], from its bits."""
    return ((n + 127) << 23).view(torch.float32)


def ldexp_f32(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``x * 2^n`` for f32 ``x`` and f32 integer-valued ``n``, rounded once
    as IEEE ``ldexp`` (and ``jnp.ldexp``) round it: overflow to inf,
    gradual underflow. NaN ``n`` scales by 1."""
    ni = torch.nan_to_num(torch.clamp(n, -_N_MAX, _N_MAX)).to(torch.int32)
    n1 = torch.div(ni, 2, rounding_mode="floor")
    return (x * _pow2(n1)) * _pow2(ni - n1)


def _horner(f: torch.Tensor) -> torch.Tensor:
    """``1 + f/2 (1 + f/3 (... (1 + f/7)))``, the Taylor series' tail."""
    e = 1.0 + f * RCP[7]
    for k in (6, 5, 4, 3, 2):
        e = 1.0 + (f * RCP[k]) * e
    return e


def exp_fast2(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """``exp(hi + lo)`` in f32 to about 1e-7 relative: ``n =
    round(hi log2e)`` (half to even), ``f = ((hi - n LN2_HI) + lo) - n
    LN2_LO``, ``e^f`` by a degree-7 Taylor polynomial, scaled by ``2^n``.
    A log-gain past f32's range gives inf (or 0), as in the JAX package."""
    n = torch.round(hi * LOG2E)
    f = ((hi - n * LN2_HI) + lo) - n * LN2_LO
    e = 1.0 + f * _horner(f)
    return ldexp_f32(e, n)


def expm1_from_exp(exp_val: torch.Tensor, hi: torch.Tensor,
                   lo: torch.Tensor) -> torch.Tensor:
    """``expm1(hi + lo)`` given ``exp_val = exp_fast2(hi, lo)``: the direct
    polynomial where ``|hi| <= ln2 / 2`` (no cancellation), ``exp_val -
    1`` elsewhere."""
    small = torch.abs(hi) <= HALF_LN2
    f = torch.where(small, hi + lo, torch.zeros_like(hi))
    poly = f * _horner(f)
    return torch.where(small, poly, exp_val - 1.0)
