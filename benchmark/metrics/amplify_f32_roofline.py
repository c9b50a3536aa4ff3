"""``amplify_f32_roofline``: the f32 amplify layer's roofline bound per call
over the device time per call of every kernel that is neither B1
(``trace_kernel``) nor B2 (``bin_deposit_kernel``,
``bin_deposit_f32_kernel``), in %. None where the configuration's
spectrum is not f32.

The count is the configuration's arithmetic, not an implementation's: the
f32 emissivity amplify as ``raytrace_tpu`` states it (the port's
``ops/spectrum._amplify_f32`` with ``ops/twofloat.py``), for B rays, K
frequencies and T = (N-1) x 3 segment sub-lengths, the lineshape tables of
segments 1..N-1.

* bytes: ``gvl``, ``evl`` and ``ivl`` read once (12 a ray and
  sub-length), the f32 tables read once, the f32 spectrum written once;
* f32 operations (adds, subtractions, products, quotients and roundings;
  bit masks, comparisons, selects and integer steps are not counted), per
  ray, frequency and sub-length, on the closed-form branch:

  - ``el = evl * gv``: 1;
  - the two-float product ``split_prod(gvl, gv)``: 10 (``gv``'s low part,
    the product, the error's four products and four sums); ``gvl``'s low
    part is 1 more a ray and sub-length;
  - ``exp_fast2``: 28 (``n``: a product and a rounding; ``f``: two
    products and three sums; the degree-7 Horner form 17 and its last
    product and sum 2; the two exact scalings by powers of two 2);
  - ``expm1_from_exp`` on its direct polynomial (``|g| <= ln2 / 2``): 19
    (the pair's sum, the Horner form 17, its last product);
  - the closed form ``el / g * em1 + I * e^g``: 4.

  62 in all. The Taylor branch (``|g| < 1e-3``, 12 operations) takes the
  place of the last three in a few elements; it is not counted apart.

The bound is the larger of the bytes at 3.35 TB/s and the operations at
67 TFLOP/s f32."""

from benchmark import peaks

NOT_AMPLIFY = ("trace_kernel", "bin_deposit_kernel", "bin_deposit_f32_kernel")
#: f32 operations per ray, frequency and sub-length; per ray and sub-length
OPS_ELEMENT, OPS_RAY_SUB = 62, 1


def _shapes(unit):
    nx = max(len(g.x) for g in unit.gain)
    ny = max(len(g.y) for g in unit.gain)
    nseg = max(unit.N - 1, 0)
    return len(unit.euv_beam.v), 3 * nseg, nseg * nx * ny


def call_bytes(unit, rays: int) -> int:
    K, T, cells = _shapes(unit)
    return rays * T * 12 + 4 * cells * K + rays * K * 4


def call_f32_ops(unit, rays: int) -> int:
    K, T, _cells = _shapes(unit)
    return rays * T * (K * OPS_ELEMENT + OPS_RAY_SUB)


def read(view: dict):
    run = view["run"]
    if run.config["spectrum_dtype"] != "float32":
        return None
    bound = peaks.bound_s(call_bytes(run.base, run.rays),
                          f32_ops=call_f32_ops(run.base, run.rays))
    return peaks.share(bound, peaks.device_s(
        view, lambda n: n not in NOT_AMPLIFY))
