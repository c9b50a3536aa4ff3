"""``amplify_roofline``: the amplify layer's roofline bound per call over
the device time per call of every kernel that is neither B1
(``trace_kernel``) nor B2 (``bin_deposit_kernel``), in %.

That time is the emissivity amplify's PyTorch kernels (ASE), or kernel B3
(``amplify_seeded_kernel``) with the seed factor's kernels (seeded), and
beside them the failure codes, the ray coordinates' gathers and the tables'
unpacking, which the bound does not count. The bound, from the cell's
shapes (B rays, K frequencies, T = (N-1) x 3 segment sub-lengths, the
lineshape tables of segments 1..N-1):

* emissivity (ASE): ``gvl``, ``evl``, ``ivl`` read once, the tables read
  once, the f64 spectrum written once; 8 f64 operations per ray, frequency
  and sub-length (two products, ``exp`` counted as one, a difference, a
  quotient, two more products and a sum);
* seeded: B3's (``chip_smoke``'s count: the spectrum out, ``ivl`` and
  ``gvl`` in, the seed factor, escape bit and flag byte, the profile and
  tables; 2T + 3 f64 operations per ray and frequency) and the seed
  factor's (written once, 5 f64 operations a ray).

The bound is the larger of the bytes at 3.35 TB/s and the operations at
34 TFLOP/s f64."""

from benchmark import peaks

NOT_AMPLIFY = ("trace_kernel", "bin_deposit_kernel", "bin_deposit_f32_kernel")


def _shapes(unit):
    nx = max(len(g.x) for g in unit.gain)
    ny = max(len(g.y) for g in unit.gain)
    nseg = max(unit.N - 1, 0)
    return len(unit.euv_beam.v), 3 * nseg, nseg * nx * ny


def call_bytes(unit, rays: int) -> int:
    K, T, cells = _shapes(unit)
    tables = 4 * cells * K
    if unit.seed is None:
        return rays * T * 12 + tables + rays * K * 8
    b3 = rays * K * 8 + rays * T * 8 + rays * (8 + 1 + 1) + K * 8 + tables
    return b3 + rays * 8


def call_f64_ops(unit, rays: int) -> int:
    K, T, _cells = _shapes(unit)
    if unit.seed is None:
        return rays * K * T * 8
    return rays * K * (2 * T + 3) + rays * 5


def read(view: dict):
    run = view["run"]
    bound = peaks.bound_s(call_bytes(run.base, run.rays),
                          f64_ops=call_f64_ops(run.base, run.rays))
    return peaks.share(bound, peaks.device_s(
        view, lambda n: n not in NOT_AMPLIFY))
