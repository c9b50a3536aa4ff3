"""``deposit_roofline``: kernel B2 (``bin_deposit_kernel``, and its f32
form, ``csrc/deposit.cu``)'s byte bound per call over its device time per
call, in %: each input read once (the rays' f64 spectra, their four f32
coordinates and a validity byte, the beam's grids) and the f64 image and
I_ang written once, at 3.35 TB/s. Its operations (a few per spectrum
element) are far below its bytes' time."""

from benchmark import peaks

B2 = ("bin_deposit_kernel", "bin_deposit_f32_kernel")


def call_bytes(unit, rays: int) -> int:
    beam = unit.euv_beam
    nx, ny, na, nb, K = (len(beam.x), len(beam.y), len(beam.a),
                         len(beam.b), len(beam.v))
    inputs = rays * (8 * K + 16 + 1) + 8 * (nx + ny + na + nb + K)
    return inputs + 8 * (nx * ny * K + na * nb)


def read(view: dict):
    run = view["run"]
    bound = peaks.bound_s(call_bytes(run.base, run.rays))
    return peaks.share(bound, peaks.device_s(view, lambda n: n in B2))
