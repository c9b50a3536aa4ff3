"""``deposit_f32_roofline``: kernel B2-f32 (``bin_deposit_f32_kernel``,
``csrc/deposit.cu``)'s byte bound per call over its device time per call,
in %: each input read once (the rays' f32 spectra, 4 bytes an element,
their four f32 coordinates and a validity byte, the beam's f64 grids) and
the f64 image and I_ang written once, at 3.35 TB/s. Its operations (a few
per spectrum element) are far below its bytes' time. None where the
configuration's spectrum is not f32."""

from benchmark import peaks


def call_bytes(unit, rays: int) -> int:
    beam = unit.euv_beam
    nx, ny, na, nb, K = (len(beam.x), len(beam.y), len(beam.a),
                         len(beam.b), len(beam.v))
    inputs = rays * (4 * K + 16 + 1) + 8 * (nx + ny + na + nb + K)
    return inputs + 8 * (nx * ny * K + na * nb)


def read(view: dict):
    run = view["run"]
    if run.config["spectrum_dtype"] != "float32":
        return None
    bound = peaks.bound_s(call_bytes(run.base, run.rays))
    return peaks.share(bound, peaks.device_s(
        view, lambda n: n == "bin_deposit_f32_kernel"))
