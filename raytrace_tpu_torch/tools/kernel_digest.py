"""The kernels' outputs on fixed inputs, to hold two trees' kernels
against each other on the card.

    python -m raytrace_tpu_torch.tools.kernel_digest OUT.npz
    PYTHONPATH=<other tree> python <this file> OTHER.npz
    python -m raytrace_tpu_torch.tools.kernel_digest --compare A.npz B.npz

Writes the outputs of B1, B3 and B2 in f64 on the inputs of
``chip_smoke.py``'s phase 3: a 2^20-ray chunk of the seeded shipped shape
(B1, then B3 with the chunk's seed factors, then B2 on B3's spectra at
B1's exit rays) and the whole ASE call (B1, then B2 on the plain
emissivity amplify's spectra); then the same in f32, the inputs of
``chip_smoke.py``'s f32 kernel checks: B3-f32's pair ``(hi, lo)``,
spectrum and flags on the seeded chunk, and B2-f32's bins, image and I_ang
on B3-f32's spectra and on the ASE call's f32 emissivity amplify. It uses
only wrapper interfaces that every tree since the kernels' redesigns has
(the f32 outputs: every tree with the f32 kernels), so an older tree's
package runs it through ``PYTHONPATH``. ``--compare`` prints, per output,
whether the two files agree bitwise and their largest relative difference;
its exit code counts the outputs that differ, bitwise for every output but
B2's and B2-f32's image and I_ang, which f64 atomics sum in an order that
changes from run to run (held to 1e-14 relative). Needs a CUDA device to
write.
"""

from __future__ import annotations

import sys

import numpy as np

#: B2's sums under atomics: the largest relative difference allowed
ATOMIC_REL = 1e-14


def _outputs() -> dict:
    import torch

    from raytrace_tpu_torch.models.problem import prepare_beam, prepare_gain
    from raytrace_tpu_torch.models.ray_tracer import _validate
    from raytrace_tpu_torch.ops import (amplify_kernel, binning, cuda_lib,
                                        deposit_kernel, spectrum,
                                        trace_kernel)
    from raytrace_tpu_torch.testing import (ASE_SHAPE, SEED_SHAPE,
                                            seed_factors, source_rays,
                                            synthetic_problem)

    if not torch.cuda.is_available():
        raise SystemExit("kernel_digest: needs a CUDA device")
    dev = "cuda"
    lib = cuda_lib.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name, shape, n in (("seed_chunk", SEED_SHAPE, 1 << 20),
                           ("ase_call", ASE_SHAPE, None)):
        p = synthetic_problem(**shape)
        method = 2 if p.seed is not None else 1
        gain = prepare_gain(p.gain, dev)
        rays = source_rays(p, n, dev)
        res = trace_kernel.trace_batch(rays, p.N, p.euv_beam.dz, gain,
                                       method, 0.5, method == 1)
        for f in res._fields:
            out[f"{name}.trace.{f}"] = getattr(res, f)
        gv = gain.gv[1:]
        B, K = res.ivl.shape[0], p.euv_beam.nv
        if method == 2:
            f, fv = seed_factors(p, B, dev)
            Iv, flags = amplify_kernel.amplify_gain(f, fv, res.escaped,
                                                    res.ivl, res.gvl, gv)
            out[f"{name}.amplify.Iv"] = Iv
            out[f"{name}.amplify.flags"] = flags
        else:
            Iv = spectrum.amplify(res, torch.zeros(
                (B, K), dtype=torch.float64, device=dev), gv, p.N)
            flags = amplify_kernel.iv_flags(Iv)
        beam = prepare_beam(p.euv_beam, dev)
        coords = binning.source_coords(res, rays, method)
        scale = _validate(p)[2]
        f64 = dict(dtype=torch.float64, device=dev)
        C = beam.x.shape[0] * beam.y.shape[0]
        A = beam.a.shape[0] * beam.b.shape[0]
        spectra = [("deposit", Iv, flags)]
        if hasattr(amplify_kernel, "F32"):
            f32 = torch.float32
            if method == 2:
                args = (f, fv, res.escaped, res.ivl, res.gvl, gv)
                Iv32, flags32, pair = amplify_kernel._launch(
                    lib, *args, stream, log_gain=True, dtype=f32)
                out[f"{name}.amplify_f32.hi"] = pair[0]
                out[f"{name}.amplify_f32.lo"] = pair[1]
                out[f"{name}.amplify_f32.Iv"] = Iv32
                out[f"{name}.amplify_f32.flags"] = flags32
            else:
                Iv32 = spectrum.amplify(res, torch.zeros(
                    (B, K), dtype=f32, device=dev), gv, p.N, dtype=f32)
                flags32 = amplify_kernel.iv_flags(Iv32)
            spectra.append(("deposit_f32", Iv32, flags32))
        for part, Iv_d, flags_d in spectra:
            ok = ~res.perp & (flags_d == 0)
            image = torch.zeros((C, K), **f64)
            i_ang = torch.zeros((A, 1), **f64)
            deposit_kernel.bin_deposit(Iv_d, coords, ok, beam, method, scale,
                                       image, i_ang)
            bins = deposit_kernel._launch(
                lib, Iv_d, coords, ok, beam, method, scale,
                torch.zeros((C, K), **f64), torch.zeros((A, 1), **f64),
                stream, bins=True)
            out[f"{name}.{part}.bins"] = bins
            out[f"{name}.{part}.image"] = image
            out[f"{name}.{part}.i_ang"] = i_ang
    torch.cuda.synchronize()
    return {k: v.cpu().numpy() for k, v in out.items()}


def compare(a: dict, b: dict) -> int:
    """Print each output's agreement; the number that differ."""
    bad = 0
    for k in sorted(set(a) | set(b)):
        if k not in a or k not in b:
            print(f"{k}: in one file only")
            bad += 1
            continue
        x, y = a[k], b[k]
        same = x.shape == y.shape and x.dtype == y.dtype and (
            x.tobytes() == y.tobytes())
        rel = 0.0
        if not same and x.shape == y.shape and x.dtype.kind == "f":
            scale = max(float(np.nanmax(np.abs(y))), 1e-300)
            rel = float(np.nanmax(np.abs(x - y))) / scale
        atomic = (k.split(".")[1] in ("deposit", "deposit_f32")
                  and k.endswith((".image", ".i_ang")))
        ok = same or (atomic and x.shape == y.shape and rel <= ATOMIC_REL)
        bad += not ok
        print(f"{k}: {x.dtype} {list(x.shape)} bitwise {same}, max rel "
              f"{rel:.3e}{'' if ok else '  DIFFERS'}")
    return bad


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--compare":
        a, b = (dict(np.load(f)) for f in argv[1:])
        bad = compare(a, b)
        print(f"kernel_digest: {bad} outputs differ")
        return min(bad, 255)
    if len(argv) != 1:
        print(__doc__)
        return 2
    np.savez(argv[0], **_outputs())
    print(f"kernel_digest: wrote {argv[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
