"""Binning deposit wrapper: kernel B2 (``csrc/deposit.cu``) and its plain
twin.

Counterpart of the Pallas TPU kernel
``raytrace_tpu/ops/deposit_kernel.py::_deposit_kernel`` (launched by
``deposit_tiles``), ``out[c, k] += sum over b with bins[b] == c of
contrib[b, k]``, together with what surrounds it in
``raytrace_tpu/ops/binning.py::bin_images``: each ray's bins from its
coordinates (``binning.get_index``), ``Iv * scale`` into the image and
``Iv @ (2 dv)`` into I_ang. The kernel does all of it in one pass over the
spectra and adds with f64 ``atomicAdd`` **in place into the accumulators the
caller owns** (the call's f64 image and I_ang), one atomic per run of equal
image bins; the plain twin :func:`bin_deposit_plain` is the chain of
PyTorch operations (the index math, ``index_add_``, the gemv).

Under atomics the summation order changes from run to run, so kernel
results differ between runs at about 1e-15 relative; the bins are the
twin's bitwise.

The spectra are f64, or f32 where the call runs ``raytrace_tpu``'s default
f32 spectrum (the f32 kernel, ``rt_bin_deposit_f32``): then each product
``Iv * f32(scale)`` and ``Iv * f32(2 dv)`` is formed in f32, as
``raytrace_tpu/ops/binning.py:145-154`` forms them, and added in f64 into
the same f64 accumulators. ``raytrace_tpu`` sums a chunk in f32 first
(its MXU's partial sums); the port keeps the reference's f64 accumulation,
so the I_ang dot product is summed in f64 too. The f32 kernel stages a
tile of :data:`F32_TILE_RAYS` rays' spectra in shared memory in a block
of :data:`F32_TILE_THREADS` threads, whose first warp sums each ray's
I_ang with one thread while the other walks the tile's image bins in one
pass over K, one atomic per run of equal bins and frequency, as the f64
kernel issues them.

:func:`bin_deposit` dispatches on the device: CPU tensors take the plain
twin, CUDA tensors launch the kernel (or raise) on their own card.
``launch_count`` counts kernel launches of both kernels, ``device_launches``
them per device, and :data:`F32` the f32 kernel's alone.
"""

from __future__ import annotations

import torch

from raytrace_tpu_torch.models.problem import DeviceBeam
from raytrace_tpu_torch.ops import cuda_lib
from raytrace_tpu_torch.ops.binning import bin_indices

__all__ = ["bin_deposit", "bin_deposit_plain", "deposit_plain",
           "launch_count", "device_launches", "F32"]

#: kernel launches since import (or since a caller last reset it)
launch_count = 0
#: the same launches per device
device_launches: dict = {}
#: the launches of the f32 kernel (also counted above)
F32 = cuda_lib.Launches()
#: the f32 kernel's tile: its rays (at the shipped K) and its block's
#: threads, as ``kTileRays`` and ``kTileThreads`` in csrc/deposit.cu
F32_TILE_RAYS = 32
F32_TILE_THREADS = 64


def deposit_plain(out: torch.Tensor, contrib: torch.Tensor,
                  bins: torch.Tensor) -> torch.Tensor:
    """``out[bins[b]] += contrib[b]`` for every b with ``0 <= bins[b] <
    len(out)``, in place with ``index_add_`` in ``out``'s dtype; returns
    ``out``."""
    ok = (bins >= 0) & (bins < out.shape[0])
    out.index_add_(0, bins[ok].long(), contrib[ok].to(out.dtype))
    return out


def bin_deposit_plain(Iv, coords, ok, beam: DeviceBeam, method: int,
                      scale: float, image_acc, iang_acc) -> None:
    """Plain twin of kernel B2: the bins (:func:`binning.bin_indices`),
    ``Iv * scale`` into ``image_acc`` and ``Iv @ (2 dv)`` into
    ``iang_acc``, in place. For f32 ``Iv`` the products with ``f32(scale)``
    and ``f32(2 dv)`` are f32 and their sums f64."""
    bins = bin_indices(coords, ok, beam, method)
    if Iv.dtype == torch.float32:
        contrib = Iv * torch.full((), scale, dtype=torch.float32,
                                  device=Iv.device)
        ang = (Iv * (2.0 * beam.dv).to(torch.float32)).to(
            torch.float64).sum(dim=1)
    else:
        contrib = Iv * scale
        ang = Iv @ (2.0 * beam.dv)
    deposit_plain(image_acc, contrib, bins[:, 0])
    deposit_plain(iang_acc, ang[:, None], bins[:, 1])


def _check(Iv, coords, ok, beam, image_acc, iang_acc):
    dev = Iv.device
    if (Iv.dtype not in (torch.float64, torch.float32) or Iv.dim() != 2
            or not Iv.is_contiguous()):
        raise ValueError("bin_deposit: Iv must be a contiguous float64 or "
                         "float32 [B, K] tensor")
    B, K = Iv.shape
    if len(coords) != 4:
        raise ValueError("bin_deposit: coords must be (x, y, a, b)")
    for name, t, dtype, shape in (
            *((f"coords[{i}]", c, torch.float32, (B,))
              for i, c in enumerate(coords)),
            ("ok", ok, torch.bool, (B,)),
            *((f"beam.{f}", getattr(beam, f), torch.float64,
               (getattr(beam, f).shape[0],)) for f in ("x", "y", "a", "b")),
            ("beam.dv", beam.dv, torch.float64, (K,)),
            ("image_acc", image_acc, torch.float64,
             (beam.x.shape[0] * beam.y.shape[0], K)),
            ("iang_acc", iang_acc, torch.float64,
             (beam.a.shape[0] * beam.b.shape[0], 1))):
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"bin_deposit: {name} must be a contiguous "
                             f"{dtype} {list(shape)} tensor on {dev}")
    return B


def bin_deposit(Iv, coords, ok, beam: DeviceBeam, method: int,
                scale: float, image_acc, iang_acc) -> None:
    """Bin a chunk and deposit it into the call's accumulators, in place:
    kernel B2 for CUDA tensors, the plain twin for CPU tensors.

    ``Iv`` [B, K] f64 or f32 spectra (f32: the f32 kernel); ``coords`` the four [B] f32 coordinates from
    :func:`binning.source_coords` (entry rays for method 1, exit rays for
    method 2, before the negation and mirror); ``ok`` [B] bool, the rays to
    deposit; ``beam`` the EUV beam's grids on the same device; ``image_acc``
    [nx*ny, K] and ``iang_acc`` [na*nb, 1] f64.
    """
    B = _check(Iv, coords, ok, beam, image_acc, iang_acc)
    if Iv.device.type == "cpu":
        bin_deposit_plain(Iv, coords, ok, beam, method, scale, image_acc,
                          iang_acc)
        return
    if Iv.device.type != "cuda":
        raise ValueError(f"bin_deposit: unsupported device {Iv.device}")
    if B == 0:
        return
    stream = torch.cuda.current_stream(Iv.device).cuda_stream
    _launch(cuda_lib.load_library(), Iv, coords, ok, beam, method, scale,
            image_acc, iang_acc, stream)
    global launch_count
    launch_count += 1
    cuda_lib.count_launch(device_launches, Iv.device)
    if Iv.dtype == torch.float32:
        F32.count(Iv.device)


def _launch(lib, Iv, coords, ok, beam, method, scale, image_acc, iang_acc,
            stream, bins=False):
    """Launch ``rt_bin_deposit`` (``rt_bin_deposit_f32`` for f32 ``Iv``)
    of ``lib`` on ``stream``; inputs already checked. Returns the [B, 2]
    i32 bins (-1 for none) when ``bins``, else None."""
    B, K = Iv.shape
    out = (torch.empty((B, 2), dtype=torch.int32, device=Iv.device)
           if bins else None)
    pairs = K % 2 == 0 and Iv.data_ptr() % (2 * Iv.element_size()) == 0
    name = ("rt_bin_deposit_f32" if Iv.dtype == torch.float32
            else "rt_bin_deposit")
    axes = []
    for g, d in ((beam.x, beam.dx), (beam.y, beam.dy), (beam.a, beam.da),
                 (beam.b, beam.db)):
        axes += [g.data_ptr(), g.shape[0], float(d)]
    with cuda_lib.device_guard(Iv.device):
        rc = getattr(lib, name)(
            *(c.data_ptr() for c in coords), ok.data_ptr(), Iv.data_ptr(), B,
            K, int(pairs), *axes, beam.dv.data_ptr(), float(scale),
            int(method == 2 and beam.y0_nonneg), int(method == 2),
            image_acc.data_ptr(), iang_acc.data_ptr(),
            None if out is None else out.data_ptr(), stream)
    cuda_lib.check(rc, name)
    return out
