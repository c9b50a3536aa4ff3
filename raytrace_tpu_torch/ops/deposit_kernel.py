"""Deposit wrapper: kernel B2 (``csrc/deposit.cu``) and its plain twin.

Counterpart of the Pallas TPU kernel
``raytrace_tpu/ops/deposit_kernel.py::_deposit_kernel`` (launched by
``deposit_tiles``): ``out[c, k] += sum over b with bins[b] == c of
contrib[b, k]``. The kernel adds with native f64 ``atomicAdd`` **in place
into the accumulator the caller owns** (the call's f64 image or I_ang
buffer); the plain twin does the same with ``index_add_``. Bin ``C`` (the
number of rows of ``out``) is the trash bin of invalid rays and is skipped.

Under atomics the summation order changes from run to run, so kernel
results differ between runs at about 1e-15 relative.

:func:`deposit` dispatches on the device: CPU tensors take the plain twin,
CUDA tensors launch the kernel (or raise). ``launch_count`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from raytrace_tpu_torch.ops import cuda_lib

__all__ = ["deposit", "deposit_plain", "launch_count"]

#: kernel launches since import (or since a caller last reset it)
launch_count = 0


def deposit_plain(out: torch.Tensor, contrib: torch.Tensor,
                  bins: torch.Tensor) -> torch.Tensor:
    """Plain twin of the deposit: adds into ``out`` in place, returns it."""
    ok = (bins >= 0) & (bins < out.shape[0])
    out.index_add_(0, bins[ok].long(), contrib[ok])
    return out


def _check(out, contrib, bins):
    dev = out.device
    if out.dtype != torch.float64 or out.dim() != 2 or not out.is_contiguous():
        raise ValueError("deposit: out must be a contiguous float64 [C, K] "
                         "tensor")
    C, K = out.shape
    B = bins.shape[0]
    if (contrib.dtype != torch.float64 or tuple(contrib.shape) != (B, K)
            or contrib.device != dev or not contrib.is_contiguous()):
        raise ValueError(f"deposit: contrib must be a contiguous float64 "
                         f"[{B}, {K}] tensor on {dev}")
    if (bins.dtype != torch.int32 or bins.dim() != 1 or bins.device != dev
            or not bins.is_contiguous()):
        raise ValueError(f"deposit: bins must be a contiguous int32 [B] "
                         f"tensor on {dev}")
    return B, K, C


def deposit(out: torch.Tensor, contrib: torch.Tensor,
            bins: torch.Tensor) -> torch.Tensor:
    """``out[bins[b]] += contrib[b]`` for every b with ``bins[b] < C``:
    kernel B2 for CUDA tensors, the plain twin for CPU tensors. ``out``
    [C, K] f64 is updated in place and returned."""
    B, K, C = _check(out, contrib, bins)
    if out.device.type == "cpu":
        return deposit_plain(out, contrib, bins)
    if out.device.type != "cuda":
        raise ValueError(f"deposit: unsupported device {out.device}")
    if B == 0:
        return out
    stream = torch.cuda.current_stream(out.device).cuda_stream
    _launch(cuda_lib.load_library(), out, contrib, bins, B, K, C, stream)
    global launch_count
    launch_count += 1
    return out


def _launch(lib, out, contrib, bins, B, K, C, stream) -> None:
    """Launch ``rt_deposit`` of ``lib`` on ``stream``; inputs already
    checked."""
    rc = lib.rt_deposit(out.data_ptr(), contrib.data_ptr(), bins.data_ptr(),
                        B, K, C, stream)
    cuda_lib.check(rc, "rt_deposit")
