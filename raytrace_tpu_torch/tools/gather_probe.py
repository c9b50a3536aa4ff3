"""Gather-latency probe P1: the time of one dependent table gather on the
card.

    python -m raytrace_tpu_torch.tools.gather_probe [reps]

Counterpart of the Pallas TPU probe in ``tools/vpu_probe.py`` (the ``gk(K)``
kernel, ``gather_ns``): there each step is an (8,128) lane-shuffle gather,
the TPU trace kernel's table fetch. Here each of 8 x 128 threads runs K
dependent steps ``v = v + tab[row][(idx + (int)v % 1) % 128]`` through
``__ldg``, the read-only-cache load that trace kernel B1 fetches its gain
tables with (``csrc/gather_probe.cu``). The index always equals ``idx`` but
depends on the previous sum, so the steps cannot overlap.

Protocol (as ``tools/vpu_probe.py``): launches of K2 and K1 steps, timed
with CUDA events and differenced, so the launch cost cancels; the best of
``reps`` pairs. Prints one JSON object with ``gather_ns``, nanoseconds per
dependent step, and the card's name. Needs a CUDA device.

:func:`gather_probe` dispatches on the device: CPU tensors take the plain
twin :func:`gather_probe_plain`, CUDA tensors launch the kernel (C entry
``rt_gather_probe``, booked in ``cuda_lib``'s launch ledger) or raise, on
their own card.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from raytrace_tpu_torch.ops import cuda_lib

__all__ = ["gather_probe", "gather_probe_plain", "probe_inputs", "measure",
           "main"]

ROW = 128
#: differenced step counts (tools/vpu_probe.py:39)
K1, K2 = 100_000, 1_000_000


def probe_inputs(rows: int = 8, seed: int = 1):
    """The probe's table [rows, 128] f32 in [0, 1) and lane indices
    [rows, 128] i32 (lane l reads entry l), as ``tools/vpu_probe.py``
    builds them."""
    tab = np.random.default_rng(seed).random((rows, ROW), np.float32)
    idx = (np.arange(rows * ROW, dtype=np.int32) % ROW).reshape(rows, ROW)
    return torch.from_numpy(tab), torch.from_numpy(idx)


def gather_probe_plain(tab: torch.Tensor, idx: torch.Tensor,
                       K: int) -> torch.Tensor:
    """Plain twin: the same K dependent steps per element in PyTorch.
    ``v`` stays non-negative (the table is), so the truncating cast and
    the remainders agree with C's."""
    v = torch.zeros(tab.shape, dtype=torch.float32, device=tab.device)
    for _ in range(K):
        j = (idx + v.to(torch.int32) % 1) % ROW
        v = v + torch.gather(tab, 1, j.long())
    return v


def _check(tab, idx):
    if (tab.dtype != torch.float32 or tab.dim() != 2 or tab.shape[1] != ROW
            or not tab.is_contiguous()):
        raise ValueError(f"gather_probe: tab must be a contiguous float32 "
                         f"[rows, {ROW}] tensor")
    if (idx.dtype != torch.int32 or idx.shape != tab.shape
            or idx.device != tab.device or not idx.is_contiguous()):
        raise ValueError(f"gather_probe: idx must be a contiguous int32 "
                         f"{tuple(tab.shape)} tensor on {tab.device}")


def gather_probe(tab: torch.Tensor, idx: torch.Tensor, K: int) -> torch.Tensor:
    """K dependent gathers per element: kernel P1 for CUDA tensors, the
    plain twin for CPU tensors. ``idx`` must be non-negative (it is taken
    modulo 128). Returns the [rows, 128] f32 sums."""
    _check(tab, idx)
    if tab.device.type == "cpu":
        return gather_probe_plain(tab, idx, K)
    if tab.device.type != "cuda":
        raise ValueError(f"gather_probe: unsupported device {tab.device}")
    stream = torch.cuda.current_stream(tab.device).cuda_stream
    return _launch(cuda_lib.load_library(), tab, idx, K, stream)


def _launch(lib, tab, idx, K, stream) -> torch.Tensor:
    """Launch ``rt_gather_probe`` of ``lib`` on ``stream``; inputs already
    checked."""
    out = torch.empty_like(tab)
    cuda_lib.launch(lib, "rt_gather_probe", tab.device, tab.data_ptr(),
                    idx.data_ptr(), out.data_ptr(), tab.numel(), int(K), 1,
                    stream)
    return out


def measure(reps: int = 5, k1: int = K1, k2: int = K2) -> dict:
    """Nanoseconds per dependent gather on the current CUDA device: the
    best of ``reps`` (K2 launch - K1 launch) / (K2 - K1) by CUDA events."""
    if not torch.cuda.is_available():
        raise RuntimeError("the gather probe needs a CUDA device")
    tab, idx = (t.cuda() for t in probe_inputs())
    gather_probe(tab, idx, k1)
    gather_probe(tab, idx, k2)
    torch.cuda.synchronize()
    per_step = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        gather_probe(tab, idx, k2)
        ev[1].record()
        gather_probe(tab, idx, k1)
        ev[2].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1]) - ev[1].elapsed_time(ev[2])
        per_step.append(ms * 1e6 / (k2 - k1))
    return {"device": torch.cuda.get_device_name(0), "k": [k1, k2],
            "reps": reps, "threads": tab.numel(),
            "gather_ns": min(per_step), "gather_ns_all": per_step}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    reps = int(argv[0]) if argv else 5
    if not torch.cuda.is_available():
        print("gather_probe: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps(measure(reps)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
