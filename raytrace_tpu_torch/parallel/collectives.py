"""Collective operations: the reference's MPI layer (SURVEY.md section 2.4
P5/P6) on ``torch.distributed`` (gloo for host buffers, NCCL for device
tensors where each rank has a card of its own) and on a mesh of devices.

Mapping:

* ``gatherAll`` (MPI_Allgather of per-rank timings, src/MPI_helpers.h:34-38)
  -> :func:`gather_all`: ``all_gather`` of each rank's f64 values;
* ``sumReduce`` of error counts (src/MPI_helpers.h:29-33)
  -> :func:`sum_scalar`: ``all_reduce`` of one value;
* ``intensity_step_struct::sum_reduce`` (MPI_Allreduce DOUBLE SUM over the
  flattened image buffers, src/RayTraceStructures.cpp:1603-1646)
  -> :func:`host_sum_arrays`: every buffer flattened into one vector and
  summed by one ``all_reduce``, as the reference's single Allreduce
  (RayTraceStructures.cpp:1612-1628);
* the device reduction of a sharded call (``raytrace_tpu``'s in-shard_map
  ``psum``) -> :func:`sum_reduce`: per-device tensors summed onto the first
  device in f64;
* its sum over the ranks (``raytrace_tpu``'s ``psum`` over the process
  mesh, ``collectives._rank_collective``) -> :func:`rank_sum_on_card`: an
  NCCL ``all_reduce`` on each rank's own card;
* :func:`mesh_all_gather`: one row per mesh entry, gathered.

Process model: one process is one rank (the process group of
:mod:`raytrace_tpu_torch.parallel.distributed`); each process may drive a
mesh of devices. Every function here is the identity with one process (the
no-MPI shims, src/MPI_helpers.h:41-52) or one device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from raytrace_tpu_torch.parallel import distributed

__all__ = ["sum_reduce", "rank_sum_on_card", "gather_all", "sum_scalar",
           "host_sum_arrays", "mesh_all_gather"]


def sum_reduce(tensors) -> torch.Tensor:
    """The f64 sum of per-device tensors of one shape, on the first one's
    device; the first tensor itself (as f64) when there is one. Tensors on
    other devices are copied peer to peer (``non_blocking``); the caller
    orders each copy after the work that made it."""
    tensors = list(tensors)
    total = tensors[0].to(torch.float64)
    if len(tensors) == 1:
        return total
    if total is tensors[0]:
        total = total.clone()
    for t in tensors[1:]:
        total += t.to(total.device, torch.float64, non_blocking=True)
    return total


def rank_sum_on_card(t: torch.Tensor) -> torch.Tensor:
    """Sum a CUDA tensor over the ranks of a group of one rank per card
    (:func:`distributed.device_collectives`), on this rank's card: ``t`` is
    copied there first when it lies on another card, then all-reduced in
    place (NCCL, after the work queued on the card's current stream; the
    card's current stream waits for the sum). Returns the summed tensor."""
    card = distributed.rank_card()
    with torch.cuda.device(card):
        t = t.to(card)
        dist.all_reduce(t)
    return t


def gather_all(values) -> np.ndarray:
    """All-gather per-rank values (gatherAll analogue, MPI_helpers.h:34-38).

    ``values``: this rank's scalar or 1-D array (e.g. its timing samples),
    of the same length on every rank. Returns a ``[P, n]`` f64 numpy array
    with every rank's row in rank order; ``[1, n]`` with one process."""
    arr = np.atleast_1d(np.asarray(values, dtype=np.float64)).reshape(-1)
    if not distributed.is_distributed():
        return arr.reshape(1, -1)
    mine = torch.from_numpy(arr.copy())
    rows = [torch.empty_like(mine) for _ in range(distributed.size())]
    dist.all_gather(rows, mine)
    return torch.stack(rows).numpy()


def sum_scalar(value):
    """Sum a host scalar across ranks (sumReduce, MPI_helpers.h:29-33),
    keeping an int or float input's type; identity with one process."""
    if not distributed.is_distributed():
        return value
    t = torch.tensor([float(value)], dtype=torch.float64)
    dist.all_reduce(t)
    res = float(t[0])
    return type(value)(res) if isinstance(value, (int, float)) else res


def host_sum_arrays(arrays) -> list[np.ndarray]:
    """Elementwise-sum each rank's host buffers across ranks (the
    ``intensity_step_struct::sum_reduce`` contract,
    src/RayTraceStructures.cpp:1603-1646).

    ``arrays``: this rank's numpy buffers, of the same shapes on every
    rank. They are flattened into one f64 vector, summed by one
    ``all_reduce``, and split back; f64 copies, unchanged, with one
    process."""
    arrays = [np.asarray(a, np.float64) for a in arrays]
    if not distributed.is_distributed():
        return arrays
    flat = torch.from_numpy(np.concatenate(
        [a.reshape(-1) for a in arrays]) if arrays else np.zeros(0))
    dist.all_reduce(flat)
    out = flat.numpy()
    res, off = [], 0
    for a in arrays:
        res.append(out[off:off + a.size].reshape(a.shape))
        off += a.size
    return res


def mesh_all_gather(per_device, mesh) -> np.ndarray:
    """Device-level all-gather over a mesh: ``per_device`` has one row per
    mesh entry; row d goes to entry d, and the rows meet on the first
    entry. Returns the gathered rows as f64 numpy; identity for a mesh of
    one entry (or None)."""
    per_device = np.asarray(per_device, np.float64)
    if mesh is None or len(mesh) <= 1:
        return per_device
    if per_device.shape[0] != len(mesh):
        raise ValueError(f"mesh_all_gather: leading dim {per_device.shape[0]}"
                         f" must equal the mesh's {len(mesh)} entries")
    rows = [torch.as_tensor(row, device=dev)
            for row, dev in zip(per_device, mesh)]
    return torch.stack([r.to(mesh[0]) for r in rows]).cpu().numpy()
