"""Multi-process startup and shutdown: the reference's MPI bootstrap
(src/MPI_helpers.h:9-27) on ``torch.distributed`` with the gloo backend.

Mapping:

* ``startup(argc, argv)`` (MPI_Init) -> :func:`startup`, which joins a
  gloo process group. The coordinator address, process count and rank are
  passed, or read from the launcher's environment: this package's
  ``RAYTRACE_COORD`` / ``RAYTRACE_NPROCS`` / ``RAYTRACE_PROC_ID`` (the CLI's
  ``-nprocs`` launcher), or torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` /
  ``RANK`` / ``WORLD_SIZE``. With none of them set the run stays single
  process (the no-MPI build); a half-set environment raises;
* ``shutdown()`` (MPI_Finalize) -> :func:`shutdown`;
* ``rank()`` / ``size()`` (MPI_Comm_rank/size) -> :func:`rank` / :func:`size`;
* ``barrier()`` (MPI_Barrier) -> :func:`barrier`;
* a rank's device -> :func:`rank_device`: the card ``rank % count``, or
  the CPU when the caller asks for it;
* the no-MPI inline shims (src/MPI_helpers.h:41-52) -> every function here
  is the identity or a no-op when no process group exists.

Gloo, not NCCL: the rank collectives reduce host buffers (timings, error
counts, the finished images), and ranks may share one card, which NCCL
refuses. ``raytrace_tpu``'s ``process_mesh`` (one device per process, the
rank axis of its collectives) has no counterpart: the default process
group is the rank axis.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["startup", "shutdown", "rank", "size", "barrier", "is_distributed",
           "rank_device"]

_OWN_ENV = ("RAYTRACE_COORD", "RAYTRACE_NPROCS", "RAYTRACE_PROC_ID")
_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _from_env():
    """``(address, nprocs, rank)`` from the launcher's environment, or None
    when no launcher set one; a half-set environment raises."""
    for names in (_OWN_ENV, _TORCHRUN_ENV):
        present = [n for n in names if n in os.environ]
        if not present:
            continue
        if len(present) != len(names):
            missing = sorted(set(names) - set(present))
            raise RuntimeError(f"process-group environment half set: "
                               f"{present} without {missing}")
        env = [os.environ[n] for n in names]
        if names is _OWN_ENV:
            return env[0], int(env[1]), int(env[2])
        return f"{env[0]}:{env[1]}", int(env[3]), int(env[2])
    return None


def startup(coordinator_address: str | None = None,
            num_processes: int | None = None,
            process_id: int | None = None) -> None:
    """Join the gloo process group (MPI_Init analogue).

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous. With
    no arguments the launcher's environment is read; with none set the run
    stays single process. A failed initialisation raises: a rank never
    carries on alone."""
    if dist.is_initialized():
        return
    args = (coordinator_address, num_processes, process_id)
    if all(a is None for a in args):
        found = _from_env()
        if found is None:
            return
        args = found
    elif any(a is None for a in args):
        raise ValueError("startup needs the coordinator address, the number "
                         "of processes and this process's rank together")
    address, nprocs, pid = args
    if not address.startswith("tcp://"):
        address = "tcp://" + address
    dist.init_process_group("gloo", init_method=address,
                            world_size=int(nprocs), rank=int(pid))


def shutdown() -> None:
    """Leave the process group (MPI_Finalize analogue)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_distributed() -> bool:
    """Whether more than one process takes part (the collectives are the
    identity otherwise)."""
    return size() > 1


def rank() -> int:
    """This process's rank (MPI_Comm_rank analogue); 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def size() -> int:
    """Number of processes (MPI_Comm_size analogue); 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    """Block until every process arrives (MPI_Barrier analogue)."""
    if dist.is_initialized():
        dist.barrier()


def rank_device(cpu: bool = False) -> torch.device:
    """This rank's device, made current: the CPU when ``cpu`` asks for it,
    else ``cuda:(rank % device count)`` (ranks may share a card). Raises
    when no card is visible: a rank never falls back to the CPU unasked."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; ask for the CPU to "
                           "run this rank there")
    dev = torch.device("cuda", rank() % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev
