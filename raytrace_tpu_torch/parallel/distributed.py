"""Multi-process startup and shutdown: the reference's MPI bootstrap
(src/MPI_helpers.h:9-27) on ``torch.distributed``.

Mapping:

* ``startup(argc, argv)`` (MPI_Init) -> :func:`startup`, which joins the
  process group of :func:`backend_for`. The coordinator address, process
  count and rank are passed, or read from the launcher's environment: this
  package's ``RAYTRACE_COORD`` / ``RAYTRACE_NPROCS`` / ``RAYTRACE_PROC_ID``
  (the CLI's ``-nprocs`` launcher), or torchrun's ``MASTER_ADDR`` /
  ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``. With none of them set the
  run stays single process (the no-MPI build); a half-set environment
  raises;
* ``shutdown()`` (MPI_Finalize) -> :func:`shutdown`;
* ``rank()`` / ``size()`` (MPI_Comm_rank/size) -> :func:`rank` / :func:`size`;
* ``barrier()`` (MPI_Barrier) -> :func:`barrier`;
* a rank's device -> :func:`rank_device`: the card ``rank % count``
  (:func:`rank_card`), or the CPU when the caller asks for it;
* the no-MPI inline shims (src/MPI_helpers.h:41-52) -> every function here
  is the identity or a no-op when no process group exists.

The backend follows the layout, never a failure (:func:`backend_for`).
When every rank has a card of its own (no more ranks than cards, the CPU
not asked for), the group is ``"cpu:gloo,cuda:nccl"``: device tensors
reduce over NCCL, which is ``raytrace_tpu``'s ``process_mesh`` (one device
per process, the rank axis of its device collectives), and host buffers
(timings, error counts) over gloo. Ranks that share a card, which NCCL
refuses, or run on the CPU join gloo alone, and every rank collective
reduces host buffers. An NCCL initialisation that fails raises.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["startup", "shutdown", "rank", "size", "barrier", "is_distributed",
           "rank_device", "rank_card", "backend_for", "device_collectives",
           "DEVICE_BACKEND"]

#: the group's backends when every rank has a card of its own
DEVICE_BACKEND = "cpu:gloo,cuda:nccl"

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


def backend_for(nprocs: int, cards: int, cpu: bool) -> str:
    """The process group's backend for ``nprocs`` ranks on a host with
    ``cards`` visible cards: :data:`DEVICE_BACKEND` when every rank has a
    card of its own (``nprocs <= cards``) and ``cpu`` does not ask for the
    CPU, else ``"gloo"``."""
    return DEVICE_BACKEND if not cpu and 0 < nprocs <= cards else "gloo"


def _cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def startup(coordinator_address: str | None = None,
            num_processes: int | None = None,
            process_id: int | None = None, cpu: bool = False) -> None:
    """Join the process group (MPI_Init analogue) with the backend of
    :func:`backend_for`; ``cpu`` says that the ranks run on the CPU.

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous. With
    no address, count or rank the launcher's environment is read; with
    none set the run stays single process. With NCCL each rank's card
    (:func:`rank_card`) is made current and bound to the group, so that
    NCCL connects here. Rank 0 prints the backend. A failed initialisation
    raises: a rank never carries on alone, nor on another backend."""
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
    nprocs, pid = int(nprocs), int(pid)
    if not address.startswith("tcp://"):
        address = "tcp://" + address
    backend = backend_for(nprocs, _cards(), cpu)
    bind = {}
    if backend == DEVICE_BACKEND:
        card = torch.device("cuda", pid % _cards())
        torch.cuda.set_device(card)
        bind["device_id"] = card
    dist.init_process_group(backend, init_method=address, world_size=nprocs,
                            rank=pid, **bind)
    if pid == 0:
        print(f"process group: {nprocs} ranks, backend {backend}",
              flush=True)


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


def device_collectives() -> bool:
    """Whether the ranks reduce device tensors on their cards: a group of
    more than one rank whose CUDA backend is NCCL."""
    return is_distributed() and "cuda:nccl" in dist.get_backend_config()


def barrier() -> None:
    """Block until every process arrives (MPI_Barrier analogue)."""
    if dist.is_initialized():
        dist.barrier()


def rank_card() -> torch.device:
    """This rank's card, ``cuda:(rank % device count)``: its own when the
    group has no more ranks than cards. Raises when no card is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; ask for the CPU to "
                           "run this rank there")
    return torch.device("cuda", rank() % torch.cuda.device_count())


def rank_device(cpu: bool = False) -> torch.device:
    """This rank's device, made current: the CPU when ``cpu`` asks for it,
    else :func:`rank_card` (ranks may share a card). Raises when no card is
    visible: a rank never falls back to the CPU unasked."""
    if cpu:
        return torch.device("cpu")
    dev = rank_card()
    torch.cuda.set_device(dev)
    return dev
