"""The device mesh of a sharded call: a tuple of ``torch.device`` along the
ray axis.

``raytrace_tpu.parallel.mesh`` builds a 1-D ``jax.sharding.Mesh`` over the
ray batch; here a mesh is the tuple of devices whose entries each take a
stride share of the rays (:mod:`raytrace_tpu_torch.parallel.sharding`).
Entries may repeat: ``("cuda:0", "cuda:0")`` is a two-shard mesh on one
card (each shard on a compute stream of its own), and ``("cpu",) * 8`` is
the counterpart of the JAX tests' 8 virtual CPU devices. A mesh of one
entry is the single-device call (the reference's no-MPI shims,
src/MPI_helpers.h:41-52).

``ray_sharding`` and ``replicated`` of the JAX module have no counterpart:
they name ``NamedSharding`` specs, and a mesh of devices has none.
"""

from __future__ import annotations

import torch

__all__ = ["RAY_AXIS", "make_mesh"]

RAY_AXIS = "rays"


def make_mesh(n_devices: int | None = None, devices=None) -> tuple:
    """A mesh of ``n_devices`` entries (all of them by default) taken from
    ``devices``, or from every visible CUDA device when ``devices`` is None.

    A CPU entry is used only when the caller names it. Raises
    :class:`RuntimeError` for a CUDA entry (or the default) on a host
    without that card, and :class:`ValueError` for an empty mesh, fewer
    devices than ``n_devices``, or a mesh that mixes device types."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; name "
                               "the devices (e.g. devices=('cpu',) * 2) to "
                               "shard on the CPU")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                             f"{len(devices)} given")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh: a mesh needs at least one device")
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"make_mesh: a mesh holds devices of one type, got "
                         f"{[str(d) for d in devices]}")
    if devices[0].type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(f"make_mesh: {[str(d) for d in devices]} "
                               f"named, but no CUDA device is visible")
        # "cuda" alone names the current device
        devices = [torch.device("cuda", torch.cuda.current_device())
                   if d.index is None else d for d in devices]
        bad = [str(d) for d in devices if d.index >= count]
        if bad:
            raise RuntimeError(f"make_mesh: no such CUDA device {bad} "
                               f"({count} visible)")
    elif devices[0].type != "cpu":
        raise ValueError(f"make_mesh: unsupported device type "
                         f"{devices[0].type}")
    return tuple(devices)
