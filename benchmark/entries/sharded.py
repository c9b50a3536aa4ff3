"""Synchronous ``create_image_sharded`` calls in a closed loop on a mesh of
one entry a card (``make_mesh(chips)``): each card takes a stride share of
the rays, and the partial images meet on the first card."""

from __future__ import annotations

from benchmark.harness import closed_loop


def _call(run):
    from raytrace_tpu_torch.parallel.mesh import make_mesh
    from raytrace_tpu_torch.parallel.sharding import create_image_sharded

    mesh = (make_mesh(run.chips) if run.on_card
            else make_mesh(devices=run.devices))

    def call(problem):
        return create_image_sharded(problem, mesh, run.method, None,
                                    run.dtype, 0.5, "auto",
                                    run.failed_ray_path)
    return call


def warm_up(run, calls: int) -> None:
    closed_loop(run, _call(run), None, calls)


def window(run, deadline: float) -> None:
    closed_loop(run, _call(run), deadline)
