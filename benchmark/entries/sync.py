"""Synchronous ``create_image`` calls in a closed loop on one card: each
call waits for its images before the client scales the next call's
tables."""

from __future__ import annotations

from benchmark.harness import closed_loop


def _call(run):
    from raytrace_tpu_torch.models.ray_tracer import create_image

    def call(problem):
        return create_image(problem, run.method, None, run.dtype, 0.5,
                            "auto", run.failed_ray_path,
                            device=run.devices[0])
    return call


def warm_up(run, calls: int) -> None:
    closed_loop(run, _call(run), None, calls)


def window(run, deadline: float) -> None:
    closed_loop(run, _call(run), deadline)
