#!/usr/bin/env python
"""Production-iteration demo: the full application's reduction contract
end to end.

The miniapp benchmarks ``create_image`` alone; the production code that
feeds it (the dormant accumulators, SURVEY.md D8) runs an iteration loop
per length step:

    per rank:  create_image on this rank's ray stride  (N_start/N_parallel)
    -> accumulate into an intensity_step_struct        (::add)
    -> MPI_Allreduce every buffer across ranks         (::sum_reduce,
       src/RayTraceStructures.cpp:1603-1646)
    -> validity scan                                   (::valid)
    -> copy into the stacked history + energy summary  (intensity_struct::
       copy_step, :1835-1867)

This tool drives that loop with the port's counterparts
(:class:`~raytrace_tpu_torch.structures.IntensityStep` /
:class:`~raytrace_tpu_torch.structures.Intensity` and
:func:`~raytrace_tpu_torch.parallel.collectives.host_sum_arrays`) on a
synthetic problem, for any process count: with one process it runs the
no-MPI shims; as a rank of a gloo group the reduction spans the ranks. The
spectral-to-step wiring is schematic (the full application's atomic physics
owns it); the contract (shapes, reduction, validity, history) is the
reference's.

Ranks run on the card, ``cuda:(rank % device count)``, unless
``RAYTRACE_FORCE_CPU=1`` asks for the CPU; without a card and without that
variable a rank raises. The group's backend follows the layout
(``distributed.backend_for``: gloo and NCCL with a card for every rank,
else gloo; the loop's reduction is of host buffers either way). Rank 0
prints the backend and every rank's device.

Usage:
    python raytrace_tpu_torch/tools/production_loop.py            # one process
    python raytrace_tpu_torch/tools/production_loop.py <pid> <nproc> <port>
"""

import os
import sys


def run(n_steps: int = 2) -> int:
    from raytrace_tpu_torch import create_image
    from raytrace_tpu_torch.parallel import collectives, distributed
    from raytrace_tpu_torch.structures import Intensity, IntensityStep
    from raytrace_tpu_torch.testing import synthetic_problem
    from raytrace_tpu_torch.utils.pio import pout

    rank, size = distributed.rank(), distributed.size()
    dev = distributed.rank_device(os.environ.get("RAYTRACE_FORCE_CPU") == "1")
    # each rank's card index, -1 for the CPU
    where = collectives.gather_all(-1 if dev.index is None else dev.index)
    pout.write("rank devices: " + " ".join(
        "cpu" if i < 0 else f"cuda:{int(i)}" for i in where[:, 0]) + "\n")
    nx, ny, na, nb, nv = 6, 4, 4, 3, 5

    history = Intensity().initialize(n_steps, nx, ny, na, nb, nv, N_seed=1)
    ok = True
    for it in range(n_steps):
        # this rank's share of the rays (the stride contract, P4)
        p = synthetic_problem(nx=nx, ny=ny, na=na, nb=nb, nv=nv,
                              full_plane=True, rng=it)
        p.N_start, p.N_parallel = rank, size
        image, i_ang = create_image(p, "auto", chunk_size=2048, device=dev)
        img3 = image.reshape(nx * ny, nv)

        step = IntensityStep().initialize(nx, ny, na, nb, nv, N_seed=1)
        step.image[:] = img3.sum(axis=1)          # v-integrated near field
        step.E_v[:] = img3.sum(axis=0)            # space-integrated spectrum
        step.E_ang[:] = i_ang
        step.W[:] = 0.0
        step.image_seed[0][:] = step.image        # schematic seed channel
        step.E_v_seed[0][:] = step.E_v
        step.E_ang_seed[0][:] = step.E_ang

        # cross-rank reduction: every rank ends with the global sums
        step.sum_reduce()
        if not step.valid():
            pout.write(f"step {it}: INVALID intensities\n")
            ok = False
        history.copy_step(it, p.euv_beam, step)
        pout.write(f"step {it}: E_sum={history.E_sum[it]:.17e} "
                   f"(ranks={size}, {dev})\n")
    pout.write("production loop done: %s\n" % ("OK" if ok else "FAILED"))
    return 0 if ok else 1


def main() -> int:
    from raytrace_tpu_torch.parallel import distributed

    if len(sys.argv) == 4:
        pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
        distributed.startup(
            coordinator_address=f"localhost:{port}", num_processes=nproc,
            process_id=pid, cpu=os.environ.get("RAYTRACE_FORCE_CPU") == "1")
        try:
            rc = run()
            distributed.barrier()
        finally:
            distributed.shutdown()
        return rc
    return run()


if __name__ == "__main__":
    if not __package__:
        # run by path: the repository root holds the package
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))
    raise SystemExit(main())
