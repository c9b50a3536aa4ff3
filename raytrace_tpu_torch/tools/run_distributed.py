#!/usr/bin/env python
"""Rank worker of the multi-process collectives harness.

The counterpart of running the reference under ``mpirun -np P``
(src/CreateImage.cpp:226-236 under MPI): every process computes a stride
share of the rays (the N_start/N_parallel contract,
src/RayTraceImage.cpp:300-328), the image buffers meet in a cross-process
reduction (the MPI_Allreduce contract, src/RayTraceStructures.cpp:1603-1646),
and per-rank timings are all-gathered (src/MPI_helpers.h:34-38). Each rank
also runs a sharded call on a local mesh of 2 entries, so the reduction
spans ranks and local devices together (2P shards).

The ranks run on the card (``cuda:(rank % device count)``, both mesh
entries on it) unless ``RAYTRACE_FORCE_CPU=1`` asks for the CPU; without a
card and without that variable a rank raises. With a card for every rank
they join gloo and NCCL, and the sharded call's image is summed over the
ranks on the cards; otherwise gloo alone
(``distributed.backend_for``).

Usage (one invocation per process, see tests/test_torch_distributed.py):
    python raytrace_tpu_torch/tools/run_distributed.py <pid> <nproc> <port>

Prints a CHECK line per check and a RESULT line; exit code 0 iff every
check passes on this rank.
"""

import os
import sys
import time


def main() -> int:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import numpy as np

    from raytrace_tpu_torch import create_image
    from raytrace_tpu_torch.parallel import collectives, distributed
    from raytrace_tpu_torch.parallel.sharding import create_image_sharded
    from raytrace_tpu_torch.testing import synthetic_problem

    cpu = os.environ.get("RAYTRACE_FORCE_CPU") == "1"
    distributed.startup(coordinator_address=f"localhost:{port}",
                        num_processes=nproc, process_id=pid, cpu=cpu)
    ok = True

    def check(name, cond):
        nonlocal ok
        ok = ok and bool(cond)
        print(f"CHECK[{pid}] {name}: {'pass' if cond else 'FAIL'}",
              flush=True)

    try:
        check("rank_size", distributed.rank() == pid
              and distributed.size() == nproc)
        dev = distributed.rank_device(cpu)

        # --- gather_all: per-rank timings, distinct values per rank ---------
        t0 = time.perf_counter()
        gathered = collectives.gather_all(np.array([100.0 + pid,
                                                    0.5 * (pid + 1)]))
        check("gather_all_shape", gathered.shape == (nproc, 2))
        check("gather_all_values",
              np.allclose(gathered[:, 0], 100.0 + np.arange(nproc)))

        # --- sum_scalar: error-count reduction, type kept -------------------
        total = collectives.sum_scalar(pid + 1)
        check("sum_scalar", total == nproc * (nproc + 1) // 2
              and isinstance(total, int))

        # --- host_sum_arrays: distinct per-rank buffers ----------------------
        a = np.full((3, 2), float(pid + 1))
        b = np.arange(4, dtype=np.float64) * (pid + 1)
        sa, sb = collectives.host_sum_arrays([a, b])
        tot = nproc * (nproc + 1) / 2
        check("host_sum_arrays", sa.shape == (3, 2)
              and np.allclose(sa, tot) and np.allclose(sb, np.arange(4) * tot))

        # --- MPI-style run: stride decomposition over ranks, image sum -------
        kw = dict(nx=6, ny=4, na=4, nb=3, nv=5)
        img_full, ang_full = create_image(synthetic_problem(**kw), "auto",
                                          dev, chunk_size=1024)
        p_mine = synthetic_problem(**kw)
        p_mine.N_start, p_mine.N_parallel = pid, nproc
        img_p, ang_p = create_image(p_mine, "auto", dev, chunk_size=1024)
        img_sum, ang_sum = collectives.host_sum_arrays([img_p, ang_p])
        check("stride_partition_image",
              np.allclose(img_sum, img_full, rtol=1e-10, atol=1e-300))
        check("stride_partition_iang",
              np.allclose(ang_sum, ang_full, rtol=1e-10, atol=1e-300))

        # --- sharded run: a local mesh of 2 per rank, 2P shards in all -------
        img_sh, ang_sh = create_image_sharded(
            synthetic_problem(**kw), (dev, dev), "auto", chunk_size=512)
        check("global_mesh_image",
              np.allclose(img_sh, img_full, rtol=1e-10, atol=1e-300))
        check("global_mesh_iang",
              np.allclose(ang_sh, ang_full, rtol=1e-10, atol=1e-300))

        # gathered wall-times: every rank sees every rank's entry
        times = collectives.gather_all(np.array([time.perf_counter() - t0]))
        check("gather_all_timings", times.shape == (nproc, 1)
              and np.all(times > 0))
        distributed.barrier()
    finally:
        distributed.shutdown()
    print(f"RESULT[{pid}] {'ALL_PASS' if ok else 'SOME_FAIL'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if not __package__:
        # run by path: the repository root holds the package
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))
    raise SystemExit(main())
