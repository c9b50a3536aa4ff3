"""The port's multi-card path on the CPU: the mesh's entries dispatched in
turns, the process group's backend from its layout, and ranks times mesh
entries against the JAX package's sharded call.

* On a mesh of ``("cpu",) * 4`` at 11 rays a chunk (several chunks an
  entry, a ragged last chunk, and one entry a chunk short of the others):
  the order of the entries' chunks seen by a recording wrapper around the
  plain deposit, the images bitwise equal to dispatching the entries one
  after another, and within 1e-5 of ``raytrace_tpu``'s
  ``create_image_sharded`` on 4 virtual devices (tests/conftest.py), in
  both methods.
* ``distributed.backend_for`` over ranks, cards and a CPU run.
* 2 gloo ranks of 2 CPU entries each (4 shards) against the JAX package's
  sharded call on 4 virtual devices.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from raytrace_tpu.parallel.mesh import make_mesh as jax_make_mesh
from raytrace_tpu.parallel.sharding import \
    create_image_sharded as jax_create_image_sharded
from raytrace_tpu.testing import synthetic_problem as jax_synthetic

from raytrace_tpu_torch.models import ray_tracer
from raytrace_tpu_torch.ops import cuda_lib, deposit_kernel
from raytrace_tpu_torch.parallel import collectives, distributed, sharding
from raytrace_tpu_torch.parallel.sharding import (create_image_sharded,
                                                  prepare_sharded)
from raytrace_tpu_torch.testing import synthetic_problem

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: 135 ASE rays (336 seeded); on 4 entries 34, 34, 34 and 33 ASE rays, so
#: at 11 a chunk the first three take 4 chunks (the last of 1 ray) and the
#: fourth 3
SMALL = dict(nx=5, ny=3, na=3, nb=3, nv=5)
CHUNK = 11
MESH = ("cpu",) * 4


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def test_entries_dispatched_in_turns(monkeypatch):
    """One chunk of each entry a turn, in mesh order; an entry whose
    chunks are done drops out of the turns."""
    order, seen = [], {}
    plain = deposit_kernel.bin_deposit_plain

    def recording(Iv, coords, ok, beam, method, scale, image_acc, iang_acc):
        # each entry deposits into its own accumulator
        order.append(seen.setdefault(image_acc.data_ptr(), len(seen)))
        plain(Iv, coords, ok, beam, method, scale, image_acc, iang_acc)

    monkeypatch.setattr(deposit_kernel, "bin_deposit_plain", recording)
    create_image_sharded(synthetic_problem(**SMALL), MESH, "cpu",
                         chunk_size=CHUNK)
    assert order == [0, 1, 2, 3] * 3 + [0, 1, 2]


def _entry_by_entry(problem, mesh):
    """The sharded call's reduced output with the entries dispatched one
    after another, each to its end."""
    prep = prepare_sharded(problem, mesh, "cpu")
    calls = []
    for dev, sp in prep.shards:
        entry = ray_tracer._prepare(sp, "cpu", torch.device(dev), CHUNK, 0.5,
                                    readback=False, eager=True)
        calls.append(entry.pipeline(*entry.operands))
    out = collectives.sum_reduce([c.out for c in calls]).numpy()
    return ray_tracer._finish(problem, out,
                              [(sp, c.codes) for (_dev, sp), c in
                               zip(prep.shards, calls)], prep.cfg["method"],
                              "unused.dat")


@pytest.mark.parametrize("seeded", [False, True])
def test_turns_bitwise_equal_entry_by_entry(seeded):
    """Each entry's chunks, their order and its f64 accumulation are its
    own single call's, so the turns change no bit of the image."""
    got = create_image_sharded(synthetic_problem(seeded=seeded, **SMALL),
                               MESH, "cpu", chunk_size=CHUNK)
    want = _entry_by_entry(synthetic_problem(seeded=seeded, **SMALL), MESH)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("seeded", [False, True])
def test_turns_vs_jax_sharded(seeded):
    """Against the JAX package's sharded call on 4 virtual devices (the
    lax backend), at the bound of tests/test_torch_parallel.py."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual JAX devices")
    img, ang = create_image_sharded(synthetic_problem(seeded=seeded, **SMALL),
                                    MESH, "cpu", chunk_size=CHUNK)
    img_j, ang_j = jax_create_image_sharded(
        jax_synthetic(seeded=seeded, **SMALL), jax_make_mesh(4), "lax")
    assert _rel(img, img_j) < 1e-5 and _rel(ang, ang_j) < 1e-5


def test_dispatch_steps_one_a_chunk():
    """``_dispatch_steps`` yields once a chunk and returns the call that
    the eager pipeline returns, bit for bit."""
    prep = ray_tracer.prepare_pipeline(synthetic_problem(**SMALL), "cpu",
                                       chunk_size=CHUNK)
    steps = ray_tracer._dispatch_steps(prep.cfg, *prep.operands)
    n = 0
    while True:
        try:
            next(steps)
            n += 1
        except StopIteration as stop:
            call = stop.value
            break
    assert n == -(-135 // CHUNK)
    eager = ray_tracer._prepare(synthetic_problem(**SMALL), "cpu",
                                torch.device("cpu"), CHUNK, 0.5, eager=True)
    want = eager.pipeline(*eager.operands)
    assert torch.equal(call.out, want.out)
    assert torch.equal(call.codes, want.codes)


def test_per_device_counts_and_the_cpu_guard():
    """A launch is booked under its C entry and device, a failed one not at
    all, and a batch (a graph replay's) per device; the guard is a null
    context for CPU tensors (the plain twins, the host-built library)."""
    class Lib:
        def rt_trace(self, rc):
            return rc

    cpu, card = torch.device("cpu"), torch.device("cuda", 1)
    before = cuda_lib.launches()
    for dev in ("cpu", cpu):
        cuda_lib.launch(Lib(), "rt_trace", dev, 0)
    with pytest.raises(RuntimeError, match="rt_trace"):
        cuda_lib.launch(Lib(), "rt_trace", cpu, 2)
    cuda_lib.book({("rt_trace", card): 3})
    made = cuda_lib.since(before)
    assert made == {("rt_trace", cpu): 2, ("rt_trace", card): 3}
    assert cuda_lib.per_entry(made) == {"rt_trace": 5}
    cuda_lib.book({k: -n for k, n in made.items()})
    assert not cuda_lib.since(before)
    with cuda_lib.device_guard("cpu"):
        pass


def test_timeline_is_none_on_the_cpu():
    """The marks are CUDA events: a CPU mesh records none."""
    runner = sharding.MeshRunner(MESH, "cpu", CHUNK)
    call = runner.dispatch(synthetic_problem(**SMALL))
    sharding._finalize_sharded(call, "unused.dat")
    assert call.marks is None and sharding.timeline(call) is None
    assert not call.ranks_summed


@pytest.mark.parametrize("nprocs, cards, cpu, want", [
    (1, 1, False, distributed.DEVICE_BACKEND),
    (4, 4, False, distributed.DEVICE_BACKEND),
    (2, 4, False, distributed.DEVICE_BACKEND),
    (4, 2, False, "gloo"),     # ranks share a card: NCCL refuses
    (2, 1, False, "gloo"),
    (4, 0, False, "gloo"),     # no card
    (4, 4, True, "gloo"),      # the CPU asked for
    (1, 8, True, "gloo"),
])
def test_backend_follows_the_layout(nprocs, cards, cpu, want):
    """NCCL beside gloo only when every rank has a card of its own and the
    ranks run on the cards."""
    assert distributed.backend_for(nprocs, cards, cpu) == want


def test_cpu_group_stays_gloo():
    """Without a process group no device collective runs; the CPU layout
    of any size is gloo."""
    assert not distributed.device_collectives()
    assert all(distributed.backend_for(p, torch.cuda.device_count(), True)
               == "gloo" for p in (1, 2, 4))


_RANK = r"""
import sys
import numpy as np
from raytrace_tpu_torch.parallel import distributed
from raytrace_tpu_torch.parallel.sharding import create_image_sharded
from raytrace_tpu_torch.testing import synthetic_problem

pid, port, out, seeded = int(sys.argv[1]), sys.argv[2], sys.argv[3], \
    sys.argv[4] == "1"
distributed.startup(f"localhost:{port}", 2, pid, cpu=True)
try:
    # gloo: the rank sum is of the host copy
    assert distributed.is_distributed()
    assert not distributed.device_collectives()
    img, ang = create_image_sharded(
        synthetic_problem(seeded=seeded, nx=5, ny=3, na=3, nb=3, nv=5),
        ("cpu", "cpu"), "cpu", chunk_size=11)
    np.savez(out, image=img, i_ang=ang)
finally:
    distributed.shutdown()
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("seeded", [False, True])
def test_two_ranks_of_two_entries_vs_jax(seeded, tmp_path):
    """G = P x D = 4 shards: rank r's entry d takes shard 2r + d; every
    rank returns the gloo sum, which agrees with the JAX package's sharded
    call on 4 virtual devices."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual JAX devices")
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    port = str(_free_port())
    outs = [str(tmp_path / f"rank{pid}.npz") for pid in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(pid), port, outs[pid],
         str(int(seeded))], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    assert "process group: 2 ranks, backend gloo" in logs[0], logs[0]
    img_j, ang_j = jax_create_image_sharded(
        jax_synthetic(seeded=seeded, **SMALL), jax_make_mesh(4), "lax")
    for path in outs:
        got = np.load(path)
        assert _rel(got["image"], img_j) < 1e-5
        assert _rel(got["i_ang"], ang_j) < 1e-5
    ranks = [np.load(path) for path in outs]
    assert np.array_equal(ranks[0]["image"], ranks[1]["image"])
