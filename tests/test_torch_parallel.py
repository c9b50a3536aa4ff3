"""The port's multi-device layer on the CPU (``raytrace_tpu_torch.parallel``):
meshes of CPU entries against the JAX package's sharded call on its 8
virtual CPU devices (tests/conftest.py) and against the port's own single
call; the stride contract under a mesh; the failure path; the sharded
stream; the single-process shims of the process group; IntensityStep and
Intensity against ``raytrace_tpu.structures``; the CLI's ``-multichip``."""

import os

import numpy as np
import pytest
import torch

import jax
from raytrace_tpu.parallel.mesh import make_mesh as jax_make_mesh
from raytrace_tpu.parallel.sharding import \
    create_image_sharded as jax_create_image_sharded
from raytrace_tpu import structures as jax_structures
from raytrace_tpu.testing import synthetic_problem as jax_synthetic

from raytrace_tpu_torch import create_image, create_image_stream
from raytrace_tpu_torch import structures
from raytrace_tpu_torch.parallel import collectives, distributed
from raytrace_tpu_torch.parallel.mesh import make_mesh
from raytrace_tpu_torch.parallel.sharding import (create_image_sharded,
                                                  prepare_sharded)
from raytrace_tpu_torch.testing import perturbed_problems, synthetic_problem
from raytrace_tpu_torch.utils.errors import RayTraceError, read_failures

torch.set_num_threads(2)

SMALL = dict(nx=6, ny=4, na=4, nb=3, nv=5)
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _cpu(D):
    return ("cpu",) * D


@pytest.mark.parametrize("D", [1, 2, 3, 8])
@pytest.mark.parametrize("seeded", [False, True])
def test_sharded_vs_jax_sharded(seeded, D):
    """The port's mesh of D CPU entries against the JAX package's sharded
    call on D virtual devices (the lax backend): the bound of
    tests/test_torch_create_image.py."""
    if len(jax.devices()) < D:
        pytest.skip("needs 8 virtual JAX devices")
    img, ang = create_image_sharded(synthetic_problem(seeded=seeded, **SMALL),
                                    _cpu(D), "cpu")
    img_j, ang_j = jax_create_image_sharded(
        jax_synthetic(seeded=seeded, **SMALL), jax_make_mesh(D), "lax")
    assert _rel(img, img_j) < 1e-5 and _rel(ang, ang_j) < 1e-5


@pytest.mark.parametrize("D", [1, 2, 3, 8])
@pytest.mark.parametrize("seeded", [False, True])
def test_sharded_vs_single(seeded, D):
    """Each entry runs the single call's chunk loop on its stride: the
    summed f64 images equal the single call's to rounding, and are stored
    on the problem."""
    img1, ang1 = create_image(synthetic_problem(seeded=seeded), "cpu")
    p = synthetic_problem(seeded=seeded)
    img, ang = create_image_sharded(p, _cpu(D), "cpu", chunk_size=70)
    assert _rel(img, img1) < 1e-13 and _rel(ang, ang1) < 1e-13
    assert p.image is img and p.I_ang is ang
    assert img.shape == img1.shape and ang.shape == ang1.shape


def test_shard_strides_partition_the_rays():
    """Shard d of D takes N_start + d*N_parallel with stride D*N_parallel
    (the JAX package's it = ci*chunk + d + j*D): together the shards' rays
    are the problem's, each once."""
    from raytrace_tpu_torch.models.ray_tracer import generate_ray_indices

    p = synthetic_problem(**SMALL)
    p.N_start, p.N_parallel = 2, 5
    prep = prepare_sharded(p, _cpu(3), "cpu")
    got = np.sort(np.concatenate([generate_ray_indices(sp)
                                  for _dev, sp in prep.shards]))
    assert np.array_equal(got, generate_ray_indices(p))
    assert [sp.N_start for _d, sp in prep.shards] == [2, 7, 12]
    assert {sp.N_parallel for _d, sp in prep.shards} == {15}


@pytest.mark.parametrize("seeded", [False, True])
def test_sharded_nontrivial_stride_partition(seeded):
    """Rank stride x mesh stride: a 3-way N_start/N_parallel partition,
    each part through a mesh of 4, sums to the full image; a strided part
    equals the single call on the same stride."""
    img_full, ang_full = create_image(synthetic_problem(seeded=seeded), "cpu")
    img_sum, ang_sum = np.zeros_like(img_full), np.zeros_like(ang_full)
    for k in range(3):
        pk = synthetic_problem(seeded=seeded)
        pk.N_start, pk.N_parallel = k, 3
        img_k, ang_k = create_image_sharded(pk, _cpu(4), "cpu")
        ps = synthetic_problem(seeded=seeded)
        ps.N_start, ps.N_parallel = k, 3
        img_s, ang_s = create_image(ps, "cpu")
        assert _rel(img_k, img_s) < 1e-13 and _rel(ang_k, ang_s) < 1e-13
        img_sum += img_k
        ang_sum += ang_k
    assert _rel(img_sum, img_full) < 1e-13
    assert _rel(ang_sum, ang_full) < 1e-13


def test_more_entries_than_rays():
    """Shards without rays yield zeros: 4 rays on 8 entries, and a stride
    that leaves 1 ray."""
    kw = dict(nx=2, ny=1, na=1, nb=2, nv=3)
    want = create_image(synthetic_problem(**kw), "cpu")
    got = create_image_sharded(synthetic_problem(**kw), _cpu(8), "cpu")
    assert _rel(got[0], want[0]) < 1e-13 and _rel(got[1], want[1]) < 1e-13
    p, ps = synthetic_problem(**kw), synthetic_problem(**kw)
    p.N_start = ps.N_start = 3
    p.N_parallel = ps.N_parallel = 4
    got = create_image_sharded(p, _cpu(8), "cpu")
    want = create_image(ps, "cpu")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("D", [2, 3])
def test_sharded_failure_names_the_same_rays(tmp_path, D):
    """A near-perpendicular ray on a mesh: the dump names the same physical
    rays, in the same order, as the single call's."""
    def bad():
        p = synthetic_problem()
        p.euv_beam.a = p.euv_beam.a + 1500.0  # s_z^2 < 0.01 -> error -1
        return p

    one, many = tmp_path / "single.dat", tmp_path / "mesh.dat"
    with pytest.raises(RayTraceError):
        create_image(bad(), "cpu", failed_ray_path=str(one))
    with pytest.raises(RayTraceError):
        create_image_sharded(bad(), _cpu(D), "cpu",
                             failed_ray_path=str(many))
    rays, method, N, _dz, _g = read_failures(str(many))
    want = read_failures(str(one))[0]
    assert method == 1 and N == 3 and 1 <= len(rays) <= 32
    np.testing.assert_array_equal(rays, want)


def test_sharded_seeded_failure_vs_single(tmp_path):
    """A NaN in the seed's frequency profile (B3's flag path): every
    entry's failed rays are merged in the single call's order."""
    def bad():
        p = synthetic_problem(seeded=True, **SMALL)
        p.seed.f[4][2] = np.nan
        return p

    one, many = tmp_path / "single.dat", tmp_path / "mesh.dat"
    with pytest.raises(RayTraceError):
        create_image(bad(), "cpu", failed_ray_path=str(one))
    with pytest.raises(RayTraceError):
        create_image_sharded(bad(), _cpu(3), "cpu",
                             failed_ray_path=str(many))
    np.testing.assert_array_equal(read_failures(str(many))[0],
                                  read_failures(str(one))[0])


def _mixed(i):
    return synthetic_problem(nx=5, ny=4, na=3, nb=3, nv=4,
                             seeded=i % 2 == 1, rng=300 + i)


def test_sharded_stream_matches_per_call():
    """create_image_stream(mesh=...) yields the sharded call's results,
    bitwise, in order, stored on each problem."""
    want = [create_image_sharded(_mixed(i), _cpu(3), "cpu", chunk_size=40)
            for i in range(4)]
    probs = [_mixed(i) for i in range(4)]
    got = list(create_image_stream(probs, "cpu", chunk_size=40,
                                   mesh=_cpu(3), depth=2))
    assert len(got) == 4
    for i, ((gi, ga), (wi, wa)) in enumerate(zip(got, want)):
        assert np.array_equal(gi, wi) and np.array_equal(ga, wa), i
        assert probs[i].image is gi and probs[i].I_ang is ga


@pytest.mark.parametrize("seeded", [False, True])
def test_sharded_stream_reorder(seeded):
    """The reorder per entry (each entry's feedback keyed by its own
    stride): the first call is the natural order, bitwise the sharded
    call; later ones agree to 1e-12."""
    kw = dict(nx=8, ny=5, na=5, nb=4, nv=6, seeded=seeded)

    def units():
        return perturbed_problems(lambda: synthetic_problem(**kw), 3, salt=2)

    want = [create_image_sharded(p, _cpu(2), "cpu", chunk_size=150)
            for p in units()]
    got = list(create_image_stream(units(), "cpu", chunk_size=150,
                                   mesh=_cpu(2), reorder=True))
    assert np.array_equal(got[0][0], want[0][0])
    assert np.array_equal(got[0][1], want[0][1])
    for (gi, ga), (wi, wa) in zip(got, want):
        assert _rel(gi, wi) < 1e-12 and _rel(ga, wa) < 1e-12


def test_stream_device_and_mesh_exclusive():
    with pytest.raises(RayTraceError):
        list(create_image_stream([_mixed(0)], "cpu", device="cpu",
                                 mesh=_cpu(2)))


def test_mesh_rules():
    """CPU entries only by name; repeats allowed; a CUDA entry, or the
    default, without a card raises; one device type per mesh."""
    assert make_mesh(devices=("cpu",) * 3) == (torch.device("cpu"),) * 3
    assert make_mesh(2, devices=["cpu"] * 5) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        make_mesh(4, devices=("cpu",) * 2)
    with pytest.raises(ValueError):
        make_mesh(devices=())
    if torch.cuda.is_available():
        pytest.skip("the card-less rules need a host without a card")
    with pytest.raises(RuntimeError):
        make_mesh()
    with pytest.raises(RuntimeError):
        make_mesh(devices=("cuda:0", "cuda:0"))
    with pytest.raises(ValueError):
        make_mesh(devices=("cpu", "cuda:0"))


def test_cuda_method_on_cpu_mesh_raises():
    with pytest.raises(RayTraceError):
        create_image_sharded(synthetic_problem(), _cpu(2), "cuda")


def test_single_process_shims(monkeypatch):
    """Without a process group every rank collective is the identity and
    startup() without a launcher's environment stays single process; a
    half-set environment, or half the arguments, raise."""
    for name in ("RAYTRACE_COORD", "RAYTRACE_NPROCS", "RAYTRACE_PROC_ID",
                 "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    distributed.startup()
    assert distributed.rank() == 0 and distributed.size() == 1
    assert not distributed.is_distributed()
    g = collectives.gather_all(np.array([1.5, 2.5]))
    assert g.shape == (1, 2) and np.allclose(g[0], [1.5, 2.5])
    assert collectives.gather_all(3.0).shape == (1, 1)
    total = collectives.sum_scalar(7)
    assert total == 7 and isinstance(total, int)
    arrs = [np.arange(3.0), np.ones((2, 2))]
    out = collectives.host_sum_arrays(arrs)
    assert all(np.array_equal(a, b) for a, b in zip(arrs, out))
    distributed.barrier()
    distributed.shutdown()
    monkeypatch.setenv("RAYTRACE_PROC_ID", "0")
    with pytest.raises(RuntimeError, match="half set"):
        distributed.startup()
    monkeypatch.delenv("RAYTRACE_PROC_ID")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(RuntimeError, match="half set"):
        distributed.startup()
    with pytest.raises(ValueError):
        distributed.startup("localhost:1", 2)
    assert distributed.size() == 1


def test_rank_device_never_falls_back_to_the_cpu(monkeypatch):
    """A rank runs on the CPU only when asked; without a card it raises."""
    assert distributed.rank_device(cpu=True) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.rank_device()


def test_sum_reduce_and_mesh_all_gather():
    parts = [torch.full((4,), float(d + 1), dtype=torch.float64)
             for d in range(3)]
    total = collectives.sum_reduce(parts)
    assert torch.equal(total, torch.full((4,), 6.0, dtype=torch.float64))
    assert torch.equal(parts[0], torch.full((4,), 1.0, dtype=torch.float64))
    assert collectives.sum_reduce(parts[:1]) is parts[0]
    per_dev = np.arange(8.0)[:, None] * 10 + np.arange(3.0)[None, :]
    out = collectives.mesh_all_gather(per_dev, _cpu(8))
    assert out.shape == (8, 3) and np.array_equal(out, per_dev)
    one = np.array([[4.0, 5.0]])
    assert np.array_equal(collectives.mesh_all_gather(one, _cpu(1)), one)
    with pytest.raises(ValueError):
        collectives.mesh_all_gather(per_dev, _cpu(4))


@pytest.mark.parametrize("N_seed", [0, 1, 2])
def test_intensity_vs_jax(N_seed):
    """IntensityStep and Intensity against raytrace_tpu.structures on the
    same numpy inputs: add (with and without W), the single-process
    sum_reduce, valid, copy_step and E_sum, exactly."""
    nx, ny, na, nb, nv, N = 6, 4, 4, 3, 5, 3
    beam = synthetic_problem(full_plane=True, **SMALL).euv_beam
    hist = structures.Intensity().initialize(N, nx, ny, na, nb, nv, N_seed)
    hist_j = jax_structures.Intensity().initialize(N, nx, ny, na, nb, nv,
                                                   N_seed)
    rng = np.random.default_rng(N_seed)
    for i in range(N):
        steps = []
        for mod in (structures, jax_structures):
            a = mod.IntensityStep().initialize(nx, ny, na, nb, nv, N_seed)
            b = mod.IntensityStep().initialize(nx, ny, na, nb, nv, N_seed)
            steps.append((a, b))
        for k in range(2):
            vals = [rng.uniform(0.0, 2.0, arr.shape)
                    for arr in steps[0][k]._all_arrays()]
            for pair in steps:
                for arr, v in zip(pair[k]._all_arrays(), vals):
                    arr[:] = v
        for a, b in steps:
            a.add(b, add_W=i % 2 == 0)
            a.sum_reduce()
        (a, _), (a_j, _) = steps
        assert a.valid() and a_j.valid()
        for x, y in zip(a._all_arrays(), a_j._all_arrays()):
            assert np.array_equal(x, y)
        hist.copy_step(i, beam, a)
        hist_j.copy_step(i, beam, a_j)
    for name in ("E_v", "image", "E_ang", "E_sum", "I_it", "W"):
        assert np.array_equal(getattr(hist, name), getattr(hist_j, name))
    for name in ("E_v_seed", "image_seed", "E_ang_seed", "E_sum_seed",
                 "I_it_seed"):
        for x, y in zip(getattr(hist, name), getattr(hist_j, name)):
            assert np.array_equal(x, y)
    a.E_v[0] = -1.0
    a_j.E_v[0] = -1.0
    assert not a.valid() and not a_j.valid()


def test_intensity_checks():
    with pytest.raises(ValueError):
        structures.IntensityStep().initialize(2, 2, 2, 2, 2,
                                              structures.N_SEED_MAX + 1)
    hist = structures.Intensity().initialize(2, 6, 4, 4, 3, 5, 1)
    step = structures.IntensityStep().initialize(6, 3, 4, 3, 5, 1)
    beam = synthetic_problem(full_plane=True, **SMALL).euv_beam
    with pytest.raises(ValueError):
        hist.copy_step(0, beam, step)


def test_sum_reduce_profiler_region():
    from raytrace_tpu_torch.utils.timer import profiler

    before = profiler.counts.get("Sum reduce images", 0)
    structures.IntensityStep().initialize(3, 2, 2, 2, 4, 1).sum_reduce()
    assert profiler.counts["Sum reduce images"] == before + 1


def test_cli_multichip_rows(monkeypatch, capsys):
    """-multichip adds the multichip[D] row (golden-checked) and, with
    -stream, its stream rows; on the CPU the mesh is named here."""
    from raytrace_tpu_torch.utils import cli

    monkeypatch.setattr(cli, "make_mesh", lambda: _cpu(2))
    argv = ["-methods=cpu", "-iterations=1", "-multichip", "-stream=2",
            os.path.join(FIXTURES, "golden_ase.dat")]
    assert cli.Options(argv).multichip
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    rows = [line.split()[0] for line in out.splitlines() if line.strip()]
    for row in ("cpu", "multichip[2]", "multichip[2]+stream",
                "multichip[2]+stream.steady"):
        assert row in rows, out
    assert "Answers do not match" not in out and "All tests passed" in out


def test_pout_is_rank_gated(monkeypatch, capsys):
    from raytrace_tpu_torch.utils import pio

    pio.pout.write("rank zero\n")
    monkeypatch.setattr(pio, "rank", lambda: 1)
    pio.pout.write("rank one\n")
    assert capsys.readouterr().out == "rank zero\n"
