"""The port's benchmark (``raytrace_tpu_torch.tools.bench``) on the CPU at
tiny shapes: every row of the root ``bench.py`` under its key names, explicit
memory records, stage splits that add up to each call's total, the summary
line, no fallback to the CPU without ``--cpu``, and failed gates and rows in
the exit code."""

import json

import pytest
import torch

from raytrace_tpu_torch.tools import bench

torch.set_num_threads(2)

TINY = dict(nx=8, ny=5, na=5, nb=4, nv=6)
SHAPES = (TINY, dict(TINY, seeded=True))
SCALES = (2.0, 2.0, 4.0)

#: the root bench.py's keys of each kind of row; ``vs_baseline`` is left
#: out: its baseline is the reference binary on another host's CPU
SYNC_KEYS = ("rays_per_sec", "best_seconds_per_call",
             "median_seconds_per_call", "avg_seconds_per_call",
             "std_seconds_per_call", "stability_ok", "calls")
STREAM_KEYS = ("rays_per_sec", "best_seconds_per_call",
               "median_seconds_per_call", "rounds", "steady_best_s",
               "steady_median_s", "steady_avg_s", "steady_std_s",
               "steady_stability_ok", "steady_rays_per_sec", "rtt_probe_s",
               "rtt_probe_median_s")
ROW_EXTRA = {"seed_small": ("golden_check",),
             "scale16": ("n_rays", "cross_backend_check"),
             "seed_scale4": ("n_rays", "cross_backend_check"),
             "scale64": ("n_rays",)}
HEADLINE = ("metric", "value", "unit", "best_seconds_per_call",
            "median_seconds_per_call", "avg_seconds_per_call",
            "std_seconds_per_call", "stability_ok", "golden_check", "method",
            "platform", "schema", "provenance", "rtt_probe_s",
            "rtt_probe_median_s", "readback_probe_s",
            "readback_probe_median_s")
SYNC_ROWS = ("ase_small", "seed_small", "scale16", "seed_scale4", "scale64")
STREAM_ROWS = ("ase_stream", "seed_stream", "scale16_stream")


def _tiny(monkeypatch, reps, rounds):
    """Point main() at the tiny shapes and the given rows."""
    monkeypatch.setattr(bench, "SHAPES", SHAPES)
    monkeypatch.setattr(bench, "SCALES", SCALES)
    monkeypatch.setattr(bench, "REPS", reps)
    monkeypatch.setattr(bench, "STREAM_ROUNDS", rounds)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    return bench.run("cpu", shapes=SHAPES, scales=SCALES,
                     reps={k: 2 for k in bench.REPS},
                     stream_rounds={k: 1 for k in bench.STREAM_ROUNDS},
                     out_dir=str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("row", SYNC_ROWS + STREAM_ROWS)
def test_row_keys_of_the_root_bench(artifact, row):
    keys = SYNC_KEYS if row in SYNC_ROWS else STREAM_KEYS
    for k in keys + ROW_EXTRA.get(row, ()):
        assert f"{row}_{k}" in artifact, f"{row}_{k}"
    # the port's own: memory, explicit on the CPU, and launches per call
    # (the twins launch nothing)
    assert artifact[f"mem_after_{row}"] == {"unavailable": "cpu"}
    assert artifact[f"{row}_launches_per_call"] == {}


def test_headline_and_gates(artifact):
    for k in HEADLINE:
        assert k in artifact, k
    assert artifact["value"] == artifact["ase_small_rays_per_sec"]
    assert artifact["golden_check"] and artifact["gates_ok"]
    assert set(artifact["golden_checks"]) == {"golden_ase.dat",
                                              "golden_seed.dat"}
    # the scale-flat and graph-memory gates need device memory
    # statistics: not evaluated
    assert artifact["scale_flat_check"] is None
    assert artifact["graph_memory_check"] is None
    assert artifact["gates_not_evaluated"] == ["graph_memory_check",
                                               "scale_flat_check"]
    for row in SYNC_ROWS:
        assert artifact["gates"][f"{row}_cross_backend_check"] is True
    for row in STREAM_ROWS:
        assert artifact["gates"][f"{row}_sync_check"] is True
        assert artifact[f"{row}_max_rel_vs_sync"] <= 1e-12
    # the scaled rows' ray counts follow scale_problem
    assert artifact["scale64_n_rays"] > artifact["scale16_n_rays"] > 0


@pytest.mark.parametrize("row", SYNC_ROWS)
def test_stage_split_adds_up(artifact, row):
    """prepare_pipeline, the pipeline and _finalize_call, as the root
    bench splits a call; on the CPU no graph and no device time."""
    calls = artifact[f"{row}_calls"]
    assert len(calls) == 2
    assert artifact[f"{row}_graph"] is None
    assert artifact[f"{row}_busy"] is None
    for c in calls:
        stages = ("prep_s", "dispatch_s", "wait_s")
        assert set(c) == {"total_s", *stages}
        assert min(c[s] for s in stages) >= 0.0
        assert sum(c[s] for s in stages) == pytest.approx(c["total_s"],
                                                          rel=1e-9)


def test_main_last_line(monkeypatch, capsys, tmp_path):
    _tiny(monkeypatch, {"ase_small": 2, "seed_small": 1}, {})
    out = tmp_path / "bench_torch.json"
    assert bench.main(["--cpu", "--out", str(out)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-2]) == json.loads(out.read_text())
    last = json.loads(lines[-1])
    for k in ("metric", "value", "unit", "best_seconds_per_call",
              "stability_ok", "golden_check", "gates_ok", "method",
              "platform", "card", "git_commit", "torch", "cuda",
              "chunk_size", "seed_small_best_seconds_per_call"):
        assert k in last, k
    assert last["platform"] == "cpu" and last["gates_ok"] is True


def test_main_without_a_card_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def never(*a, **kw):
        raise AssertionError("ran without a card")

    monkeypatch.setattr(bench, "run", never)
    with pytest.raises(SystemExit) as e:
        bench.main([])
    assert e.value.code not in (0, None)


def test_failed_twin_gate_sets_the_exit_code(monkeypatch, tmp_path):
    _tiny(monkeypatch, {"ase_small": 1}, {})
    twin = bench._twin

    def differing_twin(ctx, source, scale):
        (image, i_ang), dt = twin(ctx, source, scale)
        return (image * 1.01, i_ang), dt

    monkeypatch.setattr(bench, "_twin", differing_twin)
    out = tmp_path / "bench_torch.json"
    assert bench.main(["--cpu", "--out", str(out)]) == 1
    res = json.loads(out.read_text())
    assert res["ase_small_cross_backend_check"] is False
    assert res["gates_ok"] is False


@pytest.mark.parametrize("peaks, flat", [((100, 110), True),
                                         ((100, 111), False)])
def test_scale_flat_gate(monkeypatch, tmp_path, peaks, flat):
    it = iter(peaks)
    monkeypatch.setattr(bench, "_memory", lambda dev: {
        "max_memory_allocated": next(it)})
    res = bench.run("cpu", shapes=SHAPES, scales=SCALES,
                    reps={"scale16": 1, "scale64": 1}, stream_rounds={},
                    twins=(), out_dir=str(tmp_path))
    assert res["scale_flat_ratio"] == pytest.approx(peaks[1] / peaks[0])
    assert res["scale_flat_check"] is flat and res["gates_ok"] is flat
    assert res["scale16_cross_backend_check"] is None


@pytest.mark.parametrize("row", SYNC_ROWS)
def test_graph_memory_keys(artifact, row):
    """Every synchronous row records its reserved memory and the gate;
    on the CPU none of them is evaluated."""
    for k in ("reserved_gib", "reserved_over_pools_gib",
              "graph_memory_check"):
        assert artifact[f"{row}_{k}"] is None


MIB = 2 ** 20


@pytest.mark.parametrize("over, peak, eager, ok", [
    (255 * MIB, 1024 * MIB, False, True),    # under the 256 MiB floor
    (257 * MIB, 1024 * MIB, False, False),
    (1000 * MIB, 10240 * MIB, False, True),  # under a tenth of the peak
    (1100 * MIB, 10240 * MIB, False, False),
    (5000 * MIB, 1024 * MIB, True, None),    # eager: no graph to count
])
def test_graph_memory_gate(monkeypatch, over, peak, eager, ok):
    """The card's reserved bytes less the cached graphs' pools against
    max(256 MiB, 0.10 x the row's peak of allocated bytes)."""
    pools = 3000 * MIB
    monkeypatch.setattr(bench.ray_tracer, "graph_pool_bytes",
                        lambda dev: pools)
    ctx = bench._Ctx(torch.device("cuda", 0), "cuda", "unused.dat", eager)
    got = bench._graph_memory(ctx, torch.device("cuda", 0), {
        "max_memory_allocated": peak, "memory_reserved": pools + over})
    assert got["graph_memory_check"] is ok
    assert got["reserved_gib"] == (pools + over) / 2 ** 30
    assert got["reserved_over_pools_gib"] == over / 2 ** 30


@pytest.mark.parametrize("mesh", [None, 2])
def test_failed_graph_memory_gate_sets_gates_ok(monkeypatch, tmp_path,
                                                mesh):
    """A row over the graph-memory bound fails ``graph_memory_check`` and
    the run; on a mesh row, a card over it."""
    failing = {"reserved_gib": 2.0, "reserved_over_pools_gib": 1.0,
               "graph_memory_check": False}
    if mesh is None:
        monkeypatch.setattr(bench, "_graph_memory",
                            lambda ctx, dev, mem: failing)
    else:
        real = bench._mesh_row

        def mesh_row(ctx, name, cards, *a):
            row = real(ctx, name, cards, *a)
            row[f"{name}_mesh2_graph_memory_check"] = False
            return row
        monkeypatch.setattr(bench, "_mesh_row", mesh_row)
    res = bench.run("cpu", shapes=SHAPES, scales=SCALES,
                    reps={"ase_small": 1}, stream_rounds={}, twins=(),
                    out_dir=str(tmp_path), mesh=mesh)
    assert res["graph_memory_check"] is False
    assert res["gates"]["graph_memory_check"] is False
    assert res["gates_ok"] is False


def test_a_row_that_raises_fails_the_run(monkeypatch, tmp_path):
    def broken(*a, **kw):
        raise RuntimeError("row failed")

    monkeypatch.setattr(bench, "_timed_call", broken)
    with pytest.raises(RuntimeError, match="row failed"):
        bench.run("cpu", shapes=SHAPES, scales=SCALES,
                  reps={"ase_small": 1}, stream_rounds={},
                  out_dir=str(tmp_path))


@pytest.fixture(scope="module")
def mesh_artifact(tmp_path_factory):
    return bench.run("cpu", shapes=SHAPES, scales=SCALES,
                     reps={k: 2 for k in bench.MESH_ROWS}, stream_rounds={},
                     twins=(), out_dir=str(tmp_path_factory.mktemp("mesh")),
                     mesh=4)


@pytest.mark.parametrize("row", bench.MESH_ROWS)
def test_mesh_rows(mesh_artifact, row):
    """``--mesh 4`` adds ``<row>_mesh4``: the row's units through the
    sharded call on 4 entries, held against the 1-card call, with its
    speedup over the 1-card row and each call's split."""
    p = f"{row}_mesh4_"
    for k in SYNC_KEYS + ("n_rays", "speedup", "launches_per_call",
                          "launches_per_card", "rel_vs_single", "devices"):
        assert p + k in mesh_artifact, p + k
    assert mesh_artifact[p + "n_rays"] == mesh_artifact[f"{row}_n_rays"]
    assert mesh_artifact[p + "single_check"] is True
    assert mesh_artifact[p + "rel_vs_single"] <= bench.MESH_REL
    assert mesh_artifact[p + "speedup"] == pytest.approx(
        mesh_artifact[f"{row}_best_seconds_per_call"]
        / mesh_artifact[p + "best_seconds_per_call"])
    assert mesh_artifact[p + "devices"] == ["cpu"] * 4
    assert mesh_artifact[f"mem_after_{row}_mesh4"] == {"unavailable": "cpu"}
    for c in mesh_artifact[p + "calls"]:
        # the CPU has no timing events: no reduce_s, no per-card marks
        assert set(c) == {"total_s", "dispatch_s", "wait_s"}
        assert c["dispatch_s"] + c["wait_s"] == pytest.approx(c["total_s"],
                                                              rel=1e-9)
    assert mesh_artifact["gates"][p + "single_check"] is True


def test_mesh_goldens_and_gates(mesh_artifact, artifact):
    assert mesh_artifact["mesh4_golden_check"] is True
    assert mesh_artifact["gates"]["mesh4_golden_check"] is True
    assert mesh_artifact["gates_ok"] is True
    # without --mesh no key of the mesh rows appears
    assert not [k for k in artifact if "mesh" in k]


def test_failed_mesh_gate_sets_gates_ok(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "MESH_REL", -1.0)
    res = bench.run("cpu", shapes=SHAPES, scales=SCALES,
                    reps={"ase_small": 1}, stream_rounds={}, twins=(),
                    out_dir=str(tmp_path), mesh=2)
    assert res["ase_small_mesh2_single_check"] is False
    assert res["gates_ok"] is False


@pytest.fixture(scope="module")
def f32_artifact(tmp_path_factory):
    return bench.run("cpu", shapes=SHAPES, scales=SCALES,
                     reps={"seed_small": 2, "seed_scale4": 2},
                     stream_rounds={"seed_stream": 1},
                     out_dir=str(tmp_path_factory.mktemp("bench_f32")),
                     spectrum=torch.float32)


@pytest.mark.parametrize("row", ["seed_small", "seed_scale4", "seed_stream"])
def test_f32_rows(f32_artifact, row):
    """``spectrum=float32``: each row named ``<row>_f32`` with the root
    bench's keys; each synchronous f32 row within 1e-5 of its unit's f64
    call, gated; no f64 row is run."""
    keys = SYNC_KEYS if row in SYNC_ROWS else STREAM_KEYS
    for k in keys:
        assert f"{row}_f32_{k}" in f32_artifact, f"{row}_f32_{k}"
        assert f"{row}_{k}" not in f32_artifact
    if row in SYNC_ROWS:
        assert f32_artifact[f"{row}_f32_rel_vs_f64"] <= bench.F32_REL
        assert f32_artifact["gates"][f"{row}_f32_f64_check"] is True
    assert f32_artifact["spectrum"] == "float32" and f32_artifact["gates_ok"]


def test_f32_summary(monkeypatch, capsys, tmp_path):
    """``--spectrum=f32``: the rows in f32, and the summary line carries
    their keys and their f64 gates."""
    _tiny(monkeypatch, {"seed_small": 1}, {})
    out = tmp_path / "bench.json"
    assert bench.main(["--cpu", "--out", str(out), "--spectrum=f32"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["spectrum"] == "float32"
    assert "seed_small_f32_best_seconds_per_call" in last
    assert last["seed_small_f32_f64_check"] is True
    full = json.loads(out.read_text())
    assert full["gates"]["seed_small_f32_f64_check"] is True
