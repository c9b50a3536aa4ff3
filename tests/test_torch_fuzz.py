"""The port's fuzz and replay tools on the CPU (``RAYTRACE_FORCE_CPU=1``).

* ``tools/fuzz_oracle.run_case`` over the curated cases and 8 random ones
  (seed 0), the twins alone and on ``("cpu",) * 8`` through
  ``create_image_sharded``, and through the stream and its reorder: 0
  problems each (gates: ``tol_for`` against the oracle, 1e-12 between
  backends and stream yields, 1e-5 for the reorder);
* the oracle gate is not vacuous: an image scaled by 1.1 is a mismatch;
* the replay loop: the twins' failure dump reads back field for field,
  every ray reproduces error -1 under the port's oracle, and the replay
  tool exits 0 (a seeded dump prints the method-2 note and counts the
  rays it could not reproduce);
* without a card the fuzz tool raises unless ``RAYTRACE_FORCE_CPU=1``,
  and importing it runs nothing.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytrace_tpu_torch import create_image
from raytrace_tpu_torch.ops import oracle
from raytrace_tpu_torch.testing import synthetic_problem
from raytrace_tpu_torch.tools import fuzz_oracle
from raytrace_tpu_torch.utils.errors import RayTraceError, read_failures

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300

CASES = list(fuzz_oracle.CURATED) + [
    fuzz_oracle.random_config(rng) for rng in [np.random.default_rng(0)]
    for _ in range(8)]


def _env():
    """No card and no ``RAYTRACE_FORCE_CPU``."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("RAYTRACE_FORCE_CPU", None)
    return env


@pytest.fixture(scope="module")
def sweep():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAYTRACE_FORCE_CPU", "1")
        yield fuzz_oracle.Sweep(sharded=True, stream=True)


def test_sweep_runs_the_twins_on_the_cpu(sweep):
    assert sweep.device == torch.device("cpu")
    assert sweep.backends == ("cpu",)
    assert sweep.mesh == (torch.device("cpu"),) * 8


def test_random_cases_are_the_jax_tools():
    """Same seed, same configurations: ``tools/fuzz_oracle.py``'s case
    generator (read from its source; that tool configures jax on
    import)."""
    import ast

    src = open(os.path.join(ROOT, "tools", "fuzz_oracle.py")).read()
    tree = ast.parse(src)
    keep = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name == "random_config")
            or (isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "CURATED"
                        for t in n.targets))]
    ns = {}
    exec(compile(ast.Module(keep, []), "fuzz_oracle", "exec"), ns)
    assert ns["CURATED"] == fuzz_oracle.CURATED
    rng, rng_j = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(24):
        assert (fuzz_oracle.random_config(rng)
                == ns["random_config"](rng_j))


@pytest.mark.parametrize("ci", range(len(CASES)))
def test_case_has_no_problems(ci, sweep):
    assert fuzz_oracle.run_case(ci, CASES[ci], sweep) == 0
    # no case needs the chaos gate, and the twins sit far inside tol_for
    assert [c for c in sweep.chaos if c[0] == ci] == []
    assert sweep.worst["image"] < 1e-5 and sweep.worst["i_ang"] < 1e-5


class _Scaled(fuzz_oracle.Sweep):
    """A backend whose image is off by 10%."""

    def create_image(self, p, backend):
        image, i_ang = super().create_image(p, backend)
        return image * 1.1, i_ang


def test_scaled_image_is_a_mismatch(capsys):
    bad = fuzz_oracle.run_case(0, CASES[0], _Scaled(device="cpu"))
    out = capsys.readouterr().out
    assert bad == 1 and "MISMATCH [0] cpu image" in out, out


def _replay(dump):
    return subprocess.run(
        [sys.executable, "-m", "raytrace_tpu_torch.tools.replay_failed_rays",
         str(dump)], capture_output=True, text=True, timeout=TIMEOUT,
        cwd=ROOT, env=_env())


def test_failure_dump_roundtrip_and_replay(tmp_path):
    """The twins' failed-ray dump reads back field for field, and each
    captured ray reproduces its failure under the port's oracle and
    through the replay tool (tests/test_create_image.py's loop)."""
    p = synthetic_problem()
    p.euv_beam.a = p.euv_beam.a + 1500.0  # tan(1.5 rad) -> s_z^2 < 0.01
    dump = tmp_path / "failed.dat"
    with pytest.raises(RayTraceError):
        create_image(p, "cpu", failed_ray_path=str(dump))

    rays, method, N, dz, gains = read_failures(str(dump))
    assert method == 1 and N == p.N and dz == float(p.euv_beam.dz)
    assert rays.shape[1] == 4 and rays.shape[0] >= 1
    assert len(gains) == p.N
    for g, src in zip(gains, p.gain):
        assert (g.Nx, g.Ny, g.Nv) == (src.Nx, src.Ny, src.Nv)
        for f in ("x", "y", "n", "g0", "E0", "gv", "gv0"):
            np.testing.assert_array_equal(getattr(g, f),
                                          np.asarray(getattr(src, f))
                                          .reshape(-1))
    K = gains[1].Nv
    for x, y, a, b in rays:
        res = oracle.calc_ray((x, y, a, b), N, dz, gains, None, K, method)
        assert res.error == -1
    r = _replay(dump)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count(": error -1 (") == rays.shape[0]
    assert "NOTE" not in r.stdout


def test_replay_of_a_seeded_dump(tmp_path):
    """A seeded dump replays with Iv0 = 0: the tool prints the method-2
    note, and its exit code counts the rays whose -2 code came from the
    seed and does not reproduce."""
    p = synthetic_problem(seeded=True, refraction_free=True, nx=2, ny=2,
                          na=2, nb=2, nv=3)
    p.seed.f[4][1] = -0.5
    dump = tmp_path / "failed_seed.dat"
    with pytest.raises(RayTraceError):
        create_image(p, "cpu", failed_ray_path=str(dump))
    n = read_failures(str(dump))[0].shape[0]
    r = _replay(dump)
    assert n > 0 and r.returncode == n, r.stdout + r.stderr
    assert "NOTE: seeded dump replays with Iv0=0" in r.stdout
    assert f"{n} ray(s) did not reproduce a failure" in r.stdout


def test_fuzz_tool_imports_quietly_and_needs_a_card_unless_asked():
    """Importing the tool prints and runs nothing; its main raises with no
    card visible and ``RAYTRACE_FORCE_CPU`` unset (the sweep fixture above
    runs it with the variable set)."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import raytrace_tpu_torch.tools.fuzz_oracle as f; "
         "print(len(f.CURATED), callable(f.run_case), flush=True); "
         "f.main(['0'])"],
        capture_output=True, text=True, timeout=TIMEOUT, cwd=ROOT,
        env=_env())
    assert r.returncode != 0 and r.stdout == "12 True\n", r.stdout
    assert "no CUDA device is visible" in r.stderr, r.stderr


def test_chip_smoke_fuzz_cases_reach_every_kernel_variant():
    """``chip_smoke.py`` phase 9's cases: at least 40, and among them every
    B3 instantiation (seeded, N 3 or not, K even or odd) and both B2
    variants (K even or odd), with the envelope's edges and the shipped
    widths at 360 and 720 rays."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    cases = chip_smoke.fuzz_cases()
    # the curated cases, then the same random ones from seed 0
    assert len(cases) >= 40 and cases[:len(CASES)] == CASES
    b3, b2, rays = set(), set(), []
    for ci, kw in enumerate(cases):
        p = synthetic_problem(rng=ci, **kw)
        if p.seed is not None:
            b3.add(chip_smoke.b3_variant(p.N, p.euv_beam.nv))
        b2.add(chip_smoke.b2_variant(p.euv_beam.nv))
        src = p.seed_beam if p.seed is not None else p.euv_beam
        rays.append((p.N, p.euv_beam.nv, src.nx * src.ny * src.na * src.nb))
    assert b3 == {"<2,3,2>", "<2,3,1>", "<0,0,2>", "<0,0,1>"}
    assert b2 == {"<2>", "<1>"}
    assert {(20, 4), (20, 5), (3, 99)} <= {r[:2] for r in rays}
    assert (3, 52, 360) in rays and (3, 82, 720) in rays
