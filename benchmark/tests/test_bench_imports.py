"""What a run and the reference load: no module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or ``raytrace_tpu`` (names compared whole:
the port ``raytrace_tpu_torch`` is allowed to a run), nor the root
``bench.py``, ``tools/`` or the port's own ``tools``; and the reference
nothing of the program at all. Each in a fresh interpreter."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from benchmark import harness

ALL = "sorted(sys.modules)"


def _loaded(code: str) -> set:
    """Every module's full name after ``code`` runs in a fresh
    interpreter."""
    out = subprocess.run(
        [sys.executable, "-c", f"import sys\n{code}\nprint(repr({ALL}))"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(harness.ROOT)})
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def _modules(code: str) -> set:
    """The top-level names of :func:`_loaded`."""
    return {m.split(".")[0] for m in _loaded(code)}


def test_harness_and_readers_load_no_jax():
    names = [m["name"] for m in json.loads(
        (harness.ROOT / "BENCHMARK.json").read_text())["end_to_end"]]
    names += [m["name"] for m in harness.manifest()["per_layer"]]
    mods = _modules(
        "import benchmark.run, benchmark.control, benchmark.harness\n"
        "import benchmark.entries.sync, benchmark.entries.stream\n"
        "import benchmark.entries.sharded, benchmark.reference.plain\n"
        "from benchmark import harness\n"
        f"[harness.load_reader(n) for n in {names!r}]")
    assert not mods & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    mods = _modules("import benchmark.reference.plain, benchmark.units")
    assert not mods & (set(harness.FORBIDDEN) | {"raytrace_tpu_torch"})


def test_a_run_loads_no_jax():
    code = (
        "from benchmark.tests.conftest import tiny_cell\n"
        "from benchmark import harness\n"
        "out = harness.run_cell(tiny_cell('ase-small-sync'), 5, 0.3, True,"
        " 'cpu')\n"
        "assert out['correct'], out\n")
    loaded = _loaded(code)
    mods = {m.split(".")[0] for m in loaded}
    assert "raytrace_tpu_torch" in mods
    assert not mods & (set(harness.FORBIDDEN) | {"bench", "tools"})
    assert not [m for m in loaded if m.startswith("raytrace_tpu_torch.tools")]
