"""One short run of a one-card cell on the card, as the driver runs it:
``correct`` true and every end-to-end metric in the last line. Needs a
CUDA device; it decides inside the test."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import harness


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ase-small-sync", "seeded-small-stream"])
def test_short_run_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", name,
         "--seed", "2147483700", "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    cell = harness.load_cell(name)
    assert set(result["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    assert result["device"]["platform"] == "gpu"
