"""The command without a card, and in a directory that holds only the
benchmark: it exits with another code than 0 and prints no result."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ARGS = ["--workload", "ase-small-sync", "--seed", "12", "--seconds", "1",
        "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": ""})


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the command would run")
    out = _run(harness.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
