"""``BENCHMARK.json`` against its contract, and every entry against the files
it names: each configuration, cell, traffic mix, entry driver and metric
reader is found by name."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from benchmark import harness

M = harness.manifest()
ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in M["workloads"]]
METRICS = M["end_to_end"] + M["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["benchmark"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert all(_line(w) for w in M["command"])
    assert len(json.dumps(M)) <= 64 * 1024


@pytest.mark.parametrize("config", M["configs"], ids=lambda c: c["name"])
def test_config_resolves(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(config["name"]) and _line(config["source"])
    assert _line(config["why"]) and config["file"].startswith("benchmark/")
    spec = json.loads((ROOT / config["file"]).read_text())
    assert spec["name"] == config["name"]
    assert spec["source"] == config["source"]
    assert spec["spectrum_dtype"] in ("float64", "float32")
    assert any(w["config"] == config["name"] for w in M["workloads"])


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_resolves(name):
    entry = {w["name"]: w for w in M["workloads"]}[name]
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(name) and NAME.match(entry["traffic"])
    assert entry["chips"] in (1, 4) and _line(entry["why"])
    cell = harness.load_cell(name)
    assert cell["why"] == entry["why"]
    importlib.import_module(
        f"benchmark.entries.{cell['traffic_spec']['entry']}")
    assert int(cell["check_calls"]) >= 1
    assert set(cell["limits"]) == {"image_rel_l2", "i_ang_rel_l2",
                                   "ref_failed_rays"}
    reported = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell["per_layer"]


def test_cells_unique_and_chips():
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs) == len(set(WORKLOADS))
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(WORKLOADS) // 4)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_resolves(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    reader = harness.load_reader(metric["name"])
    assert callable(reader.read)
    for w in metric.get("workloads", []):
        assert w in WORKLOADS
    if metric in M["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert _line(metric["layer"])
        assert metric["moves"] in {m["name"] for m in M["end_to_end"]}
        if metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%"


def test_metric_names_unique():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])


def test_files_named_from_names():
    for path in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
