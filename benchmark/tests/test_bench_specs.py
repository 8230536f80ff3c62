"""BENCHMARK.json and every file it names load, and keep to the rules the
harness relies on."""

import importlib
import json
import re

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = harness.load_cell(cell)
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert c.chips == w["chips"] == c.config["chips"]
    importlib.import_module(f"benchmark.jobs.{c.traffic['job']}").Job
    importlib.import_module(f"benchmark.reference.{c.traffic['job']}")
    importlib.import_module(f"benchmark.roofline.{c.traffic['job']}").least_seconds
    assert c.traffic["limits"]
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_loads_by_name(metric):
    assert callable(importlib.import_module(f"benchmark.metrics.{metric}").read)


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_matches_entry(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"] == []
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])


def test_names_units_and_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [c["name"] for c in SPEC["configs"]] + CELLS + METRICS
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_run_seconds_fit_a_full_check():
    s = SPEC["run_seconds"]
    assert 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200
