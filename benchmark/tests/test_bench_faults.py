"""Whole CPU runs of each cell at a tiny size, past the harness's look for
a card: sound, they come out correct; with a fault planted under the timed
path, ``correct`` comes out false."""

import sys
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.tests.conftest import FOUR_RANKS, SEED, cell_named
from benchmark.tests.faults import FAULTS, plant, unplant

CHILD = Path(__file__).with_name("rank_child.py")
CASES = [(cell, fault)
         for cell, kind in (("g1k_chr22.device_keep2", "filter_vcf"),
                            ("g1k_chr22.king_related", "king"),
                            ("g1k_chr22.pca_exact", "pca"),
                            (FOUR_RANKS, "filter_vcf"))
         for fault in ["none", *FAULTS[kind]]
         if fault != "no_exchange" or "4gpu" in cell]


def cpu_run(cell_name: str, fault: str, trace: bool = False) -> dict:
    cell = cell_named(cell_name)
    kind = cell.traffic["job"]
    child = [sys.executable, str(CHILD), kind, fault, "--workload", cell_name,
             "--seed", str(SEED), "--seconds", "0.3", "--trace", str(int(trace))]
    undo = plant(kind, fault) if fault != "none" else []
    try:
        return harness.run_cell(cell, SEED, 0.3, trace, device_type="cpu", child_cmd=child)
    finally:
        unplant(undo)


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_makes_the_run_incorrect(cell, fault):
    result = cpu_run(cell, fault)
    assert result["correct"] is (fault == "none"), result["checks"]
    assert result["attempted"] >= 1 and result["checked"] >= 1
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", ["g1k_chr22.device_keep2", FOUR_RANKS])
def test_traced_run_reports_per_layer_metrics(cell):
    result = cpu_run(cell, "none", trace=True)
    assert result["correct"]
    assert {"stage_input_ms", "stage_emit_ms"} <= set(result["metrics"])
    assert result["device"]["window_s"] > 0 and "breakdown" in result
