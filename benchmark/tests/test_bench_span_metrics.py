"""The readers of the program's spans: ``stage_host_ms`` and
``device_idle_unnamed_pct``, on hand-made runs, then a traced tiny CPU run
of each cell that reads them."""

import pytest

from benchmark import harness
from benchmark.metrics import device_idle_unnamed_pct, stage_host_ms
from benchmark.tests.conftest import SEED, tiny_cell
from benchmark.tests.test_bench_faults import cpu_run

CELLS = ["g1k_chr22.king_related", "g1k_chr22.pca_exact"]


def _run(stages=(), trace=None, jobs=None):
    stages = list(stages)
    return harness.Run(tiny_cell(CELLS[0]), len(stages) if jobs is None else jobs, 1.0, 1.0,
                       stages, [0.0] * len(stages), [{"setup_peak_bytes": 0,
                                                      "window_peak_bytes": 0, "trace": trace}])


def _trace(gaps, window_s=50.0, busy_s=2.0):
    return {"window_s": window_s, "busy_s": busy_s, "kernel_s": busy_s, "nccl_s": 0.0,
            "device_ops": [], "idle_gaps": [[k, v] for k, v in gaps]}


def test_stage_host_ms_sums_kinship_select_and_eigh_a_job():
    run = _run([{"kinship": 0.1, "king_select": 0.05, "king_emit": 9.0, "metadata_load": 3.0},
                {"kinship": 0.3, "king_select": 0.05}])
    assert stage_host_ms.read(run) == pytest.approx(1000.0 * 0.5 / 2)
    assert stage_host_ms.read(_run([{"eigh": 1.25}, {"eigh": 1.35}])) == pytest.approx(1300.0)


def test_stage_host_ms_is_none_without_its_stages():
    # the parent program names none of them: king's kinship ran outside any stage
    assert stage_host_ms.read(_run([{"king_grams": 0.2, "king_emit": 0.01}])) is None


def test_device_idle_unnamed_pct_is_the_job_gap_over_the_window():
    run = _run([{}], _trace([("king_grams", 19.06), ("job", 29.28)], window_s=51.5))
    assert device_idle_unnamed_pct.read(run) == pytest.approx(100.0 * 29.28 / 51.5)


def test_device_idle_unnamed_pct_reads_zero_when_no_gap_is_unnamed():
    gaps = [(f"stage{i}", 1.0 / (i + 1)) for i in range(9)]
    assert device_idle_unnamed_pct.read(_run([{}], _trace(gaps))) == 0.0


def test_device_idle_unnamed_pct_is_none_when_a_full_list_leaves_job_out():
    # ten labels: a small ``job`` gap may lie past the list's end
    gaps = [(f"stage{i}", 1.0 / (i + 1)) for i in range(10)]
    assert device_idle_unnamed_pct.read(_run([{}], _trace(gaps))) is None
    gaps[-1] = ("job", 0.05)
    assert device_idle_unnamed_pct.read(_run([{}], _trace(gaps))) == pytest.approx(0.1)


@pytest.mark.parametrize("trace", [None, _trace([("job", 1.0)], busy_s=0.0),
                                   _trace([("job", 1.0)], window_s=0.0)],
                         ids=["untraced", "card_never_busy", "empty_window"])
def test_device_idle_unnamed_pct_is_none_without_a_device_trace(trace):
    assert device_idle_unnamed_pct.read(_run([{}], trace)) is None


@pytest.mark.parametrize("cell", CELLS)
def test_traced_cpu_run_reports_stage_host_ms(cell):
    """A tiny traced run on the CPU: the program's new stages reach the
    reader (no card, so no device share)."""
    assert SEED > 2**31
    result = cpu_run(cell, "none", trace=True)
    assert result["correct"]
    assert result["metrics"]["stage_host_ms"]["value"] > 0
    assert "device_idle_unnamed_pct" not in result["metrics"]
