"""What the benchmark loads: never jax, jaxlib, flax or pgen_tpu (whole
top-level names), and in the references nothing of pgen_tpu_torch; and a
run without a card exits non-zero with no result."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from benchmark.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "pgen_tpu"}


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)
                          + "\nimport sys, json; print(json.dumps(sorted({m.split('.')[0] "
                          "for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_cpu_run_loads_no_jax_nor_pgen_tpu():
    loaded = _modules_after("""
        import sys
        sys.argv = ["x"]
        from benchmark.tests.test_bench_faults import cpu_run
        from benchmark.reference import filter_vcf, king, pca
        assert cpu_run("g1k_chr22.pca_exact", "none")["correct"]
        assert cpu_run("g1k_chr22.king_related", "none", trace=True)["correct"]
    """)
    assert "pgen_tpu_torch" in loaded and not loaded & FORBIDDEN


def test_a_rank_that_loads_jax_gives_no_result():
    """Ranks 1..3 of a 4-rank CPU run each hold a module named jax once the
    window closes: rank 0 fails the run instead of returning a result."""
    from benchmark import harness
    from benchmark.tests.conftest import FOUR_RANKS as name
    from benchmark.tests.conftest import SEED, cell_named
    from benchmark.tests.test_bench_faults import CHILD

    child = [sys.executable, str(CHILD), "filter_vcf", "loads_jax", "--workload", name,
             "--seed", str(SEED), "--seconds", "0.3", "--trace", "0"]
    with pytest.raises(RuntimeError, match="rank 1 exited with 3"):
        harness.run_cell(cell_named(name), SEED, 0.3, False, device_type="cpu", child_cmd=child)


def test_the_references_load_nothing_of_the_program():
    loaded = _modules_after("""
        import tempfile, torch
        from pathlib import Path
        from benchmark.fileset import make_fileset
        from benchmark.reference import fileset, filter_vcf, king, pca
        p = make_fileset(Path(tempfile.mkdtemp()) / "f", 500, 12, 3, torch.device("cpu"), 1, 0.1)
        rec, s = fileset.read_records(p)
        filter_vcf.expected_vcf(rec, fileset.read_pvar(p), fileset.read_iids(p), b"G", [1, 5])
        king.kinship(king.counts(rec, s, "cpu"))
        pca.top_eigen(pca.grm(rec, s, "cpu"), 3)
    """)
    assert not loaded & (FORBIDDEN | {"pgen_tpu_torch"})


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark import harness

    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "pgen_tpu_torch_x.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "pgen_tpu", sys)
    assert harness.forbidden_modules() == ["jax", "pgen_tpu"]


def _run(cwd) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "g1k_chr22.king_related", "--seed", str(2**31 + 5), "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    r = _run(ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""
