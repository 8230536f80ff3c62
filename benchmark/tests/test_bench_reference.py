"""At a tiny fileset, each job kind's plain reference agrees with the
port's ``device="cpu"`` path, and its control (the reference in a lower
precision, or with a guarantee broken) fails the comparison."""

import tempfile
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.fileset import make_fileset
from benchmark.tests.conftest import SEED, cell_named

KINDS = {"filter_vcf": "g1k_chr22.device_keep2", "king": "g1k_chr22.king_related",
         "pca": "g1k_chr22.pca_exact"}


def one_job(kind: str, seed: int, tmp: Path):
    import importlib

    cell = cell_named(KINDS[kind])
    dev = torch.device("cpu")
    prefix = make_fileset(tmp / "fileset", cell.config["num_variants"],
                          cell.config["num_samples"], seed, dev,
                          cell.traffic.get("plant_pairs", 0), cell.traffic.get("plant_redraw", 0.0))
    ctx = harness.Ctx(cell, seed, dev, 0, 1, prefix, tmp / "out")
    ctx.out_dir.mkdir()
    job = importlib.import_module(f"benchmark.jobs.{kind}").Job(ctx)
    for i in range(2):
        job.run(i)
    return job, cell


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("seed", [SEED, 7])
def test_reference_agrees_with_the_port_on_cpu(kind, seed, tmp_path):
    job, cell = one_job(kind, seed, tmp_path)
    checked, failed, numbers = job.check()
    assert checked >= 1 and failed == 0
    assert all(numbers[k] <= v for k, v in cell.traffic["limits"].items()), numbers


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_control_fails_the_comparison(kind, tmp_path):
    job, cell = one_job(kind, SEED, tmp_path)
    checked, failed, numbers = job.check(control=True)
    assert failed == checked >= 1
    assert any(numbers[k] > v for k, v in cell.traffic["limits"].items()), numbers


def test_planted_pairs_are_the_table():
    with tempfile.TemporaryDirectory() as d:
        job, cell = one_job("king", SEED, Path(d))
        text = job.outputs[-1].read_text().splitlines()
    assert len(text) == 1 + cell.traffic["plant_pairs"]
