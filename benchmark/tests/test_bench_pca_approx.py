"""The ``pca_approx`` job at ``conftest.TINY`` on the CPU: its plain
reference agrees with the program, its control (the passes in TF32) fails
the comparison, a fault planted under the timed path makes a run's
``correct`` false, and a traced run reports the two new metrics (the
roofline share only where a device trace has K13's kernels: never here)."""

import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.fileset import make_fileset
from benchmark.metrics import approx_orth_ms, approx_pass_roofline_pct
from benchmark.reference import pca_approx as ref
from benchmark.tests.conftest import SEED, tiny_cell

CELLS = ["ukb_488k.pca_approx"]


def one_job(cell_name: str, seed: int, tmp: Path, jobs: int = 2):
    cell = tiny_cell(cell_name)
    dev = torch.device("cpu")
    prefix = make_fileset(tmp / "fileset", cell.config["num_variants"],
                          cell.config["num_samples"], seed, dev)
    ctx = harness.Ctx(cell, seed, dev, 0, 1, prefix, tmp / "out")
    ctx.out_dir.mkdir()
    job = importlib.import_module("benchmark.jobs.pca_approx").Job(ctx)
    for i in range(jobs):
        job.run(i)
    return job, cell


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [SEED, 7])
def test_reference_agrees_with_the_job(cell, seed, tmp_path):
    job, c = one_job(cell, seed, tmp_path)
    checked, failed, numbers = job.check()
    assert checked == 2 and failed == 0
    assert all(numbers[k] <= v for k, v in c.traffic["limits"].items()), numbers


def test_control_fails_the_comparison(tmp_path):
    job, c = one_job(CELLS[0], SEED, tmp_path, jobs=1)
    checked, failed, numbers = job.check(control=True)
    assert failed == checked == 1
    assert any(numbers[k] > v for k, v in c.traffic["limits"].items()), numbers


def test_eigvec_err_counts_the_sign_and_not_the_lead_entry():
    ref_vecs = np.array([[0.6, -0.1], [-0.59999, 0.7], [0.1, 0.2]])
    assert ref.eigvec_err(ref_vecs, ref_vecs) == 0.0
    # a column negated reads 2
    assert ref.eigvec_err(ref_vecs * [1, -1], ref_vecs) == pytest.approx(2.0)
    # the program's lead entry the other of two near-equal ones of opposite
    # signs: its sign rule makes that one positive, and so does the check
    near = ref_vecs.copy()
    near[:, 0] = [-0.59999, 0.6, -0.1]
    assert ref.eigvec_err(near, ref_vecs) == pytest.approx(0.00001 / 0.6)


def test_tf32_rounding_keeps_ten_bits():
    x = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -3.0e-7],
                     dtype=torch.float32)
    got = ref.to_tf32(x)
    assert got[:2].tolist() == [1.0, 1.0 + 2.0**-10]
    # ties to even: 1 + 2^-11 down to 1, 1 + 3 2^-11 up to 1 + 2^-9
    assert got[2] == 1.0 and got[3] == 1.0 + 2.0**-9
    assert abs(float(got[4]) + 3.0e-7) <= 3.0e-7 * 2.0**-11


def _iters_less_one(inner):
    def pca_approx(*args, iters=10, **kw):
        return inner(*args, iters=iters - 1, **kw)
    return pca_approx


def _half_rows(inner):
    def make(packed, *args, **kw):
        return inner(packed[: len(packed) // 2], *args, **kw)
    return make


def _nine_digits(inner):
    def text(iids, vecs):
        fmt = "%s\t" + "\t".join(["%.9g"] * vecs.shape[1]) + "\n"
        return "".join(fmt % (iid, *row) for iid, row in zip(iids, vecs.tolist())).encode()
    return text


def _column_negated(inner):
    def pca_approx(*args, **kw):
        res = inner(*args, **kw)
        res.eigenvectors[:, -1] *= -1
        return res
    return pca_approx


def _unchanged(inner):
    def _pca(pfile_prefix, k, *args):
        from pgen_tpu_torch.pipeline.pca import PcaResult

        return PcaResult(0, 0, 0, np.zeros(k), np.zeros((1, k)), None, timer=args[-1].timer)
    return _pca


FAULTS = {
    "a pass skipped": ("pgen_tpu_torch.pipeline.pca", "pca_approx", _iters_less_one),
    "half the rows": ("pgen_tpu_torch.ops.pca", "_make_approx_pass", _half_rows),
    "nine digits written": ("pgen_tpu_torch.pipeline.pca", "eigenvec_text", _nine_digits),
    "a column negated": ("pgen_tpu_torch.pipeline.pca", "pca_approx", _column_negated),
    "unchanged": ("pgen_tpu_torch.pipeline.pca", "_pca", _unchanged),
}


@pytest.mark.parametrize("fault", ["none", *FAULTS])
def test_fault_makes_the_run_incorrect(fault, monkeypatch):
    if fault != "none":
        mod_name, attr, wrap = FAULTS[fault]
        mod = importlib.import_module(mod_name)
        monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    result = harness.run_cell(tiny_cell(CELLS[0]), SEED, 0.3, False, device_type="cpu")
    assert result["correct"] is (fault == "none"), result["checks"]
    assert result["attempted"] >= 1 and result["checked"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_traced_cpu_run_reports_the_new_metrics(cell):
    result = harness.run_cell(tiny_cell(cell), SEED, 0.3, True, device_type="cpu")
    assert result["correct"], result["checks"]
    # on the CPU the steps' device time is their host time
    assert result["metrics"]["approx_orth_ms"]["value"] > 0
    assert result["metrics"]["stage_input_ms"]["value"] > 0
    assert result["metrics"]["stage_emit_ms"]["value"] > 0
    # no card, so no K13 kernel in the trace
    assert "approx_pass_roofline_pct" not in result["metrics"]


def _run(stages, device_ops, least_s):
    cell = tiny_cell(CELLS[0])
    trace = {"window_s": 1.0, "busy_s": 0.5, "kernel_s": 0.5, "nccl_s": 0.0,
             "device_ops": device_ops, "idle_gaps": []}
    return harness.Run(cell, len(stages), 1.0, 1.0, stages, least_s,
                       [{"setup_peak_bytes": 0, "window_peak_bytes": 0, "trace": trace}])


def test_readers_on_a_hand_made_run():
    ops = [["_anonymous_namespace_::pca_zq_kernel", 0.5], ["Memcpy_HtoD", 2.0],
           ["_anonymous_namespace_::pca_zty_kernel", 0.4],
           ["_anonymous_namespace_::pca_sum_kernel", 0.1]]
    run = _run([{"orth": 0.5, "device:orth": 0.002, "device:rayleigh_ritz": 0.001,
                 "emit": 1.0}, {"orth": 0.5, "device:orth": 0.003}], ops, [0.1, 0.1])
    assert approx_orth_ms.read(run) == pytest.approx(1000.0 * 0.006 / 2)
    assert approx_pass_roofline_pct.read(run) == pytest.approx(100.0 * 0.2 / 1.0)
    # the parent program times neither step on the device; a kernel missing
    # from the list
    assert approx_orth_ms.read(_run([{"approx_pass": 1.0, "orth": 0.1}], ops, [0.1])) is None
    assert approx_pass_roofline_pct.read(_run([{}], ops[:2], [0.1])) is None
