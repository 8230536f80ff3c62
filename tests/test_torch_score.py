"""The port's polygenic scores (pgen_tpu_torch.ops.score, pipeline.score and
the score CLI) against pgen_tpu's device provider.

Records are random bytes made from a seed with numpy (pad slots random,
256 extra rows each repeating one byte value). The port runs with
device="cpu", where K11's plain PyTorch version makes the dosages; pgen_tpu
runs ``score_device`` with the Pallas unpack in interpret mode. Sums and
dosage sums at rtol/atol 2e-5 (pgen_tpu's tests/test_score.py:75, f32
products in another order), ALLELE_CT and the used-variant count exact;
K11's dosages bitwise against a numpy f32 recomputation.
"""

import numpy as np
import pytest
import torch

from conftest import build_fileset
from pgen_tpu.cli import main as tpu_main
from pgen_tpu.formats.writer import write_pgen_packed
from pgen_tpu.ops import score as tpu_score
from pgen_tpu.ops.unpack_host import unpack_codes_reference
from pgen_tpu.pipeline.score import score_pfile as tpu_score_pfile
from pgen_tpu_torch.cli import main as port_main
from pgen_tpu_torch.ops import score as port_score
from pgen_tpu_torch.pipeline.score import score_pfile as port_score_pfile

WIDTHS = [1, 5, 7, 23, 130]


def _packed(n_var, n_samples, seed):
    rec = (2 * n_samples + 7) // 8
    packed = np.random.default_rng(seed).integers(0, 256, (n_var + 256, rec), dtype=np.uint8)
    packed[n_var:] = np.arange(256, dtype=np.uint8)[:, None]
    return packed


def _cohort(n_samples):
    """Sample ids with a gap and a duplicate."""
    ids = np.flatnonzero(np.arange(n_samples) % 3 != 1)
    return np.concatenate([ids, ids[:1]]).astype(np.int32)


@pytest.mark.parametrize("mean_impute", [True, False])
@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("n_samples", WIDTHS)
def test_score_matches_pgen_tpu_device(n_samples, subset, mean_impute):
    packed = _packed(17, n_samples, n_samples)
    rng = np.random.default_rng(n_samples)
    weights = rng.normal(size=(packed.shape[0], 3))
    flip = rng.random(packed.shape[0]) < 0.5
    idx = _cohort(n_samples) if subset and n_samples > 1 else None
    got = port_score.score(packed, n_samples, weights, flip, "cpu", mean_impute=mean_impute,
                           block_variants=100, sample_idx=idx)
    want = tpu_score.score_device(packed, n_samples, weights, flip, mean_impute=mean_impute,
                                  block_variants=128, interpret=True, sample_idx=idx)
    np.testing.assert_allclose(got.sums, want.sums, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.dosage_sum, want.dosage_sum, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got.allele_ct, want.allele_ct)
    assert got.m_used == want.m_used
    assert got.sums.dtype == np.float64 and got.allele_ct.dtype == np.int64


def _tpu_dosages(packed, n_samples, flip, mean_impute, idx):
    """pgen_tpu's effect dosages (V, K) out of ``score_device`` (the Pallas
    unpack in interpret mode): with the (V, V) identity as weights each
    score sum is one dosage times 1, so the f32 product gives it exactly."""
    n_var = packed.shape[0]
    got = tpu_score.score_device(packed, n_samples, np.eye(n_var, dtype=np.float32),
                                 flip.astype(bool), mean_impute=mean_impute, block_variants=128,
                                 interpret=True, sample_idx=idx)
    return got.sums.T.astype(np.float32), got.m_used


# S % 4 = 0-3 at 1000 Genomes' width, and a cohort of 8,201 ids (past the
# kernel's 8,192-id column chunk) out of 12,301 samples
@pytest.mark.parametrize("n_samples", [1, 2, 3, 4, 5, 33, 2503, 2501, 2502, 2504, 12_301])
def test_score_dosage_plain_matches_numpy(n_samples):
    """K11's plain version: dosages 0/1/2 (2 - code flipped), a missing call
    0 or the row's f32 mean (sum / called, IEEE division), exact called
    counts; every byte value at every position (0xFF: no called sample),
    the pad slots never read; 265 rows (no multiple of a tile), flips
    random, none and all. With random flips also bitwise against pgen_tpu's
    score_device."""
    packed = _packed(9, n_samples, 60 + n_samples)
    codes = unpack_codes_reference(packed, n_samples).astype(np.int64)
    n_var = packed.shape[0]
    flips = {"random": np.random.default_rng(n_samples).integers(0, 2, n_var).astype(np.uint8),
             "none": np.zeros(n_var, np.uint8), "all": np.ones(n_var, np.uint8)}
    for idx in (None, _cohort(n_samples) if n_samples > 1 else np.zeros(3, np.int32)):
        c = codes if idx is None else codes[:, idx]
        called = c != 3
        n_called = called.sum(1)
        sel = None if idx is None else torch.from_numpy(idx)
        for kind, flip in flips.items():
            d = np.where(flip[:, None] == 1, 2 - c, c) * called
            mean = np.float32(d.sum(1)) / np.float32(np.maximum(n_called, 1))
            for mean_impute in (True, False):
                db, nc = port_score.score_dosage(torch.from_numpy(packed), n_samples,
                                                 torch.from_numpy(flip), mean_impute, sel)
                fill = np.where(n_called > 0, mean, 0) if mean_impute else np.zeros(len(c))
                want = np.where(called, d, fill[:, None]).astype(np.float32)
                np.testing.assert_array_equal(db.numpy(), want)
                np.testing.assert_array_equal(nc.numpy(), n_called)
                if kind == "random":
                    tpu_db, m_used = _tpu_dosages(packed, n_samples, flip, mean_impute, idx)
                    np.testing.assert_array_equal(db.numpy(), tpu_db)
                    assert m_used == int((nc > 0).sum())


def test_score_rejects_out_of_range_ids_and_bad_shapes():
    packed = _packed(3, 5, 1)
    weights, flip = np.ones((259, 1)), np.zeros(259, bool)
    for bad in ([0, 5], [-1, 2]):
        with pytest.raises(IndexError):
            port_score.score(packed, 5, weights, flip, "cpu", sample_idx=np.asarray(bad))
        with pytest.raises(IndexError):
            port_score.score_dosage(torch.from_numpy(packed), 5, torch.zeros(259, dtype=torch.uint8),
                                    True, torch.tensor(bad, dtype=torch.int32))
    with pytest.raises(ValueError):
        port_score.score(packed, 5, weights[:3], flip, "cpu")
    with pytest.raises(TypeError):
        port_score.score_dosage(torch.from_numpy(packed), 5, torch.zeros(259, dtype=torch.bool))
    empty = port_score.score(packed[:0], 5, weights[:0], flip[:0], "cpu")
    assert empty.m_used == 0 and empty.sums.shape == (5, 1)


# ---- score_pfile and the CLI against pgen_tpu's device provider ----


def _fileset(dirpath, n_var=45, n_samples=26, seed=21):
    rng = np.random.default_rng(seed)
    pvar = [f"1\t{100 + 5 * i}\trs{i}\tA\t{'GCT'[i % 3]}\t.\tPASS\t." for i in range(n_var)]
    psam = [f"s{i}\t{'MF'[i % 2]}" for i in range(n_samples)]
    prefix = build_fileset(dirpath, "sc", np.zeros((n_var, n_samples), np.uint8), pvar, psam)
    rec = (2 * n_samples + 7) // 8
    write_pgen_packed(f"{prefix}.pgen", rng.integers(0, 256, (n_var, rec), dtype=np.uint8),
                      n_samples)
    # every other variant scored, effect allele ALT or REF, one unmatched ID
    # and one allele mismatch; a header names the two scores
    lines = ["ID\tA1\tW1\tW2"]
    for i in range(0, n_var, 2):
        a1 = "A" if i % 4 == 0 else "GCT"[i % 3]
        lines.append(f"rs{i}\t{a1}\t{rng.normal():.5g}\t{rng.normal():.5g}")
    lines += ["rs999\tA\t1\t1", "rs1\tT\t1\t1"]
    (dirpath / "w.tsv").write_text("\n".join(lines) + "\n")
    (dirpath / "ranges.txt").write_text("low 0 0.3\nmid 0.3 0.7\nnone 5 6\n")
    (dirpath / "pvals.txt").write_text(
        "ID\tP\n" + "".join(f"rs{i}\t{rng.random():.4f}\n" for i in range(n_var)))
    return prefix


def _table(path):
    with open(path) as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    return rows[0], rows[1:]


def _assert_sscore_match(a, b):
    """Same header, IIDs and ALLELE_CT; DOSAGE_SUM, averages and sums within
    2e-5."""
    (ha, ra), (hb, rb) = _table(a), _table(b)
    assert ha == hb and len(ra) == len(rb) > 0
    lead = 1 if ha[0] == "#RANGE" else 0
    for x, y in zip(ra, rb):
        assert x[: lead + 2] == y[: lead + 2]
        np.testing.assert_allclose(np.float64(x[lead + 2 :]), np.float64(y[lead + 2 :]),
                                   rtol=2e-5, atol=2e-5)


CASES = {
    "default": {},
    "no_mean_imputation": dict(mean_impute=False),
    "center": dict(center=True),
    "variance_standardize_subset": dict(variance_standardize=True, sam_query='SEX == "F"'),
    "center_subset_variants": dict(center=True, sam_query='IID != "s4"', var_query='ALT != "C"'),
    "subset_blocks": dict(sam_query='IID != "s0" && IID != "s25"', block_variants=4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_score_pfile_matches_pgen_tpu_device(tmp_path, case):
    prefix = _fileset(tmp_path)
    kw = dict(weight_cols=(3, 4), write_sums=True, **CASES[case])
    want = tpu_score_pfile(prefix, str(tmp_path / "w.tsv"), out_file=str(tmp_path / "tpu"),
                           provider="device", **kw)
    got = port_score_pfile(prefix, str(tmp_path / "w.tsv"), out_file=str(tmp_path / "port"),
                           device="cpu", **kw)
    assert (got.num_scored, got.num_unmatched, got.num_mismatched, got.num_samples,
            got.names) == (want.num_scored, want.num_unmatched, want.num_mismatched,
                           want.num_samples, want.names)
    np.testing.assert_array_equal(got.allele_ct, want.allele_ct)
    _assert_sscore_match(tmp_path / "port", tmp_path / "tpu")


def test_q_score_range_matches_pgen_tpu_device(tmp_path, capsys):
    """One .sscore per matched range (the empty range skipped); streamed to
    stdout as one table with a leading RANGE column."""
    prefix = _fileset(tmp_path)
    q = (str(tmp_path / "ranges.txt"), str(tmp_path / "pvals.txt"))
    kw = dict(weight_cols=(3, 4), q_score_range=q, center=True)
    want = tpu_score_pfile(prefix, str(tmp_path / "w.tsv"), out_file=str(tmp_path / "tpu"),
                           provider="device", **kw)
    got = port_score_pfile(prefix, str(tmp_path / "w.tsv"), out_file=str(tmp_path / "port"),
                           device="cpu", **kw)
    assert got.out_path == want.out_path.replace("tpu", "port")
    for name in ("low", "mid"):
        _assert_sscore_match(tmp_path / f"port.{name}.sscore", tmp_path / f"tpu.{name}.sscore")
    assert not (tmp_path / "port.none.sscore").exists()
    argv = ["score", prefix, "--score", str(tmp_path / "w.tsv"), "--score-col-nums", "3-4",
            "--q-score-range", *q, "-o", "-"]
    assert port_main([*argv, "--device", "cpu"]) == 0
    (tmp_path / "port.txt").write_text(capsys.readouterr().out)
    assert tpu_main([*argv, "--provider", "device"]) == 0
    (tmp_path / "tpu.txt").write_text(capsys.readouterr().out)
    _assert_sscore_match(tmp_path / "port.txt", tmp_path / "tpu.txt")


@pytest.mark.parametrize(
    "argv",
    [
        ["--score-col-nums", "3-4", "--score-sums"],
        ["--score-col-nums", "4", "--no-mean-imputation", "--samples", "s1,s3,s7,s2"],
        ["--score-col-nums", "3,4", "--variance-standardize", "--keep", "{dir}/keep.txt"],
        ["--score-col-nums", "3", "-r", "1:150-300", "--exclude-sam", 'SEX == "M"'],
    ],
    ids=["sums", "no_mean_imputation_samples", "variance_standardize_keep", "region_exclude"],
)
def test_cli_score_matches_pgen_tpu(tmp_path, capsys, argv):
    prefix = _fileset(tmp_path)
    (tmp_path / "keep.txt").write_text("".join(f"s{i}\n" for i in range(1, 26, 2)))
    argv = [a.format(dir=tmp_path) for a in argv]
    a, b = tmp_path / "port.sscore", tmp_path / "tpu.sscore"
    assert port_main(["score", prefix, "--score", str(tmp_path / "w.tsv"), *argv,
                      "--device", "cpu", "-o", str(a)]) == 0
    port_err = capsys.readouterr().err
    assert tpu_main(["score", prefix, "--score", str(tmp_path / "w.tsv"), *argv,
                     "--provider", "device", "-o", str(b)]) == 0
    tpu_err = capsys.readouterr().err
    _assert_sscore_match(a, b)
    # the closing stderr line: counts, cohort, unmatched and mismatched lines
    closing = [ln for ln in port_err.splitlines() if ln.startswith("score: ")]
    assert closing == [ln.replace(str(b), str(a)) for ln in tpu_err.splitlines()
                       if ln.startswith("score: ")]
    assert len(closing) == 1 and "unmatched" in closing[0]


def test_cli_score_refuses_host_providers(tmp_path, capsys):
    prefix = _fileset(tmp_path)
    with pytest.raises(SystemExit) as e:
        port_main(["score", prefix, "--score", str(tmp_path / "w.tsv"), "--provider", "numpy",
                   "--device", "cpu", "-o", str(tmp_path / "x")])
    assert e.value.code == 2
    assert "ROADMAP" in capsys.readouterr().err
    assert not (tmp_path / "x").exists()
