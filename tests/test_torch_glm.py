"""The port's GWAS (pgen_tpu_torch.ops.glm, ops.logistic, pipeline.glm and
the glm CLI) against pgen_tpu's device provider.

Records are random bytes made from a seed with numpy: pad slots hold random
codes, and 256 extra rows each repeat one byte value. The port runs with
device="cpu", where K10's plain PyTorch version makes the planes; pgen_tpu
runs its device provider (the Pallas unpack in interpret mode, JAX on the
CPU). Tolerances: moments at rtol/atol 2e-5 and counts exact (pgen_tpu's
tests/test_glm.py:90), the carried-over host solves at rtol 1e-12, end-to-end
linear cells at pgen_tpu's device-vs-numpy bounds (BETA/SE rtol 1e-3 atol
1e-5, T/P rtol 1e-2 atol 1e-3; tests/test_glm.py:94-95) and logistic at rtol
2e-3 atol 2e-5 (tests/test_glm_interaction.py:222-223): both sides are f32
products summed in another order.
"""

import numpy as np
import pytest
import torch

from conftest import build_fileset
from pgen_tpu.cli import main as tpu_main
from pgen_tpu.formats.writer import write_pgen_packed
from pgen_tpu.ops import glm as tpu_glm
from pgen_tpu.ops import logistic as tpu_logistic
from pgen_tpu.ops.unpack_host import unpack_codes_reference
from pgen_tpu.pipeline.glm import glm_pfile as tpu_glm_pfile
from pgen_tpu_torch import device as port_device
from pgen_tpu_torch.cli import main as port_main
from pgen_tpu_torch.ops import glm as port_glm
from pgen_tpu_torch.ops import logistic as port_logistic
from pgen_tpu_torch.pipeline.glm import glm_pfile as port_glm_pfile

WIDTHS = [5, 7, 23, 130]


def _packed(n_var, n_samples, seed):
    """Random records (pad slots random), then 256 rows that each repeat one
    byte value."""
    rec = (2 * n_samples + 7) // 8
    packed = np.random.default_rng(seed).integers(0, 256, (n_var + 256, rec), dtype=np.uint8)
    packed[n_var:] = np.arange(256, dtype=np.uint8)[:, None]
    return packed


def _cohort(n_samples, rng):
    """Sample ids with a gap (every third dropped) and a duplicate."""
    ids = np.flatnonzero(np.arange(n_samples) % 3 != 1)
    return np.concatenate([ids, ids[:1]]).astype(np.int32)


def _inputs(n_samples, seed, k=2, sample_idx=None):
    rng = np.random.default_rng(seed)
    n = n_samples if sample_idx is None else len(sample_idx)
    return rng.normal(size=n) * 2.0 + 1.0, rng.normal(size=(n, k)) + [3.0, -1.0][:k]


def _close(got, want, **tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **tol)


@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("n_samples", WIDTHS)
def test_moments_match_pgen_tpu_device(n_samples, subset):
    """X1, X2 and X3 through K10's plain version against pgen_tpu's device
    scans (Pallas interpret), in ragged blocks; n, sum g and sum g^2
    exact."""
    packed = _packed(11, n_samples, n_samples)
    idx = _cohort(n_samples, np.random.default_rng(1)) if subset else None
    y, covars = _inputs(n_samples, n_samples, sample_idx=idx)
    got = port_glm.glm_moments(packed, n_samples, y, covars, "cpu", block_variants=100,
                               sample_idx=idx)
    want = tpu_glm.glm_moments_device(packed, n_samples, y, covars, block_variants=128,
                                      interpret=True, sample_idx=idx)
    _close(got, want, rtol=2e-5, atol=2e-5)
    for name in ("n", "sg", "sg2"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    got = port_glm.glm_geno_moments(packed, n_samples, y, covars, "cpu", block_variants=100,
                                    sample_idx=idx)
    want = tpu_glm.glm_geno_moments(packed, n_samples, y, covars, provider="device",
                                    block_variants=128, sample_idx=idx)
    _close(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got.n, want.n)
    got = port_glm.glm_int_moments(packed, n_samples, y, covars, "cpu", block_variants=100,
                                   sample_idx=idx)
    want = tpu_glm.glm_int_moments(packed, n_samples, y, covars, provider="device",
                                   block_variants=128, sample_idx=idx)
    _close(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got.n, want.n)


@pytest.mark.parametrize("n_samples", [1, 2, 3, 4, 5, 33, 2503])
def test_glm_planes_plain_matches_numpy(n_samples):
    """K10's plain version at every LUT: planes[p] = lut[p][code] of the
    selected samples and exact code counts, every byte value at every
    position, the pad slots never read."""
    packed = _packed(9, n_samples, 40 + n_samples)
    codes = unpack_codes_reference(packed, n_samples).astype(np.int64)
    t = torch.from_numpy(packed)
    for idx in (None, _cohort(n_samples, None) if n_samples > 1 else np.zeros(2, np.int32)):
        sel = None if idx is None else torch.from_numpy(idx)
        c = codes if idx is None else codes[:, idx]
        for table in (port_glm.LUT_MOMENTS, port_glm.LUT_GENO, port_glm.LUT_INT):
            lut = torch.tensor(table, dtype=torch.float32)
            planes, hist = port_glm.glm_planes(t, n_samples, lut, sel)
            assert planes.shape == (len(table), packed.shape[0], c.shape[1])
            np.testing.assert_array_equal(planes.numpy(), np.asarray(table, np.float32)[:, c])
            np.testing.assert_array_equal(hist.numpy(), np.stack([(c == k).sum(1) for k in range(4)], 1))


def test_out_of_range_sample_ids_raise():
    """Ids must lie in [0, num_samples): 5 samples in 2-byte records leave
    pad slots 5-7, which are no valid id; negative ids never index from the
    end. The glm and logistic entry points check before any work."""
    packed = _packed(3, 5, 0)
    lut = torch.tensor(port_glm.LUT_MOMENTS, dtype=torch.float32)
    y, covars = _inputs(5, 0, k=1, sample_idx=[0, 1, 2, 5])
    for bad in ([0, 1, 2, 5], [0, 1, 2, -1]):
        with pytest.raises(IndexError):
            port_glm.glm_planes(torch.from_numpy(packed), 5, lut,
                                torch.tensor(bad, dtype=torch.int32))
        idx = np.asarray(bad, np.int32)
        for fn in (port_glm.glm_moments, port_glm.glm_geno_moments, port_glm.glm_int_moments,
                   port_logistic.glm_logistic, port_logistic.glm_logistic_interaction):
            with pytest.raises(IndexError):
                fn(packed, 5, (y > 1).astype(float), covars, "cpu", sample_idx=idx)
        with pytest.raises(IndexError):
            port_logistic.glm_logistic_modifier(packed, 5, (y > 1).astype(float), covars,
                                                "dominant", "cpu", sample_idx=idx)


def _moments_of_each_design(seed=3):
    packed = _packed(40, 57, seed)
    y, covars = _inputs(57, seed)
    return (
        port_glm.glm_moments(packed, 57, y, covars, "cpu"),
        port_glm.glm_geno_moments(packed, 57, y, covars, "cpu"),
        port_glm.glm_int_moments(packed, 57, y, covars, "cpu"),
        covars,
    )


def test_carried_over_solves_match_pgen_tpu():
    """glm_solve, glm_solve_modifier (every modifier) and
    glm_solve_interaction, copied from pgen_tpu, give pgen_tpu's answers on
    the same moments; so do the Student-t tail and its helpers."""
    m, gm, im, covars = _moments_of_each_design()
    _close(port_glm.glm_solve(m, 2), tpu_glm.glm_solve(m, 2), rtol=1e-12, equal_nan=True)
    for modifier in port_glm.MODIFIER_COLS:
        got = port_glm.glm_solve_modifier(gm, 2, modifier)
        want = tpu_glm.glm_solve_modifier(gm, 2, modifier)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_allclose(g, w, rtol=1e-12, equal_nan=True)
    means = covars.mean(axis=0)
    _close(port_glm.glm_solve_interaction(im, 2, covar_means=means),
           tpu_glm.glm_solve_interaction(im, 2, covar_means=means), rtol=1e-12, equal_nan=True)
    t = np.array([0.0, 0.3, -1.7, 2.5, 12.7, 80.0])
    df = np.array([1.0, 3.0, 10.0, 57.0, 1e3, 2e8])
    np.testing.assert_allclose(port_glm.t_sf2(t, df), tpu_glm.t_sf2(t, df), rtol=1e-12)
    np.testing.assert_allclose(port_glm._lgamma(df), tpu_glm._lgamma(df), rtol=1e-12)
    np.testing.assert_allclose(port_glm.betainc_reg(df / 2, 0.5, 0.3),
                               tpu_glm.betainc_reg(df / 2, 0.5, 0.3), rtol=1e-12)
    assert port_glm.MODIFIER_COLS == tpu_glm.MODIFIER_COLS
    assert port_glm.MODIFIER_TESTS == tpu_glm.MODIFIER_TESTS
    assert port_glm.JOINT_TEST_NAME == tpu_glm.JOINT_TEST_NAME
    y, covars = _inputs(57, 3)
    np.testing.assert_array_equal(port_glm._geno_moment_inputs(y, covars)[1],
                                  tpu_glm._geno_moment_inputs(y, covars)[1])


@pytest.mark.parametrize("design", ["linear", "genotypic", "dominant", "interaction"])
def test_linear_entry_points_match_pgen_tpu_device(design):
    """glm_linear, glm_linear_modifier and glm_linear_interaction (moments on
    the CPU, then the carried-over solves) against pgen_tpu's device
    provider, at its device-vs-numpy bounds."""
    packed = _packed(30, 41, 8)
    y, covars = _inputs(41, 8)
    if design == "linear":
        got = port_glm.glm_linear(packed, 41, y, covars, "cpu", block_variants=64)
        want = tpu_glm.glm_linear(packed, 41, y, covars, provider="device")
    elif design == "interaction":
        got = port_glm.glm_linear_interaction(packed, 41, y, covars, "cpu")
        want = tpu_glm.glm_linear_interaction(packed, 41, y, covars, provider="device")
    else:
        got = port_glm.glm_linear_modifier(packed, 41, y, covars, design, "cpu")
        want = tpu_glm.glm_linear_modifier(packed, 41, y, covars, design, provider="device")
    np.testing.assert_array_equal(got.n_obs, want.n_obs)
    np.testing.assert_array_equal(np.isnan(got.beta), np.isnan(want.beta))
    for name, tol in (("beta", dict(rtol=1e-3, atol=1e-5)), ("se", dict(rtol=1e-3, atol=1e-5)),
                      ("t_stat", dict(rtol=1e-2, atol=1e-3)), ("p", dict(rtol=1e-2, atol=1e-3))):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), equal_nan=True, **tol)


def test_interaction_beta_within_pgen_tpu_tolerance_with_a_covariate_near_50():
    """X3 over a few thousand variants with a covariate around 50, where the
    ADD term (reported at covariates 0) is a difference of terms 50 times
    its size: BETA alone stays inside pgen_tpu's interaction bound (rtol
    2e-4, atol 1e-6; tests/test_glm_interaction.py:101) against pgen_tpu's
    numpy provider (f64), SE too, over ragged blocks and a cohort with a
    gap. The port's X3 products run in f64."""
    rng = np.random.default_rng(50)
    n_var, n_samples = 3000, 301
    packed = _packed(n_var, n_samples, 50)[:n_var]
    idx = np.flatnonzero(rng.random(n_samples) > 0.02).astype(np.int32)
    c1, c2 = rng.normal(size=len(idx)), rng.normal(50.0, 8.0, size=len(idx))
    y = 0.3 * c1 + 0.02 * c2 + rng.normal(size=len(idx))
    covars = np.column_stack([c1, c2])
    got = port_glm.glm_linear_interaction(packed, n_samples, y, covars, "cpu",
                                          block_variants=1 << 11, sample_idx=idx)
    want = tpu_glm.glm_linear_interaction(packed, n_samples, y, covars, provider="numpy",
                                          sample_idx=idx)
    np.testing.assert_array_equal(got.n_obs, want.n_obs)
    assert np.isfinite(want.beta).all(axis=1).sum() > n_var // 2
    # some ADD betas lie far below their SE: the case the bound has to hold
    assert (np.abs(want.beta[:, 0]) < 0.01 * want.se[:, 0]).sum() >= 5
    np.testing.assert_allclose(got.beta, want.beta, rtol=2e-4, atol=1e-6, equal_nan=True)
    np.testing.assert_allclose(got.se, want.se, rtol=2e-4, atol=1e-6, equal_nan=True)


def test_interaction_products_run_in_f64(monkeypatch):
    """X3's three products are f64 (K x C f64 columns, the planes cast in
    row chunks through a bound scratch); X1's and X2's stay f32."""
    seen = []
    real = torch.matmul

    def spy(a, b, **kw):
        seen.append((a.dtype, b.dtype, a.shape[0]))
        return real(a, b, **kw)

    monkeypatch.setattr(torch, "matmul", spy)
    monkeypatch.setattr(port_glm, "F64_CHUNK_ROWS", 64)
    packed = _packed(100, 9, 2)[:100]
    y, covars = _inputs(9, 2)
    port_glm.glm_int_moments(packed, 9, y, covars, "cpu")
    assert {d for d, _, _ in seen} == {torch.float64} == {d for _, d, _ in seen}
    assert [rows for _, _, rows in seen] == [64, 36] * 3
    seen.clear()
    port_glm.glm_moments(packed, 9, y, covars, "cpu")
    port_glm.glm_geno_moments(packed, 9, y, covars, "cpu")
    assert {d for d, _, _ in seen} == {torch.float32}


@pytest.mark.parametrize("n_kept", [1, 2, 3, 5, 6, 7, 2453, 2454, 2455])
def test_glm_planes_selected_widths_match_pgen_tpu_legs(n_kept):
    """K10's plain version with ``sel`` at every K % 4, small and at the
    cohort's width, against pgen_tpu's reference decode legs: the unpack,
    the take of the cohort's columns and the f32 mask / dosage / dosage^2
    planes of its device scans (ops/glm.py:168-184, 1006-1022)."""
    n_samples = max(9, n_kept + 50)
    packed = _packed(7, n_samples, n_kept)
    rng = np.random.default_rng(n_kept)
    idx = rng.permutation(n_samples)[:n_kept].astype(np.int32)
    codes = np.take(unpack_codes_reference(packed, n_samples), idx, axis=1)
    mask = (codes != 3).astype(np.float32)
    g = np.where(codes != 3, codes, 0).astype(np.float32)
    for table, want in ((port_glm.LUT_MOMENTS, [mask, g]), (port_glm.LUT_INT, [mask, g, g * g])):
        lut = torch.tensor(table, dtype=torch.float32)
        planes, hist = port_glm.glm_planes(torch.from_numpy(packed), n_samples, lut,
                                           torch.from_numpy(idx))
        np.testing.assert_array_equal(planes.numpy(), np.stack(want))
        np.testing.assert_array_equal(hist.numpy(),
                                      np.stack([(codes == c).sum(1) for c in range(4)], 1))


def test_products_force_full_fp32(monkeypatch):
    """The port's products run with the float32 matmul precision at
    "highest" whatever the caller set (TF32 on cuBLAS, bf16 on oneDNN
    otherwise), and the caller's setting comes back afterwards."""
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append(torch.get_float32_matmul_precision())
        return real(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    prev = torch.get_float32_matmul_precision()
    packed = _packed(5, 9, 2)
    y, covars = _inputs(9, 2)
    try:
        for setting in ("high", "medium"):
            torch.set_float32_matmul_precision(setting)
            port_glm.glm_moments(packed, 9, y, covars, "cpu")
            port_logistic.device_matmul("cpu")(np.ones((2, 9)), covars)
            assert torch.get_float32_matmul_precision() == setting
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen and set(seen) == {"highest"}
    with port_device.full_fp32():
        assert torch.get_float32_matmul_precision() == "highest"


def test_logistic_matches_pgen_tpu_device():
    """The three logistic entry points with the port's products on the CPU
    against pgen_tpu's device provider (JAX products): same NA cells, and
    the fits at rtol 2e-3 / atol 2e-5."""
    rng = np.random.default_rng(5)
    n_samples = 150
    packed = _packed(12, n_samples, 5)[:12]
    covars = rng.normal(size=(n_samples, 2))
    y = (rng.random(n_samples) < 0.4).astype(float)
    pairs = [
        (port_logistic.glm_logistic(packed, n_samples, y, covars, "cpu"),
         tpu_logistic.glm_logistic(packed, n_samples, y, covars, provider="device")),
        (port_logistic.glm_logistic_modifier(packed, n_samples, y, covars, "genotypic", "cpu"),
         tpu_logistic.glm_logistic_modifier(packed, n_samples, y, covars, "genotypic",
                                            provider="device")),
        (port_logistic.glm_logistic_interaction(packed, n_samples, y, covars, "cpu"),
         tpu_logistic.glm_logistic_interaction(packed, n_samples, y, covars, provider="device")),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.n_obs, want.n_obs)
        np.testing.assert_array_equal(np.isnan(got.beta), np.isnan(want.beta))
        np.testing.assert_allclose(got.beta, want.beta, rtol=2e-3, atol=2e-5, equal_nan=True)
        np.testing.assert_allclose(got.se, want.se, rtol=2e-3, atol=2e-5, equal_nan=True)


# ---- glm_pfile and the CLI against pgen_tpu's device provider ----


def _fileset(dirpath, n_var=37, n_samples=61, seed=11):
    """Random records; psam with QT (2 NA), QT0, CC (1/2, 2 NA), CC0 (0/1/2:
    0 is missing) and two covariates C1, C2."""
    rng = np.random.default_rng(seed)
    pvar = [f"1\t{100 + 7 * i}\trs{i}\tA\t{'GCT'[i % 3]}\t.\tPASS\t." for i in range(n_var)]
    qt = rng.normal(size=n_samples)
    qt_cells = [f"{v:.6g}" for v in qt]
    for i in (3, 17):
        qt_cells[i] = "NA"
    cc = (rng.random(n_samples) < 0.45).astype(int) + 1
    cc_cells = [str(v) for v in cc]
    cc_cells[5] = cc_cells[40] = "NA"
    cc0 = [str(v) if i % 9 else "0" for i, v in enumerate(cc)]
    c1, c2 = rng.normal(size=n_samples), rng.normal(50.0, 8.0, size=n_samples)
    psam = [
        f"s{i}\t{'MF'[i % 2]}\t{qt_cells[i]}\t{rng.normal():.6g}\t{cc_cells[i]}\t{cc0[i]}\t"
        f"{c1[i]:.6g}\t{c2[i]:.6g}"
        for i in range(n_samples)
    ]
    prefix = build_fileset(dirpath, "gw", np.zeros((n_var, n_samples), np.uint8), pvar, psam,
                           psam_columns="#IID\tSEX\tQT\tQT0\tCC\tCC0\tC1\tC2")
    rec = (2 * n_samples + 7) // 8
    write_pgen_packed(f"{prefix}.pgen", rng.integers(0, 256, (n_var, rec), dtype=np.uint8),
                      n_samples)
    return prefix


def _rows(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


def _assert_tables_match(a, b, logistic=False):
    """Same header, prefix columns, TEST and OBS_CT and NA cells; numbers
    within the tolerances of the module docstring."""
    ra, rb = _rows(a), _rows(b)
    assert ra[0] == rb[0] and len(ra) == len(rb) > 1
    for x, y in zip(ra[1:], rb[1:]):
        assert x[:8] == y[:8]
        assert [c == "NA" for c in x] == [c == "NA" for c in y]
        for col, (u, w) in enumerate(zip(x[8:], y[8:])):
            if u == "NA":
                continue
            if logistic:
                tol = dict(rtol=2e-3, atol=2e-5)
            else:
                tol = dict(rtol=1e-3, atol=1e-5) if col < 2 else dict(rtol=1e-2, atol=1e-3)
            np.testing.assert_allclose(float(u), float(w), **tol)


CASES = {
    "linear": dict(pheno_name="QT", covar_names=["C1", "C2"]),
    "linear_no_covars_subset": dict(pheno_name="QT", sam_query='SEX == "F"'),
    "dominant": dict(pheno_name="QT", covar_names=["C1"], modifier="dominant"),
    "recessive": dict(pheno_name="QT", covar_names=["C1"], modifier="recessive"),
    "genotypic": dict(pheno_name="QT", covar_names=["C1", "C2"], modifier="genotypic"),
    "hethom": dict(pheno_name="QT0", covar_names=["C2"], modifier="hethom"),
    "interaction": dict(pheno_name="QT", covar_names=["C1", "C2"], interaction=True),
    "logistic": dict(pheno_name="CC", covar_names=["C1", "C2"]),
    "logistic_zero_missing": dict(pheno_name="CC0", covar_names=["C1"]),
    "logistic_genotypic": dict(pheno_name="CC", covar_names=["C1"], modifier="genotypic"),
    "logistic_interaction": dict(pheno_name="CC", covar_names=["C1"], interaction=True),
    "condition": dict(pheno_name="QT", covar_names=["C1"], condition=["rs4", "rs9"]),
    "covar_variance_standardize": dict(pheno_name="QT", covar_names=["C1", "C2"],
                                       covar_variance_standardize=True),
    "variants_and_blocks": dict(pheno_name="QT0", covar_names=["C1"], var_query='ALT != "C"',
                                block_variants=5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_glm_pfile_matches_pgen_tpu_device(tmp_path, case):
    prefix = _fileset(tmp_path)
    kw = CASES[case]
    want = tpu_glm_pfile(prefix, out_file=str(tmp_path / "tpu.glm"), provider="device", **kw)
    got = port_glm_pfile(prefix, out_file=str(tmp_path / "port.glm"), device="cpu", **kw)
    assert (got.model, got.num_variants, got.num_samples, got.num_dropped) == (
        want.model, want.num_variants, want.num_samples, want.num_dropped)
    np.testing.assert_array_equal(got.n_obs, want.n_obs)
    _assert_tables_match(tmp_path / "port.glm", tmp_path / "tpu.glm", got.model == "logistic")
    assert set(got.timer.report().split()) >= {"predicates:", "gather:", "emit:"}


def test_glm_adjust_matches_pgen_tpu_device(tmp_path):
    """--adjust: the same variants in the .adjusted table, each row's
    corrections within the linear P tolerance (ties may order apart)."""
    prefix = _fileset(tmp_path)
    kw = dict(pheno_name="QT", covar_names=["C1"], adjust=True)
    tpu_glm_pfile(prefix, out_file=str(tmp_path / "tpu.glm"), provider="device", **kw)
    port_glm_pfile(prefix, out_file=str(tmp_path / "port.glm"), device="cpu", **kw)
    a, b = _rows(tmp_path / "port.glm.adjusted"), _rows(tmp_path / "tpu.glm.adjusted")
    assert a[0] == b[0] and len(a) == len(b) > 1
    by_id = {r[2]: r for r in b[1:]}
    for r in a[1:]:
        w = by_id[r[2]]
        assert r[:6] == w[:6]
        np.testing.assert_allclose(np.float64(r[6:]), np.float64(w[6:]), rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize(
    "argv",
    [
        ["--pheno-name", "QT", "--covar-name", "C1,C2"],
        ["--pheno-name", "QT0", "--modifier", "hethom", "--samples", "s1,s2,s5,s8,s9,s10,s11"],
        ["--pheno-name", "QT", "--covar-name", "C1", "--interaction", "-r", "1:100-250"],
        ["--pheno-name", "CC", "--covar-name", "C1", "--exclude-var", 'ALT == "G"'],
        ["--pheno", "{dir}/ph.tsv", "--pheno-name", "P", "--covar", "{dir}/cv.tsv",
         "--covar-name", "K", "--keep", "{dir}/keep.txt"],
        ["--pheno-name", "QT", "--condition-list", "{dir}/cond.txt", "--remove", "{dir}/keep.txt"],
    ],
    ids=["linear", "hethom_samples", "interaction_region", "logistic_exclude",
         "external_tables_keep", "condition_list_remove"],
)
def test_cli_glm_matches_pgen_tpu(tmp_path, argv):
    prefix = _fileset(tmp_path)
    rng = np.random.default_rng(2)
    (tmp_path / "ph.tsv").write_text(
        "#IID\tP\n" + "".join(f"s{i}\t{rng.normal():.5g}\n" for i in range(0, 61, 2)))
    (tmp_path / "cv.tsv").write_text(
        "FID\tIID\tK\n" + "".join(f"f\ts{i}\t{rng.normal():.5g}\n" for i in range(61)))
    (tmp_path / "keep.txt").write_text("".join(f"s{i}\n" for i in range(0, 61, 3)))
    (tmp_path / "cond.txt").write_text("# conditioned\nrs3\nrs20\n")
    argv = [a.format(dir=tmp_path) for a in argv]
    a, b = tmp_path / "port.glm", tmp_path / "tpu.glm"
    assert port_main(["glm", prefix, *argv, "--device", "cpu", "-o", str(a)]) == 0
    assert tpu_main(["glm", prefix, *argv, "--provider", "device", "-o", str(b)]) == 0
    _assert_tables_match(a, b, logistic="CC" in argv)


def test_cli_glm_multi_pheno_and_stdout(tmp_path, capsys):
    """Two phenotypes write {base}.{pheno}.glm.{model} each; -o - streams
    one table; the closing stderr line names the design and the cohort."""
    prefix = _fileset(tmp_path)
    base = tmp_path / "multi"
    assert port_main(["glm", prefix, "--pheno-name", "QT,CC", "--covar-name", "C1",
                      "--device", "cpu", "-o", str(base)]) == 0
    assert tpu_main(["glm", prefix, "--pheno-name", "QT,CC", "--covar-name", "C1",
                     "--provider", "device", "-o", str(tmp_path / "want")]) == 0
    for pheno, model in (("QT", "linear"), ("CC", "logistic")):
        _assert_tables_match(f"{base}.{pheno}.glm.{model}",
                             tmp_path / f"want.{pheno}.glm.{model}", model == "logistic")
    err = capsys.readouterr().err
    assert "glm: linear QT ~ ADD + 1 covar(s) over 37 variants x 59 samples" in err
    assert port_main(["glm", prefix, "--pheno-name", "QT", "--modifier", "genotypic",
                      "--device", "cpu", "-o", "-"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].split("\t")[-2] == "T_OR_F_STAT" and len(out) == 1 + 3 * 37


@pytest.mark.parametrize(
    "argv",
    [
        ["--provider", "numpy"],
        ["--provider", "native"],
        ["--pheno-name", "QT,QT0", "-o", "-"],
    ],
)
def test_cli_glm_refusals(tmp_path, capsys, argv):
    prefix = _fileset(tmp_path, n_var=4)
    full = ["glm", prefix, "--pheno-name", "QT", *argv, "--device", "cpu"] + (
        [] if "-o" in argv else ["-o", str(tmp_path / "x.glm")])
    if "-o" in argv:
        # pgen_tpu's own refusal: its stderr line and exit code 2
        assert port_main(full) == 2
        err = capsys.readouterr().err
        assert tpu_main(["glm", prefix, "--pheno-name", "QT", *argv]) == 2
        assert capsys.readouterr().err == err and err.startswith("glm: error: ")
    else:
        with pytest.raises(SystemExit) as e:
            port_main(full)
        assert e.value.code == 2
    assert not list(tmp_path.glob("x.glm*"))


@pytest.mark.parametrize("command", ["glm", "score"])
def test_cli_analytics_refuse_several_ranks(tmp_path, capsys, monkeypatch, command):
    """Under WORLD_SIZE > 1 linear glm and score are served (their mesh
    steps, ROADMAP §1 item 17; a WORLD_SIZE without RANK makes no group, so
    this process runs as the one rank and writes what it writes alone);
    glm --interaction and --logistic, which pgen_tpu has no mesh step for,
    still refuse, naming the item. tests/test_torch_mesh.py runs the
    ranks."""
    prefix = _fileset(tmp_path, n_var=4)
    (tmp_path / "w.tsv").write_text("rs1\tC\t0.5\nrs2\tA\t-0.25\n")
    extra = ["--pheno-name", "QT"] if command == "glm" else ["--score", str(tmp_path / "w.tsv")]
    argv = [command, prefix, *extra, "--device", "cpu"]
    assert port_main([*argv, "-o", str(tmp_path / "alone")]) == 0
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert port_main([*argv, "-o", str(tmp_path / "x")]) == 0
    assert (tmp_path / "x").read_bytes() == (tmp_path / "alone").read_bytes()
    capsys.readouterr()
    if command == "glm":
        for flags in (["--interaction", "--covar-name", "C1"], ["--logistic"]):
            with pytest.raises(SystemExit) as e:
                port_main([*argv, *flags, "-o", str(tmp_path / "y")])
            assert e.value.code == 2
            err = capsys.readouterr().err
            assert "no mesh step" in err and "ROADMAP §1 item 17" in err
        assert not list(tmp_path.glob("y*"))


def test_glm_cuda_without_a_card_raises(tmp_path, monkeypatch, capsys):
    prefix = _fileset(tmp_path, n_var=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_main(["glm", prefix, "--pheno-name", "QT", "-o", str(tmp_path / "x.glm")]) == 1
    err = capsys.readouterr().err
    assert err.startswith("pgen-tpu: error: ") and "is_available" in err and err.count("\n") == 1
    assert not (tmp_path / "x.glm").exists()
