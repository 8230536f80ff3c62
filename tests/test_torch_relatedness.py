"""The port's relatedness and PCA (pgen_tpu_torch.ops.relatedness, ops.king,
ops.ibd, ops.pca, pipeline.king/genome/pca and their CLI) against
pgen_tpu's device provider.

The port runs with device="cpu", where K12's and K13's plain PyTorch
versions make the planes and the standardized dosages; pgen_tpu runs its
device functions with the Pallas unpack in interpret mode, JAX on the CPU
(tests/test_king.py:48, tests/test_genome.py:47, tests/test_pca.py:63).
Filesets have planted structure: two populations with shifted allele
frequencies, two close relative pairs and 5% missing calls, so the top
eigenvectors are well separated. Tolerances: the king and ibd counts and
their tables exact (byte for byte); the GRM sums at rtol/atol 2e-5 with
m_used exact (tests/test_pca.py:65: pgen_tpu's f32 device GRM against its
f64 host one; the port's GRM is f64); --approx eigenvalues at rtol 1e-3
(tests/test_pca.py:265); .eigenvec/.eigenval at atol 5e-5
(tests/test_pca.py:176). The .rel.bin matrices are held at the GRM's 2e-5
too, pgen_tpu's being an f32 sum; the port's text and binary matrices
agree at 1e-9, as pgen_tpu's own do (tests/test_pca.py:197). z is held to ``_standardize_block_jnp`` at rtol
1e-6: XLA's rsqrt on the CPU is 1 ulp off a correctly rounded 1/sqrt in
about a third of values.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import build_fileset
from pgen_tpu.cli import main as tpu_main
from pgen_tpu.formats.writer import write_pgen
from pgen_tpu.ops import ibd as tpu_ibd
from pgen_tpu.ops import king as tpu_king
from pgen_tpu.ops import pca as tpu_pca
from pgen_tpu.ops.unpack import unpack_codes as tpu_unpack_codes
from pgen_tpu.pipeline import king as tpu_king_pipeline
from pgen_tpu_torch.cli import main as port_main
from pgen_tpu_torch.ops import ibd as port_ibd
from pgen_tpu_torch.ops import king as port_king
from pgen_tpu_torch.ops import pca as port_pca
from pgen_tpu_torch.ops.pack import subset_repack_plain
from pgen_tpu_torch.ops.relatedness import plane_shape, relatedness_planes
from pgen_tpu_torch.pipeline import king as port_king_pipeline
from test_torch_standalone import ARGV_TABLE

# S % 4 = 1, 2, 3, 0 and 1 again, one of them below 8
WIDTHS = [5, 14, 15, 16, 37]
COHORTS = ["all", "gap_dup", "reversed"]


def _planted_codes(n_var, n_samples, seed):
    """(V, S) codes: two populations (even and odd samples) with allele
    frequencies shifted apart, sample 1 a near copy of sample 0 and sample 3
    sharing half its calls with sample 2, then 5% of calls missing."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.15, 0.85, n_var)
    shift = rng.uniform(-0.3, 0.3, n_var)
    p = np.clip(np.stack([base + shift, base - shift]), 0.02, 0.98)
    codes = rng.binomial(2, p[np.arange(n_samples) % 2].T).astype(np.uint8)
    if n_samples > 1:
        copy = rng.random(n_var) < 0.9
        codes[copy, 1] = codes[copy, 0]
    if n_samples > 3:
        half = rng.random(n_var) < 0.5
        codes[half, 3] = codes[half, 2]
    codes[rng.random(codes.shape) < 0.05] = 3
    return codes


def _fileset(tmp_path, n_var, n_samples, seed, name="rel"):
    codes = _planted_codes(n_var, n_samples, seed)
    pvar = [f"1\t{100 + 10 * i}\trs{i}\tA\tG\t.\tPASS\t." for i in range(n_var)]
    psam = [f"s{i}\t{'F' if i % 2 else 'M'}" for i in range(n_samples)]
    return build_fileset(tmp_path, name, codes, pvar, psam), codes


def _packed(codes, tmp_path):
    """The records of ``codes`` as written to a .pgen (pad slots zero),
    then 256 rows that each repeat one byte value (pad slots included)."""
    path = tmp_path / "pk.pgen"
    write_pgen(str(path), codes)
    rec = (codes.shape[1] + 3) // 4
    body = np.fromfile(path, dtype=np.uint8)[12:].reshape(codes.shape[0], rec)
    return np.concatenate([body, np.repeat(np.arange(256, dtype=np.uint8)[:, None], rec, 1)])


def _cohort(kind, n_samples):
    if kind == "all":
        return None
    if kind == "reversed":
        return np.arange(n_samples - 1, -1, -1, dtype=np.int32)
    ids = np.flatnonzero(np.arange(n_samples) % 3 != 1)  # a gap, then a duplicate
    return np.concatenate([ids, ids[:1]]).astype(np.int32)


@pytest.mark.parametrize("kind", COHORTS)
@pytest.mark.parametrize("n_samples", WIDTHS)
def test_king_and_ibd_counts_match_pgen_tpu_device(tmp_path, n_samples, kind):
    """Every Gram exactly pgen_tpu's, in ragged blocks (300 + 256 rows in
    blocks of 64 here, 128 there)."""
    packed = _packed(_planted_codes(300, n_samples, n_samples), tmp_path)
    idx = _cohort(kind, n_samples)
    got = port_king.king_counts_device(packed, n_samples, "cpu", block_variants=64,
                                       sample_idx=idx)
    want = tpu_king.king_counts_device(packed, n_samples, block_variants=128, interpret=True,
                                       sample_idx=idx)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    got = port_ibd.ibd_counts_device(packed, n_samples, "cpu", block_variants=64,
                                     sample_idx=idx)
    want = tpu_ibd.ibd_counts_device(packed, n_samples, block_variants=128, interpret=True,
                                     sample_idx=idx)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", COHORTS)
@pytest.mark.parametrize("n_samples", WIDTHS)
def test_grm_device_matches_pgen_tpu_device(tmp_path, n_samples, kind):
    packed = _packed(_planted_codes(300, n_samples, 50 + n_samples), tmp_path)
    idx = _cohort(kind, n_samples)
    got = port_pca.grm_device(packed, n_samples, "cpu", block_variants=100, sample_idx=idx)
    want = tpu_pca.grm_device(packed, n_samples, block_variants=64, interpret=True,
                              sample_idx=idx)
    assert got.m_used == want.m_used
    np.testing.assert_allclose(got.grm_sum, want.grm_sum, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n_samples", [16, 37])
def test_pca_approx_matches_pgen_tpu_device(tmp_path, n_samples):
    """The same seeded start subspace, the same iterations: eigenvalues at
    rtol 1e-3, leading eigenvectors aligned."""
    packed = _packed(_planted_codes(400, n_samples, 7), tmp_path)
    got = port_pca.pca_approx(packed, n_samples, 2, "cpu", block_variants=128, iters=8, seed=3)
    want = tpu_pca.pca_approx(packed, n_samples, 2, provider="device", block_variants=128,
                              iters=8, seed=3)
    assert got.m_used == want.m_used
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-3)
    for c in range(2):
        assert abs(float(got.eigenvectors[:, c] @ want.eigenvectors[:, c])) > 1 - 1e-4


def _approx_pass_pair(packed, n_samples, kind):
    """pgen_tpu's _approx_pass_jit (interpret mode) and the port's pass,
    block by block (a cohort re-packed by K5's plain version first, as the
    pass loop does), on the same records and q, from y = 0: (the port's y
    and used, pgen_tpu's, the re-packed records, n_kept, q)."""
    import jax.numpy as jnp

    idx = _cohort(kind, n_samples)
    n_kept = n_samples if idx is None else len(idx)
    q = np.random.default_rng(n_samples).standard_normal((n_kept, 6)).astype(np.float32)
    want_y, want_m = tpu_pca._approx_pass_jit(
        jnp.asarray(packed), jnp.asarray(q), None if idx is None else jnp.asarray(idx),
        n_samples, 128, True)
    records = torch.from_numpy(packed)
    if idx is not None:
        records = subset_repack_plain(records, torch.from_numpy(idx))
    y = torch.zeros((n_kept, 6), dtype=torch.float32)
    used = torch.zeros((), dtype=torch.int64)
    qt = torch.from_numpy(q)
    for lo in range(0, packed.shape[0], 128):
        port_pca.pca_approx_pass(records[lo : lo + 128], n_kept, qt, y, used)
    return (y, used), (torch.from_numpy(np.array(want_y)), int(want_m)), records, n_kept, qt


@pytest.mark.parametrize("kind", COHORTS)
@pytest.mark.parametrize("n_samples", WIDTHS)
def test_pca_approx_pass_plain_matches_approx_pass_jit(tmp_path, n_samples, kind):
    """K13's plain pass against pgen_tpu's _approx_pass_jit: the used count
    exact, y within approx_pass_tolerance with z_ulps = 1 (XLA's rsqrt on
    the CPU is 1 ulp off the port's correctly rounded 1/sqrt in a third of
    the rows)."""
    packed = _packed(_planted_codes(300, n_samples, n_samples + 2), tmp_path)
    (y, used), (want_y, want_m), records, n_kept, q = _approx_pass_pair(packed, n_samples, kind)
    assert int(used) == want_m > 0
    tol = port_pca.approx_pass_tolerance(records, n_kept, q, torch.zeros_like(y), z_ulps=1)
    assert bool(((y.double() - want_y.double()).abs() <= tol).all())


@pytest.mark.parametrize("fault", ["half the rows", "a block of rows", "y0 dropped",
                                   "a column shifted"])
def test_approx_pass_tolerance_fails_planted_faults(tmp_path, fault):
    """The tolerance is tight enough to see a wrong pass: against pgen_tpu's
    y, from a y0 at the scale of y, a pass that dropped half the rows, one
    128-row block, or y0, or shifted its columns by one, lies outside it;
    the right pass lies inside."""
    packed = _packed(_planted_codes(512, 37, 41), tmp_path)
    (y, _), (want_y, _), records, n_kept, q = _approx_pass_pair(packed, 37, "all")
    y0 = torch.from_numpy(np.random.default_rng(5).standard_normal(y.shape).astype(np.float32))
    y0 *= float(want_y.std())
    want = (y0.double() + want_y.double())
    tol = port_pca.approx_pass_tolerance(records, n_kept, q, y0, z_ulps=1)
    got = y0 + y
    assert bool(((got.double() - want).abs() <= tol).all())
    used = torch.zeros((), dtype=torch.int64)
    rows = {"half the rows": records[:256],
            "a block of rows": torch.cat([records[:128], records[256:]])}.get(fault)
    if rows is not None:
        got = y0.clone()
        port_pca.pca_approx_pass(rows, n_kept, q, got, used)
    elif fault == "y0 dropped":
        got = y.clone()
    else:
        got = got.roll(1, 1)
    assert bool(((got.double() - want).abs() > tol).any())


def _tpu_codes(packed, n_samples, idx):
    import jax.numpy as jnp

    codes = np.asarray(tpu_unpack_codes(jnp.asarray(packed), n_samples, interpret=True))
    return codes if idx is None else codes[:, idx]


@pytest.mark.parametrize("kind", COHORTS)
@pytest.mark.parametrize("n_samples", WIDTHS)
def test_relatedness_planes_plain_match_pgen_tpu_planes(tmp_path, n_samples, kind):
    """K12's plain planes, transposed, are pgen_tpu's bf16 indicator planes
    H, R, A, C of the cohort (king.py:163-166), and 0 past them."""
    packed = _packed(_planted_codes(41, n_samples, n_samples), tmp_path)
    idx = _cohort(kind, n_samples)
    codes = _tpu_codes(packed, n_samples, idx)
    sel = None if idx is None else torch.from_numpy(idx)
    planes = relatedness_planes(torch.from_numpy(packed), n_samples, sel).numpy()
    n_var, n_kept = codes.shape
    assert planes.shape == (4, *plane_shape(n_var, n_kept)) and planes.dtype == np.int8
    assert planes.shape[1] > 16 and planes.shape[1] % 8 == 0 and planes.shape[2] % 16 == 0
    for p, want in enumerate((codes == 1, codes == 0, codes == 2, codes != 3)):
        np.testing.assert_array_equal(planes[p, :n_kept, :n_var], want.T.astype(np.int8))
    assert not planes[:, n_kept:].any() and not planes[:, :, n_var:].any()


@pytest.mark.parametrize("kind", COHORTS)
@pytest.mark.parametrize("n_samples", WIDTHS)
def test_grm_z_plain_matches_standardize_block_jnp(tmp_path, n_samples, kind):
    """K13's plain z against pgen_tpu's _standardize_block_jnp on the same
    codes (the 256 byte-value rows hold monomorphic and all-missing rows);
    the used flags exact."""
    import jax.numpy as jnp

    packed = _packed(_planted_codes(41, n_samples, n_samples + 1), tmp_path)
    idx = _cohort(kind, n_samples)
    z_want, used_want = tpu_pca._standardize_block_jnp(
        jnp.asarray(_tpu_codes(packed, n_samples, idx)))
    sel = None if idx is None else torch.from_numpy(idx)
    z, used = port_pca.grm_z(torch.from_numpy(packed), n_samples, sel)
    assert z.dtype == torch.float32 and used.dtype == torch.int32
    np.testing.assert_array_equal(used.numpy(), np.asarray(used_want).astype(np.int32))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_want), rtol=1e-6, atol=0)


def test_copied_host_functions_match_pgen_tpu():
    """The copies of pgen_tpu's jax-free host functions give pgen_tpu's
    results: king_kinship, ibd_estimates, ibs_from_counts, pca_from_grm,
    king_cutoff_mask and the brute-force oracles."""
    rng = np.random.default_rng(3)
    codes = _planted_codes(60, 9, 3)
    for port_fn, tpu_fn in ((port_king.king_counts_reference, tpu_king.king_counts_reference),
                            (port_ibd.ibd_counts_reference, tpu_ibd.ibd_counts_reference)):
        for g, w in zip(port_fn(codes), tpu_fn(codes)):
            np.testing.assert_array_equal(g, w)
    counts = tpu_king.king_counts_reference(codes)
    for g, w in zip(port_king.king_kinship(port_king.KingCounts(*counts)),
                    tpu_king.king_kinship(counts)):
        np.testing.assert_array_equal(g, w)
    ibd = tpu_ibd.ibd_counts_reference(codes)
    af = np.concatenate([rng.uniform(0, 1, 59), [np.nan]])
    got = port_ibd.ibd_estimates(port_ibd.IbdCounts(*ibd), af)
    want = tpu_ibd.ibd_estimates(ibd, af)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    a = rng.normal(size=(9, 9))
    for g, w in zip(port_pca.pca_from_grm(a @ a.T, 7, 3), tpu_pca.pca_from_grm(a @ a.T, 7, 3)):
        np.testing.assert_array_equal(g, w)
    kin = rng.uniform(-0.2, 0.3, (30, 30))
    kin = (kin + kin.T) / 2
    kin[2, 5] = kin[5, 2] = np.nan
    for cutoff in (0.1, 0.2, 0.5):
        np.testing.assert_array_equal(port_king_pipeline.king_cutoff_mask(kin, cutoff),
                                      tpu_king_pipeline.king_cutoff_mask(kin, cutoff))


def test_device_calls_refuse_2_to_the_24_rows():
    """pgen_tpu's guard and message: one call stays below 2^24 rows."""
    big = np.lib.stride_tricks.as_strided(np.zeros(1, np.uint8), (1 << 24, 2), (0, 0))
    for fn in (port_king.king_counts_device, port_ibd.ibd_counts_device):
        with pytest.raises(ValueError, match="2\\^24"):
            fn(big, 5, "cpu")


# -- the CLI against pgen_tpu's ----------------------------------------------

def _run_both(tmp_path, argv, out_flag="-o"):
    """argv through pgen_tpu's CLI (--provider device) and the port's (on
    the CPU), each into its own output; returns the two output paths."""
    tpu_out, port_out = tmp_path / "tpu", tmp_path / "port"
    assert tpu_main([*argv, out_flag, str(tpu_out), "--provider", "device"]) == 0
    assert port_main([*argv, out_flag, str(port_out), "--device", "cpu"]) == 0
    return tpu_out, port_out


KING_CASES = {
    "table": [],
    "min_kinship": ["--min-kinship", "0.05"],
    "cutoff": ["--cutoff", "0.1"],
    "cohort": ["--samples", "s0,s1,s3,s4,s6,s8,s9,s10,s12"],
    "cohort_cutoff": ["--samples", "s0,s1,s2,s3,s5,s7,s11", "--cutoff", "0.05"],
    "region_exclude": ["-r", "1:500-2500", "--exclude-sam", 'IID == "s2"'],
    "maf": ["--include-var", "GT_MAF >= 0.2", "--block-variants", "32"],
}


@pytest.mark.parametrize("case", list(KING_CASES))
def test_cli_king_byte_equal_to_pgen_tpu(tmp_path, case):
    prefix, _ = _fileset(tmp_path, 250, 14, 1)
    argv = ["king", prefix, *KING_CASES[case]]
    tpu_out, port_out = _run_both(tmp_path, argv)
    if "--cutoff" in argv:
        for end in ("in", "out"):
            want = open(f"{tpu_out}.king.cutoff.{end}.id").read()
            assert open(f"{port_out}.king.cutoff.{end}.id").read() == want
        assert open(f"{tpu_out}.king.cutoff.out.id").read()  # samples dropped
    else:
        assert port_out.read_bytes() == tpu_out.read_bytes()


GENOME_CASES = {
    "table": [],
    "min_pi_hat": ["--min-pi-hat", "0.1"],
    "cohort": ["--samples", "s0,s1,s2,s3,s5,s8,s13"],
    "region_maf": ["-r", "1:300-2000", "--include-var", "GT_MAF >= 0.1"],
}


@pytest.mark.parametrize("case", list(GENOME_CASES))
def test_cli_genome_byte_equal_to_pgen_tpu(tmp_path, case):
    prefix, _ = _fileset(tmp_path, 250, 14, 2)
    tpu_out, port_out = _run_both(tmp_path, ["genome", prefix, *GENOME_CASES[case]])
    assert port_out.read_bytes() == tpu_out.read_bytes()
    if case == "min_pi_hat":  # the planted relatives pass the threshold
        assert len(port_out.read_text().splitlines()) >= 3


def _table(path):
    lines = open(path).read().splitlines()
    return lines[0], [ln.split("\t")[0] for ln in lines[1:]], np.array(
        [[float(x) for x in ln.split("\t")[1:]] for ln in lines[1:]])


PCA_CASES = {
    "exact": ["-k", "3"],
    "cohort": ["-k", "2", "--samples", "s0,s2,s3,s5,s6,s9,s11,s14"],
    "approx": ["-k", "2", "--approx", "--approx-iters", "12", "--seed", "5"],
}


@pytest.mark.parametrize("case", list(PCA_CASES))
def test_cli_pca_matches_pgen_tpu(tmp_path, case):
    prefix, _ = _fileset(tmp_path, 300, 16, 4)
    tpu_out, port_out = _run_both(tmp_path, ["pca", prefix, *PCA_CASES[case]])
    head, iids, vecs = _table(f"{port_out}.eigenvec")
    want_head, want_iids, want_vecs = _table(f"{tpu_out}.eigenvec")
    assert (head, iids) == (want_head, want_iids)
    np.testing.assert_allclose(vecs, want_vecs, atol=5e-5)
    vals = np.loadtxt(f"{port_out}.eigenval")
    np.testing.assert_allclose(vals, np.loadtxt(f"{tpu_out}.eigenval"), atol=5e-5)


def test_cli_make_rel_matches_pgen_tpu(tmp_path):
    prefix, _ = _fileset(tmp_path, 300, 15, 6)
    tpu_out, port_out = _run_both(tmp_path, ["pca", prefix, "-k", "0", "--make-rel"])
    assert open(f"{port_out}.rel.id").read() == open(f"{tpu_out}.rel.id").read()
    rel = np.fromfile(f"{port_out}.rel.bin", dtype="<f8").reshape(15, 15)
    np.testing.assert_allclose(rel, np.fromfile(f"{tpu_out}.rel.bin", dtype="<f8").reshape(15, 15),
                               rtol=2e-5, atol=2e-5)
    assert not os.path.exists(f"{port_out}.eigenvec")
    assert port_main(["pca", prefix, "-k", "2", "--make-rel", "text", "-o",
                      str(tmp_path / "text"), "--device", "cpu"]) == 0
    np.testing.assert_allclose(np.loadtxt(tmp_path / "text.rel", delimiter="\t"), rel,
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("argv", [["king", "-o", "-"], ["genome", "-o", "-"],
                                  ["pca", "-k", "0"], ["pca", "--approx", "--make-rel"],
                                  ["king", "--samples", "s3"]])
def test_cli_exits_and_reports_as_pgen_tpu(tmp_path, capsys, argv):
    """stdout tables, the stderr summary line and the ValueError exits equal
    pgen_tpu's."""
    prefix, _ = _fileset(tmp_path, 40, 9, 8)
    full = [argv[0], prefix, *argv[1:]]
    rc = port_main([*full, "--device", "cpu"])
    got = capsys.readouterr()
    assert tpu_main([*full, "--provider", "device"]) == rc
    want = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err)
    assert rc == (0 if argv[-1] == "-" else 1)


@pytest.mark.parametrize("command", ["king", "genome", "pca"])
def test_cli_refuses_host_providers_and_ranks(tmp_path, capsys, monkeypatch, command):
    """pgen_tpu's host providers are refused (exit 2). Under WORLD_SIZE > 1
    king, genome and pca are served (their mesh steps, ROADMAP §1 item 17;
    a WORLD_SIZE without RANK makes no group, so this process runs as the
    one rank, byte-equal to its run alone); tests/test_torch_mesh.py runs
    the ranks."""
    prefix, _ = _fileset(tmp_path, 20, 6, 9)
    for provider in ("native", "numpy"):
        with pytest.raises(SystemExit) as e:
            port_main([command, prefix, "--provider", provider, "--device", "cpu"])
        assert e.value.code == 2
        assert "(item 10, done)" in capsys.readouterr().err
    out = {"king": "", "genome": "", "pca": ".eigenvec"}[command]
    assert port_main([command, prefix, "--device", "cpu", "-o", str(tmp_path / "alone")]) == 0
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert port_main([command, prefix, "--device", "cpu", "-o", str(tmp_path / "ranks")]) == 0
    assert (Path(f"{tmp_path / 'ranks'}{out}").read_bytes()
            == Path(f"{tmp_path / 'alone'}{out}").read_bytes())


def test_cli_cuda_without_a_card_raises(tmp_path, monkeypatch, capsys):
    prefix, _ = _fileset(tmp_path, 20, 6, 9)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for command in ("king", "genome", "pca"):
        assert port_main([command, prefix, "-o", str(tmp_path / command)]) == 1
        err = capsys.readouterr().err
        assert err.startswith("pgen-tpu: error: ") and "is_available" in err
    assert not list(tmp_path.glob("king*")) and not list(tmp_path.glob("genome*"))


# ROADMAP §1 item 13's subcommands, served since it landed: each parses and
# runs through the port's CLI (tests/test_torch_host_subcommands.py holds
# their outputs against pgen_tpu's)
UNSERVED = {}
ITEM_13 = ("describe", "index", "view", "export", "split", "concat", "merge", "sort",
           "annotate", "isec", "diff", "roh")


# the first argument vector of each subcommand in the parser's table
FIRST_ARGV = {argv[0]: argv for argv in reversed(ARGV_TABLE)}


@pytest.mark.parametrize("command", ITEM_13)
def test_cli_serves_each_item_13_subcommand(tmp_path, capsys, command):
    """Each of item 13's subcommands is served: its first argument vector of
    the parser's table, pointed at a fileset, runs through the port's CLI
    with no refusal (exit 0, or pgen_tpu's own exit 1 for a missing input)."""
    prefix, _ = _fileset(tmp_path, 20, 6, 9)
    gz = tmp_path / "x.vcf.gz"
    assert port_main(["filter", prefix, "-o", str(gz), "--index", "--device", "cpu"]) == 0
    names = {"P": prefix, "a": prefix, "b": prefix, "x.vcf.gz": str(gz),
             "x.pgen": f"{prefix}.pgen"}
    argv = [names.get(a, str(tmp_path / a) if a in ("s", "c", "m", "i", "x") else a)
            for a in FIRST_ARGV[command]]
    if command == "annotate":
        argv += ["--fill-info", "AC", "-o", str(tmp_path / "an")]
    if command in ("diff", "export", "roh", "sort"):
        argv += ["-o", str(tmp_path / f"{command}.out")]
    if command in ("merge", "diff", "annotate", "export", "roh"):
        argv += ["--device", "cpu"]
    if command == "merge":  # one cohort (the same sample twice is refused)
        argv = ["merge", prefix, "-o", str(tmp_path / "m"), "--device", "cpu"]
    capsys.readouterr()
    assert port_main(argv) == 0, capsys.readouterr().err
    assert "ROADMAP" not in capsys.readouterr().err


def test_unserved_table_covers_every_subcommand_not_served():
    from pgen_tpu_torch.cli import SERVED

    assert set(UNSERVED) | set(SERVED) == set(FIRST_ARGV)
    assert not set(UNSERVED) & set(SERVED)
    assert set(ITEM_13) <= set(SERVED)
