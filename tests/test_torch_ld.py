"""The port's LD family (pgen_tpu_torch.ops.ld, pipeline.ld_report, prune and
clump and their CLI) against pgen_tpu.

- ``ld_centered_plain`` (the plain definition of the mean and ||c||² that
  K15 builds on) against pgen_tpu's ``centered_dosage_np``: c at rtol/atol
  1e-6 (the port's mean is f32, as pgen_tpu's device mean is), ||c||² at
  rtol 1e-6, at S = 7, 5, 4 and 1, all samples and a cohort with a gap and a
  duplicate, with monomorphic and all-missing rows.
- K15's plain version (what a CPU tensor runs): its sums S_xx, S_xi, S_xj
  and N equal those of numpy int64 plane-pair counts exactly (also in
  chunks of rows capped below the band), and its band is within pgen_tpu's
  device tolerance of ``banded_r2_device(interpret=True)`` and
  ``banded_r2_numpy``, at S % 32 = 0, 1, 8 and 31, bands 1, 9, 49 and past
  the rows, with 0xFF, all-missing and monomorphic rows, and on cohorts
  re-packed by K5's plain version (unsorted and repeated ids).
- ``banded_r2(..., device="cpu")``, streamed in blocks of a few tiles,
  against pgen_tpu's ``banded_r2_device(interpret=True)`` (JAX on the CPU)
  and ``banded_r2_numpy`` (f64) at pgen_tpu's own device tolerance, rtol
  1e-4 atol 1e-6 (tests/test_ld.py:64), at every band edge: band 0, band
  past the rows, one variant, a window across a block boundary, pad rows
  under a cohort, V % band != 0, S % 4 != 0, monomorphic and all-missing
  rows.
- The CLI with ``--device cpu`` against ``pgen_tpu.cli.main``: the ``.ld``
  text, ``.prune.in``/``.prune.out`` and ``.clumps`` byte for byte against
  ``--provider numpy`` and ``--provider device`` (clump has one path), on
  pgen_tpu's own parity fixtures (tests/test_ld_report.py,
  tests/test_ld.py, tests/test_clump.py) and a cohort; the errors with the
  same exit code and text. Each fixture's r² keep clear of the thresholds
  the runs use, as asserted, so f32 sums in another order cannot move a
  pair across one.
- The copied functions are pgen_tpu's, source for source (imports aside).
"""

import contextlib
import inspect
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import build_fileset
from pgen_tpu.cli import main as tpu_main
from pgen_tpu.formats.writer import write_pgen
from pgen_tpu.ops import ld as tpu_ld
from pgen_tpu.ops.unpack_host import unpack_codes_numpy
from pgen_tpu.pipeline import clump as tpu_clump
from pgen_tpu.pipeline import ld_report as tpu_ld_report
from pgen_tpu.pipeline import prune as tpu_prune
from pgen_tpu_torch.cli import main as port_main
from pgen_tpu_torch.ops import ld as port_ld
from pgen_tpu_torch.ops.pack import subset_repack_plain
from pgen_tpu_torch.pipeline import clump as port_clump
from pgen_tpu_torch.pipeline import ld_report as port_ld_report
from pgen_tpu_torch.pipeline import prune as port_prune

RTOL, ATOL = 1e-4, 1e-6  # pgen_tpu's device r² against its numpy one


def _codes(n_var, n_samples, seed):
    """Random codes with planted LD (every 5th row copied onto the next,
    a few calls redrawn), a monomorphic row and an all-missing row."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n_var, n_samples), dtype=np.uint8)
    for v in range(0, n_var - 1, 5):
        codes[v + 1] = codes[v]
        codes[v + 1, rng.integers(0, n_samples)] = rng.integers(0, 4)
    codes[min(2, n_var - 1)] = 1
    codes[min(6, n_var - 1)] = 3
    return codes


def _pack(codes, tmp_path):
    path = str(tmp_path / "ld.pgen")
    write_pgen(path, codes)
    rec = (2 * codes.shape[1] + 7) // 8
    return np.fromfile(path, dtype=np.uint8)[12:].reshape(codes.shape[0], rec)


def _cohort(kind, n_samples):
    if kind == "all":
        return None
    ids = np.flatnonzero(np.arange(n_samples) % 3 != 1)  # a gap, then a duplicate
    return np.concatenate([ids, ids[:1]]).astype(np.int32)


@pytest.mark.parametrize("kind", ["all", "gap_dup"])
@pytest.mark.parametrize("n_samples", [7, 5, 4, 1])
def test_ld_centered_plain_matches_centered_dosage_np(tmp_path, n_samples, kind):
    codes = _codes(40, n_samples, n_samples)
    packed = torch.from_numpy(_pack(codes, tmp_path))
    idx = _cohort(kind, n_samples)
    sel = None if idx is None else torch.from_numpy(idx)
    c, norm2 = port_ld.ld_centered_plain(packed, n_samples, sel)
    assert c.dtype == torch.float32 and norm2.dtype == torch.float64
    want_c, want_norm = tpu_ld.centered_dosage_np(codes if idx is None else codes[:, idx])
    np.testing.assert_allclose(c.numpy(), want_c, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(norm2.numpy(), want_norm ** 2, rtol=1e-6)
    assert not c[6].any() and norm2[6] == 0  # all missing
    assert norm2[2] == 0  # monomorphic


# (variants, samples, band, block rows): band 0; band past the rows; one
# variant; windows across block boundaries (three or more blocks); V % band
# != 0 (the last block's pad rows); S % 4 != 0
BAND_CASES = [
    (10, 7, 0, 8),
    (5, 7, 9, 8),
    (1, 5, 1, 4),
    (64, 5, 4, 8),
    (64, 40, 7, 16),
    (37, 4, 6, 12),
    (30, 1, 3, 5),
]


@pytest.mark.parametrize("n_var,n_samples,band,block_rows", BAND_CASES)
def test_banded_r2_matches_pgen_tpu(tmp_path, n_var, n_samples, band, block_rows):
    packed = _pack(_codes(n_var, n_samples, n_var + band), tmp_path)
    for kind in ("all", "gap_dup"):
        idx = _cohort(kind, n_samples)
        got = port_ld.banded_r2(packed, n_samples, band, "cpu", sample_idx=idx,
                                block_rows=block_rows)
        assert got.shape == (n_var, band) and got.dtype == np.float64
        want = tpu_ld.banded_r2_numpy(packed, n_samples, band, sample_idx=idx)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        device = tpu_ld.banded_r2_device(packed, n_samples, band, sample_idx=idx,
                                         interpret=True)
        np.testing.assert_allclose(got, device, rtol=RTOL, atol=ATOL)
        past = np.arange(n_var)[:, None] + 1 + np.arange(band)[None, :] >= n_var
        assert not got[past].any()


def test_banded_r2_block_size_changes_nothing_but_order(tmp_path):
    """One block against blocks of five rows and of twenty: each pair's r²
    comes from its own integer counts, so the bands are equal bit for bit,
    the planted pairs near 1."""
    packed = _pack(_codes(64, 40, 3), tmp_path)
    whole = port_ld.banded_r2(packed, 40, 5, "cpu")
    for rows in (5, 20):
        np.testing.assert_array_equal(port_ld.banded_r2(packed, 40, 5, "cpu", block_rows=rows),
                                      whole)
    assert whole[0, 0] > 0.9 and whole[10, 0] > 0.9


# S % 32 = 0, 1, 8, 31 (a record word of 16 samples, a plane word of 32)
COUNT_WIDTHS = [64, 33, 40, 95]
COUNT_BANDS = [1, 9, 49, 70]  # 70: past the 60 rows


def _with_ff_rows(packed):
    """The records with two raw 0xFF rows (pad bits set too) after row 10."""
    ff = np.full((2, packed.shape[1]), 0xFF, dtype=np.uint8)
    return np.concatenate([packed[:11], ff, packed[11:]])


def _counts_numpy(codes, band):
    """(V, band, 9) int64 counts of H (code 1), A (code 2) and V (called)
    of row i against row i + 1 + d, in the order HH, HA, HV, AH, AA, AV, VH,
    VA, VV; 0 past the last row."""
    planes = np.stack([codes == 1, codes == 2, codes != 3]).astype(np.int64)
    n_var = codes.shape[0]
    out = np.zeros((n_var, band, 9), dtype=np.int64)
    for i in range(n_var):
        for d in range(band):
            j = i + 1 + d
            if j < n_var:
                out[i, d] = (planes[:, None, i] * planes[None, :, j]).sum(-1).reshape(9)
    return out


@pytest.mark.parametrize("band", COUNT_BANDS)
@pytest.mark.parametrize("n_samples", COUNT_WIDTHS)
def test_band_counts_plain_match_numpy(tmp_path, n_samples, band):
    """The plain version's sums S_xx, S_xi, S_xj and N are those of the nine
    plane-pair counts, in numpy int64."""
    packed = _with_ff_rows(_pack(_codes(58, n_samples, n_samples + band), tmp_path))
    codes = unpack_codes_numpy(packed, n_samples)
    got = port_ld.ld_band_sums_plain(torch.from_numpy(packed), n_samples, band)
    assert got.dtype == torch.int64 and got.shape == (60, band, 4)
    hh, ha, hv, ah, aa, av, vh, va, vv = np.moveaxis(_counts_numpy(codes, band), -1, 0)
    want = np.stack([hh + 2 * ha + 2 * ah + 4 * aa, hv + 2 * av, vh + 2 * va, vv], -1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("band", [255, 256, 257, 300])
def test_band_sums_plain_past_a_chunk_of_rows(tmp_path, band):
    """Bands at and past the plain version's largest chunk of rows (256),
    on 600 rows: the sums those of numpy int64 Grams of x = H + 2 A and V."""
    packed = _pack(_codes(600, 37, band), tmp_path)
    codes = unpack_codes_numpy(packed, 37).astype(np.int64)
    x, v = np.where(codes == 3, 0, codes), (codes != 3).astype(np.int64)
    grams = [a @ b.T for a, b in ((x, x), (x, v), (v, x), (v, v))]
    i = np.arange(600)[:, None]
    j = i + 1 + np.arange(band)[None, :]
    want = np.stack([np.where(j < 600, g[i, np.minimum(j, 599)], 0) for g in grams], -1)
    got = port_ld.ld_band_sums_plain(torch.from_numpy(packed), 37, band)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["all", "unsorted", "repeated"])
@pytest.mark.parametrize("band", COUNT_BANDS)
@pytest.mark.parametrize("n_samples", COUNT_WIDTHS)
def test_ld_r2_band_plain_matches_pgen_tpu(tmp_path, n_samples, band, kind):
    """K15's plain band on whole rows (a cohort re-packed first, as
    banded_r2 does) against pgen_tpu's device band and numpy band of the
    same samples; the 0xFF, all-missing and monomorphic rows 0."""
    packed = _with_ff_rows(_pack(_codes(58, n_samples, 2 * n_samples + band), tmp_path))
    rng = np.random.default_rng(band)
    idx = {"all": None, "unsorted": rng.permutation(n_samples)[: n_samples - 3],
           "repeated": rng.integers(0, n_samples, n_samples + 5)}[kind]
    records, n_kept = torch.from_numpy(packed), n_samples
    if idx is not None:
        idx = idx.astype(np.int32)
        records, n_kept = subset_repack_plain(records, torch.from_numpy(idx)), len(idx)
    got = port_ld.ld_r2_band_plain(records, n_kept, band).numpy()
    assert got.shape == (60, band)
    want = tpu_ld.banded_r2_numpy(packed, n_samples, band, sample_idx=idx)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    device = tpu_ld.banded_r2_device(packed, n_samples, band, sample_idx=idx, interpret=True)
    np.testing.assert_allclose(got, device, rtol=RTOL, atol=ATOL)
    # every pair with an all-missing row (6, and the 0xFF rows 11 and 12) or
    # the monomorphic row 2 is 0
    i = np.arange(60)[:, None]
    j = i + 1 + np.arange(band)[None, :]
    assert not got[np.isin(i, (2, 6, 11, 12)) | np.isin(j, (2, 6, 11, 12))].any()


# -- K15's kernel, mirrored with numpy ----------------------------------------
#
# ld_r2_band_kernel (pgen_tpu_torch/csrc/genotype.cu) runs only on the card;
# these tests follow its index arithmetic and its bit planes on the CPU, with
# its constants held to the source: change both together.

K15_SOURCE = Path(port_ld.__file__).resolve().parent.parent / "csrc" / "genotype.cu"
K15_ROWS, K15_CHUNK, K15_MAX_NT = 64, 128, 8


def test_k15_constants_match_the_source():
    source = K15_SOURCE.read_text()
    assert f"constexpr int kLdRows = {K15_ROWS};" in source
    assert f"constexpr int kLdChunk = {K15_CHUNK};" in source
    assert f"constexpr int kLdMaxNt = {K15_MAX_NT};" in source
    assert "return kLdRows + 48 + 8 * nt;" in source
    assert "return 8 * nt - 15;" in source
    assert "const int gap = d0 + 1 > kLdRows ? d0 + 1 - kLdRows : 0;" in source
    assert "switch ((15 + dt + 7) / 8) {" in source


@pytest.mark.parametrize("n_out,band", [(1, 1), (100, 1), (130, 9), (64, 49), (200, 50),
                                        (70, 420), (65, 8192)])
def test_k15_items_write_each_pair_once(n_out, band):
    """The kernel's items (64 rows by a tile of DT offsets) and each lane's
    fragment entries: every (i, d) of the band written once, its rows i and
    i + 1 + d at the staged rows it reads them from, inside the staging."""
    nt = (15 + min(band, 8 * K15_MAX_NT - 15) + 7) // 8
    dt = 8 * nt - 15
    n_dtiles = -(-band // dt)
    w, lane, n, e = np.meshgrid(np.arange(4), np.arange(32), np.arange(nt), np.arange(4),
                                indexing="ij")
    g, t = lane // 4, lane % 4
    r, col = g + 8 * (e >> 1), 8 * n + 2 * t + (e & 1)
    seen = np.zeros((n_out, band), dtype=np.int64)
    for item in range(-(-n_out // K15_ROWS) * n_dtiles):
        i0, d0 = (item // n_dtiles) * K15_ROWS, (item % n_dtiles) * dt
        gap = max(0, d0 + 1 - K15_ROWS)
        joff = 1 + d0 - gap
        n_staged = joff + 48 + 8 * nt
        dd = col - r
        i, d = i0 + 16 * w + r, d0 + dd
        keep = (dd >= 0) & (dd < dt) & (d < band) & (i < n_out)
        ki, kj = (16 * w + r)[keep], (joff + 16 * w + col)[keep]
        assert kj.max(initial=0) < n_staged and ki.max(initial=0) < K15_ROWS
        assert np.array_equal(i0 + kj + np.where(kj >= K15_ROWS, gap, 0), i[keep] + 1 + d[keep])
        np.add.at(seen, (i[keep], d[keep]), 1)
    assert (seen == 1).all()


def _k15_planes(packed, n_samples):
    """The kernel's planes of each row, (V, 3, words) u32 U1, U2, V: record
    words read in chunks of K15_CHUNK bytes, bytes past the used ones 0xFF
    and the pad slots of the last used byte 3, two record words a plane
    word."""
    used = (n_samples + 3) // 4
    width = -(-used // K15_CHUNK) * K15_CHUNK
    rows = np.full((packed.shape[0], width), 0xFF, dtype=np.uint8)
    rows[:, :used] = packed[:, :used]
    tail = n_samples - 4 * (used - 1)
    rows[:, used - 1] |= (0xFF << (2 * tail)) & 0xFF
    words = rows.view("<u4").reshape(packed.shape[0], -1, 2)
    lo, hi = words & 0x55555555, (words >> 1) & 0x55555555

    def plane(x):
        return (x[..., 0] | (x[..., 1] << 1)).astype(np.uint32)

    return np.stack([plane(lo ^ hi), plane(hi & ~lo), plane((lo & hi) ^ 0x55555555)], 1)


def _popc(x):
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1, dtype=np.int64)


@pytest.mark.parametrize("n_samples", [1, 2, 3, 4, 5, 31, 33, 40, 512, 513, 2503])
def test_k15_planes_count_as_the_plain_version(n_samples):
    """The kernel's planes of records with random pad bits (and 0xFF rows):
    each row's popcounts its called count, c1 + c2 and c2, and a pair's
    AND-POPC sums S_xx, S_xi, S_xj and N those of ld_band_sums_plain."""
    rng = np.random.default_rng(n_samples)
    packed = rng.integers(0, 256, (12, (n_samples + 3) // 4), dtype=np.uint8)
    packed[5] = 0xFF
    planes = _k15_planes(packed, n_samples)
    hist = port_ld.code_hist(port_ld.unpack_codes_plain(torch.from_numpy(packed),
                                                        n_samples).long()).numpy()
    np.testing.assert_array_equal(_popc(planes), np.stack(
        [hist[:, 1] + hist[:, 2], hist[:, 2], hist[:, :3].sum(1)], 1))
    sums = port_ld.ld_band_sums_plain(torch.from_numpy(packed), n_samples, 3).numpy()
    u1, u2, v = planes[:, 0], planes[:, 1], planes[:, 2]
    for i in range(12):
        for d in range(3):
            j = i + 1 + d
            if j >= 12:
                assert not sums[i, d].any()
                continue
            want = tuple(sums[i, d])
            got = (sum(_popc(a_ & b_).sum() for a_ in (u1[i], u2[i]) for b_ in (u1[j], u2[j])),
                   _popc(u1[i] & v[j]).sum() + _popc(u2[i] & v[j]).sum(),
                   _popc(v[i] & u1[j]).sum() + _popc(v[i] & u2[j]).sum(),
                   _popc(v[i] & v[j]).sum())
            assert got == want


# -- the CLI against pgen_tpu's ----------------------------------------------


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main([str(a) for a in argv])
    return rc, out.getvalue(), err.getvalue()


def _fileset(tmp_path, codes, chroms=None, pos=None, name="ld"):
    """tests/test_ld_report.py's fileset: rs{i} at POS 100 + 10 i on
    chromosome 1 unless given."""
    n_var, n_samples = codes.shape
    chroms = chroms or ["1"] * n_var
    pos = pos if pos is not None else [100 + 10 * i for i in range(n_var)]
    pvar = [f"{chroms[i]}\t{pos[i]}\trs{i}\tA\tG\t.\tPASS\t." for i in range(n_var)]
    psam = [f"s{i}\tM" for i in range(n_samples)]
    return build_fileset(tmp_path, name, codes, pvar, psam)


def _clear_of(codes, band, thresholds, sample_idx=None, margin=1e-4):
    """Every in-band f64 r² of ``codes`` lies at least ``margin`` from each
    threshold, so f32 sums in another order cannot move a pair across it."""
    c, norm = tpu_ld.centered_dosage_np(codes if sample_idx is None else codes[:, sample_idx])
    for i in range(codes.shape[0]):
        for j in range(i + 1, min(i + 1 + band, codes.shape[0])):
            den = norm[i] * norm[j]
            r2 = (c[i] @ c[j]) ** 2 / (den * den) if den > 0 else 0.0
            for t in thresholds:
                assert abs(r2 - t) >= margin, f"r2({i}, {j}) = {r2} is within {margin} of {t}"


def _same_outputs(tmp_path, command, prefix, argv, outputs):
    """The port's CLI on the CPU and pgen_tpu's under each provider: rc,
    stdout and every named output file byte for byte."""
    providers = ("numpy", "device")
    runs = {}
    for who in ("port", *providers):
        out = tmp_path / who
        args = [a.format(o=out) for a in argv]
        if who == "port":
            runs[who] = _run(port_main, [command, prefix, *args, "--device", "cpu"])
        else:
            runs[who] = _run(tpu_main, [command, prefix, *args, "--provider", who])
        runs[who] = (runs[who][0], runs[who][1],
                     [(tmp_path / f"{who}{ext}").read_bytes() for ext in outputs])
    for who in providers:
        assert runs["port"] == runs[who], who
    return runs["port"]


LD_CODES = {
    # tests/test_ld_report.py's fixtures
    "values": (np.random.default_rng(11).integers(0, 4, size=(12, 40), dtype=np.uint8), {}),
    "parity": (np.random.default_rng(9).integers(0, 4, size=(20, 16), dtype=np.uint8), {}),
    "isolation": (np.tile(np.array([[0, 1, 2, 0, 1, 2]], dtype=np.uint8), (4, 1)),
                  {"chroms": ["1", "1", "2", "2"], "pos": [100, 200, 100, 200]}),
    "kb": (np.array([[0, 1, 2, 0, 1, 2, 0, 1]] * 3, dtype=np.uint8),
           {"pos": [1000, 2000, 900_000]}),
    "absolute": (np.tile(np.array([[0, 1, 2, 0, 1, 2]], dtype=np.uint8), (2, 1)),
                 {"pos": [500_000, 100]}),
    "planted": (_codes(48, 24, 5), {"chroms": ["1"] * 30 + ["2"] * 18}),
}
LD_ARGV = {
    "values": ["--ld-window", "5", "--ld-window-r2", "0"],
    "parity": ["--ld-window", "6", "--ld-window-r2", "0.1"],
    "isolation": [],
    "kb": ["--ld-window-kb", "100"],
    "kb_r2": ["--ld-window-r2", "1.1"],
    "absolute": ["--ld-window-kb", "100", "--ld-window-r2", "0"],
    "planted": ["--ld-window", "4", "--ld-window-r2", "0.25"],
    "planted_cohort": ["--ld-window", "50", "--ld-window-r2", "0", "--samples",
                       "s3,s1,s7,s20,s11,s4,s9,s13,s22,s2,s17"],
    "planted_region": ["-r", "1:200-350", "--exclude-var", 'ID == "rs20"'],
}


# print every in-window pair (--ld-window-r2 0): many r² sit within f32
# rounding of a .6g edge, where pgen_tpu's own two providers differ in 4
# ("values") and 48 ("planted_cohort") of their rows; there the pairs and
# every other column are held exactly, R2 at pgen_tpu's device tolerance
EVERY_PAIR = ("values", "planted_cohort")


def _ld_rows(text: str) -> tuple:
    rows = [line.split("\t") for line in text.splitlines()]
    return [r[:6] for r in rows], np.array([float(r[6]) for r in rows[1:]])


def _same_ld(got: str, want: str) -> None:
    (got_pairs, got_r2), (want_pairs, want_r2) = _ld_rows(got), _ld_rows(want)
    assert got_pairs == want_pairs
    np.testing.assert_allclose(got_r2, want_r2, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", list(LD_ARGV))
def test_cli_ld_matches_pgen_tpu(tmp_path, case):
    codes, layout = LD_CODES[case.split("_")[0]]
    prefix = _fileset(tmp_path, codes, **layout)
    argv = LD_ARGV[case]
    if case not in EVERY_PAIR and "1.1" not in argv:
        window = int(argv[argv.index("--ld-window") + 1]) if "--ld-window" in argv else 10
        r2 = float(argv[argv.index("--ld-window-r2") + 1]) if "--ld-window-r2" in argv else 0.2
        _clear_of(codes, window - 1, [r2])
    texts = {}
    for who in ("port", "numpy", "device"):
        out = tmp_path / f"{who}.ld"
        run = ([port_main, "--device", "cpu"] if who == "port"
               else [tpu_main, "--provider", who])
        rc, stdout, _ = _run(run[0], ["ld", prefix, *argv, "-o", out, *run[1:]])
        assert rc == 0 and not stdout
        texts[who] = out.read_text()
    for who in ("numpy", "device"):
        if case in EVERY_PAIR:
            _same_ld(texts["port"], texts[who])
        else:
            assert texts["port"] == texts[who], who
    assert texts["port"].startswith("#CHR_A\tBP_A\tSNP_A\tCHR_B\tBP_B\tSNP_B\tR2\n")
    if case == "values":
        assert texts["port"].count("\n") == 1 + sum(min(5, 12 - i) - 1 for i in range(12))
    if case == "isolation":
        assert texts["port"].count("\n") == 3


def test_cli_ld_to_stdout_matches_pgen_tpu(tmp_path):
    codes, layout = LD_CODES["planted"]
    prefix = _fileset(tmp_path, codes, **layout)
    argv = ["ld", prefix, "--ld-window", "3", "--ld-window-r2", "0", "-o", "-"]
    rc, stdout, err = _run(port_main, [*argv, "--device", "cpu"])
    for provider in ("numpy", "device"):
        want = _run(tpu_main, [*argv, "--provider", provider])
        assert (rc, err) == (want[0], want[2])
        _same_ld(stdout, want[1])
    assert rc == 0 and stdout.count("\n") == 1 + 2 * 30 - 3 + 2 * 18 - 3  # two runs' pairs


PRUNE_SPECS = {
    "count": ["8", "3", "0.5"],
    "count_step1": ["6", "1", "0.3"],
    "kb": ["1kb", "1", "0.6"],
    "one": ["2", "1", "0.5"],  # band 1
    "cohort": ["10", "2", "0.45", "--samples", "s0,s2,s3,s5,s6,s8,s9,s11,s12,s14,s15"],
    "cohort_region": ["5", "5", "0.37", "--samples-file", "{d}/keep.txt", "-r", "1:150-400"],
}


@pytest.mark.parametrize("case", list(PRUNE_SPECS))
def test_cli_prune_matches_pgen_tpu(tmp_path, case):
    """tests/test_ld.py's provider-parity fixture (every 4th row copied),
    on two chromosomes, POS 10 bp apart."""
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=(48, 18), dtype=np.uint8)
    for v in range(0, 47, 4):
        codes[v + 1] = codes[v]
    codes[9] = 0  # monomorphic: never pruned
    prefix = _fileset(tmp_path, codes, chroms=["1"] * 30 + ["2"] * 18)
    (tmp_path / "keep.txt").write_text("s1\ns4\ns7\ns10\ns13\ns16\ns17\ns2\n")
    window, step, r2, *flags = PRUNE_SPECS[case]
    flags = [f.format(d=tmp_path) for f in flags]
    if case == "cohort":
        _clear_of(codes, 9, [0.45], np.array([0, 2, 3, 5, 6, 8, 9, 11, 12, 14, 15]))
    elif case == "cohort_region":  # every variant: the region's pairs among them
        _clear_of(codes, 4, [0.37], np.array([1, 4, 7, 10, 13, 16, 17, 2]))
    else:
        _clear_of(codes, 99 if case == "kb" else int(window) - 1, [float(r2)])
    rc, stdout, (kept, removed) = _same_outputs(
        tmp_path, "prune", prefix,
        ["--indep-pairwise", window, step, r2, *flags, "-o", "{o}"], [".prune.in", ".prune.out"])
    assert rc == 0 and not stdout
    assert removed and kept  # the planted copies lose one member


@pytest.mark.parametrize("spec,message", [
    (["1", "5", "0.2"], "count window must be >= 2"),
    (["50", "0", "0.2"], "window/step must be >= 1"),
    (["50", "5", "1.5"], "outside [0, 1]"),
    (["x", "5", "0.2"], "bad window"),
    (["9000", "1", "0.2"], "> 8192"),
    (["1kb", "1", "0.9"], "sort"),
])
def test_cli_prune_errors_match_pgen_tpu(tmp_path, spec, message):
    codes = np.random.default_rng(9).integers(0, 4, size=(9001, 3), dtype=np.uint8)
    pos = [100 + i for i in range(9001)]
    pos[0], pos[1] = pos[1], pos[0]  # unsorted: kb windows refuse
    prefix = _fileset(tmp_path, codes, pos=pos)
    argv = ["prune", prefix, "--indep-pairwise", *spec, "-o", tmp_path / "o"]
    got = _run(port_main, [*argv, "--device", "cpu"])
    assert got == _run(tpu_main, [*argv, "--provider", "numpy"])
    assert got[0] == 1 and message in got[2] and got[2].startswith("pgen-tpu: error: ")
    assert not list(tmp_path.glob("o.prune*"))


def _clump_fixture(tmp_path):
    """tests/test_clump.py's six variants, then 34 more of random codes with
    every 3rd row a near copy of the one before."""
    rng = np.random.default_rng(4)
    ns = 40
    g0 = rng.integers(0, 3, size=ns, dtype=np.uint8)
    g2 = rng.integers(0, 3, size=ns, dtype=np.uint8)
    extra = rng.integers(0, 4, size=(34, ns), dtype=np.uint8)
    for v in range(0, 33, 3):
        extra[v + 1] = extra[v]
        extra[v + 1, rng.integers(0, ns, 3)] = 3
    codes = np.vstack([np.stack([g0, g0, g2, g0, g0, 2 - g0]), extra])
    rows = ["1\t1000\tv0", "1\t2000\tv1", "1\t3000\tv2", "1\t900000\tv3", "2\t1500\tv4",
            "1\t2500\tv5"] + [f"3\t{5000 + 700 * i}\tx{i}" for i in range(34)]
    prefix = build_fileset(tmp_path, "cl", codes, [f"{r}\tA\tG\t.\t.\t." for r in rows],
                           [f"s{i}\tM" for i in range(ns)])
    ps = rng.uniform(0, 0.05, 34) ** 3
    report = ["#CHROM\tPOS\tID\tP", "1\t0\tv0\t1e-8", "1\t0\tv1\t0.002", "1\t0\tv2\t0.2",
              "1\t0\tv3\t0.03", "1\t0\tv4\t0.04", "1\t0\tv5\t0.3", "1\t0\tnope\t1e-9",
              "1\t0\tv2\tNA"] + [f"3\t0\tx{i}\t{p:.4g}" for i, p in enumerate(ps)]
    (tmp_path / "assoc.tsv").write_text("\n".join(report) + "\n")
    return prefix, codes


@pytest.mark.parametrize("flags", [
    [],
    ["--clump-r2", "0.3", "--clump-kb", "2", "--clump-p1", "1e-3"],
    ["--samples", "s0,s3,s5,s8,s13,s21,s34,s39,s1,s2,s4,s6,s9,s11,s15,s20,s25,s30"],
    ["--clump-p2", "0.5", "--exclude-var", 'ID == "x3"'],
])
def test_cli_clump_matches_pgen_tpu(tmp_path, flags):
    prefix, codes = _clump_fixture(tmp_path)
    r2 = float(flags[flags.index("--clump-r2") + 1]) if "--clump-r2" in flags else 0.5
    _clear_of(codes, 40, [r2])
    argv = ["clump", prefix, "--clump", tmp_path / "assoc.tsv", *flags]
    got = _run(port_main, [*argv, "-o", tmp_path / "port.clumps", "--device", "cpu"])
    want = _run(tpu_main, [*argv, "-o", tmp_path / "tpu.clumps"])
    assert got[:2] == want[:2] and got[0] == 0
    text = (tmp_path / "port.clumps").read_text()
    assert text == (tmp_path / "tpu.clumps").read_text() and text.count("\n") >= 3
    stdout = _run(port_main, [*argv, "-o", "-", "--device", "cpu"])
    assert stdout[0] == 0 and stdout[1] == text


# -- refusals -------------------------------------------------------------------


REFUSAL_ARGV = {
    "ld": ["--ld-window", "3"],
    "prune": ["--indep-pairwise", "4", "1", "0.5"],
    "clump": ["--clump", "{d}/assoc.tsv"],
}


@pytest.mark.parametrize("command", list(REFUSAL_ARGV))
def test_cli_refuses_host_providers(tmp_path, capsys, command):
    """--provider native|numpy is refused naming ROADMAP §1 item 10 (done);
    clump has no --provider flag, and argparse refuses it."""
    prefix, _ = _clump_fixture(tmp_path)
    argv = [command, prefix, *(a.format(d=tmp_path) for a in REFUSAL_ARGV[command]),
            "--provider", "numpy", "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        port_main(argv)
    err = capsys.readouterr().err
    assert e.value.code == 2
    if command == "clump":
        assert "unrecognized arguments: --provider numpy" in err
    else:
        assert "(item 10, done)" in err


@pytest.mark.parametrize("command", list(REFUSAL_ARGV))
def test_cli_refuses_ranks(tmp_path, capsys, monkeypatch, command):
    prefix, _ = _clump_fixture(tmp_path)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit) as e:
        port_main([command, prefix, *(a.format(d=tmp_path) for a in REFUSAL_ARGV[command]),
                   "--device", "cpu"])
    assert e.value.code == 2 and "ROADMAP §1 item 17" in capsys.readouterr().err


@pytest.mark.parametrize("command", list(REFUSAL_ARGV))
def test_cli_cuda_without_a_card_raises(tmp_path, monkeypatch, command):
    prefix, _ = _clump_fixture(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, stdout, err = _run(port_main, [command, prefix,
                                       *(a.format(d=tmp_path) for a in REFUSAL_ARGV[command]),
                                       "-o", tmp_path / "x"])
    assert rc == 1 and not stdout
    assert err.startswith("pgen-tpu: error: ") and "is_available" in err and err.count("\n") == 1
    assert not list(tmp_path.glob("x*"))


# -- the copies -------------------------------------------------------------------


COPIED = [
    (tpu_ld, port_ld, ["centered_dosage_np", "banded_r2_reference", "banded_r2_numpy",
                       "_take_band", "greedy_prune"]),
    (tpu_ld_report, port_ld_report, ["LdResult", "_chrom_runs"]),
    (tpu_prune, port_prune, ["PruneResult", "parse_window_spec", "_chrom_run_ends",
                             "window_extents"]),
    (tpu_clump, port_clump, ["ClumpResult", "_read_assoc"]),
]


@pytest.mark.parametrize("name", [f"{tpu.__name__.split('.')[-1]}.{n}"
                                  for tpu, _, names in COPIED for n in names])
def test_copied_verbatim(name):
    module, attr = name.split(".")
    tpu, port = next((t, p) for t, p, _ in COPIED if t.__name__.endswith(f".{module}"))
    want = inspect.getsource(getattr(tpu, attr))
    got = inspect.getsource(getattr(port, attr)).replace("pgen_tpu_torch.", "pgen_tpu.")
    assert got == want
    assert port_prune.MAX_BAND == tpu_prune.MAX_BAND
