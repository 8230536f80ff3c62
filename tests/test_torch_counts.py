"""The port's count family against pgen_tpu: K14's plain version, ``query``,
the reports (``freq``, ``gcount``, ``missing``, ``hardy``, ``het``), ``stats``
and ``fst``.

- K14 ``gt_counts_masked``: its plain version (what a CPU tensor runs) and
  the streaming ``gt_counts_subsets`` are held with exact equality against
  pgen_tpu's ``gt_counts_subset`` with the native and the numpy provider,
  for 1-8 sample sets: empty, one sample, all, duplicated, unsorted and
  with gaps, and P = 26 (a partition) and 33 (two launches). Its operand,
  each mask's E words (``mask_words``), and its kept counts
  (``kept_counts``) are held against the ids, and its indexing is emulated
  with numpy (``_emulate_k14``): rows 0-15 B past a 16-B boundary staged as
  the aligned 16-B words that hold them (whole rows as one span, rows in
  chunks each in a slot of its own), read at their byte offsets by funnel
  shifts against one copy of each mask's E words, in the tensor-core
  products (their columns and the lanes that read them), at one mask and
  at 26.
- The CLI with ``--device cpu`` against ``pgen_tpu.cli.main``: query's
  stdout (and rc and stderr on its errors) byte for byte; each report's
  files and stats' stdout byte for byte against ``--provider numpy`` and
  ``--provider device`` (JAX on the CPU); fst's summary and per-variant
  tables the same way.

Filesets are the port's synthetic chr22-shaped ones (``formats/fixtures.py``:
realistic genotype frequencies, random codes in the pad slots) at S = 1,
5, 2503 and 2504 samples and 48 variants.
"""

import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from pgen_tpu.cli import main as tpu_main
from pgen_tpu.ops.gt_stats import gt_counts_subset as tpu_gt_counts_subset
from pgen_tpu_torch.cli import main as port_main
from pgen_tpu_torch.formats.fixtures import ensure_chr22
from pgen_tpu_torch.ops import gt_stats
from pgen_tpu_torch.ops.gt_stats import (
    MAX_MASKS,
    gt_counts_masked,
    gt_counts_masked_plain,
    gt_counts_subset,
    gt_counts_subsets,
    kept_counts,
    mask_words,
)
from pgen_tpu_torch.ops.gt_stats_host import sample_byte_masks

WIDTHS = [1, 5, 2503, 2504]
N_VAR = 48
SET_KINDS = ["empty", "single", "all", "duplicated", "unsorted", "gaps", "reversed", "last"]


def _records(n_samples, seed, n_var=300):
    """Random records (random codes in the pad slots), then 256 rows that
    each repeat one byte value."""
    rec = (n_samples + 3) // 4
    packed = np.random.default_rng(seed).integers(0, 256, (n_var + 256, rec), dtype=np.uint8)
    packed[n_var:] = np.arange(256, dtype=np.uint8)[:, None]
    return packed


def _sample_set(kind, n_samples, rng):
    everyone = np.arange(n_samples)
    ids = {
        "empty": everyone[:0],
        "single": everyone[n_samples // 2 : n_samples // 2 + 1],
        "all": everyone,
        "duplicated": np.concatenate([everyone[::3], everyone[:2]]),
        "unsorted": rng.permutation(n_samples)[: max(1, n_samples // 2)],
        "gaps": everyone[everyone % 4 != 1],
        "reversed": everyone[::-1],
        "last": everyone[-1:],
    }[kind]
    return ids.astype(np.int32)


def _partition(n_samples, n_sets, rng):
    """A seeded partition of the samples into n_sets labels (some empty at
    small widths), as fst's populations are."""
    labels = rng.integers(0, n_sets, n_samples)
    return [np.flatnonzero(labels == p).astype(np.int32) for p in range(n_sets)]


@pytest.mark.parametrize("n_sets", [*range(1, 9), 26, 33])
@pytest.mark.parametrize("n_samples", WIDTHS)
def test_masked_counts_match_pgen_tpu(n_samples, n_sets):
    """1-8 sets of every kind, a partition into 26 labels (fst over 1000
    Genomes' populations) and 33 sets (past MAX_MASKS: two launches a
    block on a card)."""
    packed = _records(n_samples, seed=n_samples + n_sets)
    rng = np.random.default_rng(n_sets)
    if n_sets == 26:
        sets = _partition(n_samples, n_sets, rng)
    else:
        sets = [_sample_set(SET_KINDS[(k + n_sets) % 8], n_samples, rng) for k in range(n_sets)]
    masks = torch.from_numpy(np.stack([sample_byte_masks(ids, packed.shape[1]) for ids in sets]))
    got = gt_counts_masked(torch.from_numpy(packed), masks)
    assert got.dtype == torch.int32 and got.shape == (packed.shape[0], n_sets, 4)
    assert torch.equal(got, gt_counts_masked_plain(torch.from_numpy(packed), masks))
    streamed = gt_counts_subsets(packed, sets, "cpu", block_rows=64)
    assert streamed.dtype == np.int64
    for p, ids in enumerate(sets):
        for provider in ("native", "numpy"):
            want = tpu_gt_counts_subset(packed, ids, provider)
            np.testing.assert_array_equal(got[:, p].numpy(), want)
            np.testing.assert_array_equal(streamed[:, p], want)
        np.testing.assert_array_equal(gt_counts_subset(packed, ids, "cpu", block_rows=100),
                                      streamed[:, p])


@pytest.mark.parametrize("n_samples", WIDTHS + [2497, 2505])
def test_kept_counts_count_each_masks_samples(n_samples):
    """K_p: the number of distinct ids of each set, for the empty set, one
    sample, every sample, duplicates and gaps, at widths whose last byte
    has pad slots (never kept)."""
    rng = np.random.default_rng(n_samples)
    sets = [_sample_set(kind, n_samples, rng) for kind in SET_KINDS]
    masks = torch.from_numpy(np.stack([sample_byte_masks(ids, (n_samples + 3) // 4)
                                       for ids in sets]))
    kept = kept_counts(masks)
    assert kept.dtype == torch.int32 and kept.shape == (len(sets),)
    assert kept.tolist() == [len(np.unique(ids)) for ids in sets]
    assert kept[SET_KINDS.index("empty")] == 0 and kept[SET_KINDS.index("all")] == n_samples


# K14's constants (csrc/genotype.cu), held equal to the source below
K14_SOURCE = Path(gt_stats.__file__).resolve().parent.parent / "csrc" / "genotype.cu"
K14_CONSTANTS = {"kMaskedWholeRow": 640, "kMaskedChunk": 512}
_POPC16 = np.array([bin(x).count("1") for x in range(1 << 16)], dtype=np.int64)


def _popc(words):
    words = words.astype(np.int64)
    return _POPC16[words & 0xFFFF] + _POPC16[words >> 16]


def _funnel(lo, hi, shift):
    """__funnelshift_r on uint32 arrays: the low 32 bits of (hi:lo) >> shift."""
    wide = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return (wide >> shift.astype(np.uint64)).astype(np.uint32)


def _emulate_k14(buf, first, n_var, rec, masks, kept, chunk, group):
    """K14 on numpy: rows at buf[first + v rec] (n_var rows: one tile),
    staged as the aligned 16-B words that hold them: whole rows (chunk
    None) as one span, else each `chunk`-byte chunk of each row in a slot of
    `pitch` bytes; beside them the chunk's E words of the wrapper's operand
    (mask_words), 32 ceil(len / 32) bytes of each mask, which must lie in
    its row of the operand. Whatever no copy wrote is stale: random bytes
    here. Then the rows' words t and t + 4 of each 32 bytes by funnel shifts
    against the columns of the three products per eight masks, the counts
    read from the lanes' fragments, summed over the chunks of an item
    (`group` chunks of a tile) and added up over the items, K_p by the item
    holding chunk 0."""
    stale = np.random.default_rng(7)
    n_masks = masks.shape[0]
    whole = chunk is None
    chunk = rec if whole else chunk
    n_chunks = -(-rec // chunk)
    span = 32 * (-(-chunk // 32))
    pitch = 16 * ((15 + span + 8 + 15) // 16)
    pitch += 16 if pitch % 32 == 0 else 0
    mask_rows = 8 * (-(-n_masks // 8))
    words = mask_words(torch.from_numpy(masks)).numpy().view(np.uint32)
    assert words.shape == (n_masks, 8 * (-(-rec // 32)))
    counts = np.zeros((n_var, n_masks, 4), dtype=np.int64)
    acc = np.zeros((n_var, mask_rows, 3), dtype=np.int64)
    for c in range(n_chunks):
        at, length = c * chunk, min(chunk, rec - c * chunk)
        n_k = -(-length // 32)
        # the chunk's E words in shared memory: mask rows past P zero
        e = stale.integers(0, 1 << 32, (mask_rows, span // 4 + 4), dtype=np.uint32)
        e[n_masks:] = 0
        part = words[:, at // 4 : at // 4 + 8 * n_k]
        assert part.shape[1] == 8 * n_k
        e[:n_masks, : 8 * n_k] = part
        # the staged tile: whole rows as one copy of the aligned 16-B words
        # that hold them, row v's first byte at off[v]; rows in chunks each
        # in a slot of `pitch` bytes, at its own lead
        src = first + np.arange(n_var) * rec + at
        if whole:
            base = src[0] - src[0] % 16
            top = -(-(src[-1] + length) // 16) * 16
            tile = stale.integers(0, 256, 16 * ((15 + (n_var - 1) * rec + span + 8 + 15) // 16),
                                  dtype=np.uint8)
            tile[: top - base] = buf[base:top]
            off = src - base
        else:
            tile = stale.integers(0, 256, n_var * pitch, dtype=np.uint8)
            off = np.arange(n_var) * pitch + src % 16
            for v in range(n_var):
                lo = src[v] - src[v] % 16
                hi = -(-(src[v] + length) // 16) * 16
                tile[v * pitch : v * pitch + hi - lo] = buf[lo:hi]
        t32 = tile.view("<u4")

        def row_word(w):  # (n_var, len(w)) words aligned to each row's first byte
            at32 = (off >> 2)[:, None] + w[None, :]
            return _funnel(t32[at32], t32[at32 + 1], 8 * (off & 3)[:, None])

        x = np.stack([row_word(8 * np.arange(n_k) + t) for t in range(8)], axis=2)
        xb = x & (x >> 1)  # (n_var, k step, word)
        for m8 in range(mask_rows // 8):
            cols = {}  # product -> (8 columns' words): LH of masks 8m + 0-3, 4-7; B
            for half in range(2):
                cols[half] = np.stack([e[8 * m8 + 4 * half + g // 2, : 8 * n_k] << np.uint32(g % 2)
                                       for g in range(8)])
            cols[2] = np.stack([e[8 * m8 + g // 2 + 4 * (g % 2), : 8 * n_k] for g in range(8)])
            d = {k: _popc((xb if k == 2 else x)[:, None, :, :]
                          & w.reshape(8, n_k, 8)[None]).sum((2, 3))
                 for k, w in cols.items()}  # (n_var, 8 columns)
            # lane 4g + t: columns 2t, 2t + 1 of each product
            for t in range(4):
                for half in range(2):
                    p = 8 * m8 + 4 * half + t
                    acc[:, p] += np.stack([d[half][:, 2 * t], d[half][:, 2 * t + 1],
                                           d[2][:, 2 * t + half]], axis=1)
        if c + 1 == n_chunks or (c + 1) % group == 0:  # the item's last chunk
            l, h, b = (acc[:, :n_masks, k] for k in range(3))
            k0 = kept[None, :] if c < group else 0
            counts += np.stack([k0 - l - h + b, l - b, h - b, b], axis=2)
            acc[:] = 0
    return counts


@pytest.mark.parametrize("n_samples", WIDTHS + [2497, 2505])
def test_mask_words_spread_each_keep_bit_to_its_slot(n_samples):
    """K14's operand: kept sample s sets bit 2 (s % 16) of E word s // 16,
    and nothing else is set, past R included (each row 8 ceil(R / 32)
    words)."""
    rec = (n_samples + 3) // 4
    rng = np.random.default_rng(n_samples)
    sets = [_sample_set(kind, n_samples, rng) for kind in SET_KINDS]
    words = mask_words(torch.from_numpy(np.stack([sample_byte_masks(ids, rec) for ids in sets])))
    assert words.dtype == torch.int32 and words.shape == (len(sets), 8 * (-(-rec // 32)))
    bits = np.unpackbits(words.numpy().view(np.uint8), axis=1, bitorder="little")
    for p, ids in enumerate(sets):
        want = np.zeros(bits.shape[1], dtype=np.uint8)
        want[2 * np.unique(ids)] = 1
        np.testing.assert_array_equal(bits[p], want)


def test_k14_constants_match_the_source():
    source = K14_SOURCE.read_text()
    assert "constexpr int64_t kMaskedWholeRow = 640;" in source
    assert "constexpr int64_t kMaskedChunk = 512;" in source
    assert "a.pitch = 16 * ((15 + span + 8 + 15) / 16);" in source
    assert "a.word_stride = static_cast<int>(8 * ((rec + 31) / 32));" in source
    assert "(15 + (kMaskedRows - 1) * rec + span + 8 + 15) / 16" in source
    assert "static_cast<uint32_t>(32 * ((len + 31) / 32))" in source


@pytest.mark.parametrize("n_sets", [1, 26])
@pytest.mark.parametrize("n_samples", WIDTHS + [2497, 2505])
def test_k14_indexing_follows_each_rows_offset(n_samples, n_sets):
    """K14's indexing on the CPU, emulated with numpy: the records of a
    buffer whose rows start 0-15 B past a 16-B boundary, staged and read as
    the kernel reads them, give the plain counts: rows whole, in chunks of
    kMaskedChunk (as rows past kMaskedWholeRow go; two at R = 626) counted
    by one item, and in chunks of 96 B (7 at R = 626) by items of two; for
    one mask (seven zero mask rows beside it) and for 26: every kind of set
    and a partition into 18 labels (four eights of masks, the last in
    part)."""
    rec = (n_samples + 3) // 4
    rng = np.random.default_rng(n_samples + n_sets)
    if n_sets == 1:
        sets = [_sample_set("unsorted", n_samples, rng)]
    else:
        sets = [_sample_set(kind, n_samples, rng) for kind in SET_KINDS]
        sets += _partition(n_samples, n_sets - len(SET_KINDS), rng)
    masks = np.stack([sample_byte_masks(ids, rec) for ids in sets])
    kept = kept_counts(torch.from_numpy(masks)).numpy().astype(np.int64)
    n_var = 9
    for offset in range(16):
        buf = rng.integers(0, 256, offset + n_var * rec + 32, dtype=np.uint8)
        packed = np.ascontiguousarray(buf[offset : offset + n_var * rec].reshape(n_var, rec))
        want = gt_counts_masked_plain(torch.from_numpy(packed), torch.from_numpy(masks)).numpy()
        assert rec <= K14_CONSTANTS["kMaskedWholeRow"]
        for chunk, group in ((None, 1), (K14_CONSTANTS["kMaskedChunk"], 2), (96, 2)):
            got = _emulate_k14(buf, offset, n_var, rec, masks, kept, chunk, group)
            np.testing.assert_array_equal(got, want, err_msg=f"offset {offset}, chunk {chunk}")


def test_more_sets_than_one_launch_takes():
    """Past MAX_MASKS sets the counts go in groups; each set's counts are
    its own."""
    packed = _records(37, seed=3, n_var=40)
    rng = np.random.default_rng(3)
    sets = [np.sort(rng.choice(37, int(rng.integers(0, 38)), replace=False)).astype(np.int32)
            for _ in range(MAX_MASKS + 3)]
    got = gt_counts_subsets(packed, sets, "cpu", block_rows=50)
    assert got.shape == (packed.shape[0], MAX_MASKS + 3, 4)
    for p, ids in enumerate(sets):
        np.testing.assert_array_equal(got[:, p], tpu_gt_counts_subset(packed, ids, "numpy"))


def test_masked_counts_check_their_inputs():
    packed = torch.from_numpy(_records(9, seed=9, n_var=10))
    rec = packed.shape[1]
    with pytest.raises(ValueError, match="bytes a row"):
        gt_counts_masked(packed, torch.zeros((2, rec + 1), dtype=torch.uint8))
    with pytest.raises(TypeError, match="uint8"):
        gt_counts_masked(packed, torch.zeros((2, rec), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        gt_counts_masked(packed, torch.zeros((rec, 2), dtype=torch.uint8).T)
    assert gt_counts_masked(packed[:0], torch.zeros((3, rec), dtype=torch.uint8)).shape == (0, 3, 4)
    assert gt_counts_masked(packed, torch.zeros((0, rec), dtype=torch.uint8)).shape == (266, 0, 4)
    assert gt_counts_subsets(packed.numpy(), [], "cpu").shape == (266, 0, 4)


# -- the CLI against pgen_tpu.cli.main ---------------------------------------

@pytest.fixture(scope="module", params=WIDTHS)
def fileset(request, tmp_path_factory):
    """(dir, prefix, S) of a chr22-shaped fileset of 48 variants, with a
    regions file, a samples file (unsorted, one IID twice), a --pheno table
    with a POP column (five labels, one sample NA) and a --within file."""
    n = request.param
    d = tmp_path_factory.mktemp(f"counts{n}")
    prefix = str(ensure_chr22(d, num_variants=N_VAR, num_samples=n, seed=n))
    iids = [f"per{i}" for i in range(n)]
    pos = [line.split("\t")[1] for line in open(f"{prefix}.pvar") if not line.startswith("#")]
    (d / "regions.txt").write_text(f"22\t{pos[3]}\n22\t{pos[10]}\t{pos[20]}\n")
    picked = [iids[i] for i in (4, 0, 2, 0) if i < n]
    (d / "samples.txt").write_text("".join(f"{s}\n" for s in picked))
    pops = ["AFR", "EUR", "EAS", "SAS", "AMR"]
    (d / "pheno.tsv").write_text("#IID\tPOP\n" + "".join(
        f"{iid}\t{'NA' if i == 1 else pops[i % 5]}\n" for i, iid in enumerate(iids)))
    (d / "within.txt").write_text("".join(
        f"{iid} {iid} C{i % 3}\n" for i, iid in enumerate(iids) if i % 7 != 6))
    return d, prefix, n


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


QUERY_ARGV = {
    "metadata": ["-f", "ID"],
    "include": ["-f", 'CHROM + ":" + POS + " " + REF + ">" + ALT', "-i", 'ALT == "G"'],
    "exclude": ["-f", "ID", "-e", 'ALT == "G"'],
    "include_exclude": ["-f", "ID", "-i", 'REF != "A"', "-e", 'ALT == "C"'],
    "regions": ["-f", "ID", "-r", "22:10000-14000"],
    "regions_file": ["-f", "POS", "-R", "{d}/regions.txt"],
    "samples": ["-s", "-f", "IID", "-i", 'IID != "per1"'],
    "gt_variants": ["-f", 'ID + " " + str::from(GT_AC) + " " + str::from(GT_MISSING)',
                    "-i", "GT_MAF > 0.1"],
    "gt_samples": ["-s", "-f", 'IID + " " + str::from(GT_NOBS) + " " + str::from(GT_HET)',
                   "-i", "GT_MISSING_RATE < 0.1"],
    "gt_iid": ["-f", 'ID + " " + str::from(GT("per0"))', "-i", 'GT("per0") >= 1'],
    "gt_text": ["-f", 'ID + " " + GT_TEXT("per0")'],
    "gt_row": ["-f", "GT_ROW", "-i", 'POS < "12000"'],
    "gt_text_samples": ["-s", "-f", 'IID + " " + GT_TEXT("snp2")'],
    "regions_with_samples": ["-s", "-f", "IID", "-r", "22:1-5"],
    "bad_expression": ["-f", "ID", "-i", "NOSUCH == 1"],
}


@pytest.mark.parametrize("case", list(QUERY_ARGV))
def test_query_matches_pgen_tpu(fileset, case):
    d, prefix, _ = fileset
    argv = ["query", prefix, *(a.format(d=d) for a in QUERY_ARGV[case])]
    got = _run(port_main, [*argv, "--device", "cpu"])
    want = _run(tpu_main, argv)
    assert got == want
    if case in ("regions_with_samples", "bad_expression"):
        assert got[0] == 1 and got[2].startswith("pgen-tpu: error: ")
    else:
        assert got[0] == 0 and got[1]


def _files(out_dir, stem):
    return {p.name[len(stem):]: p.read_bytes() for p in sorted(out_dir.glob(f"{stem}*"))}


SAMPLE_SETS = {
    "all": [],
    "gaps": ["--exclude-sam", 'IID == "per1" || IID == "per3"', "--include-var", 'ALT != "C"'],
    "file": ["--samples-file", "{d}/samples.txt", "-r", "22:10000-18000"],
}
REPORTS = {
    "freq": [], "freq_counts": ["--counts"], "gcount": [], "missing": [], "hardy": [],
    "hardy_midp": ["--midp"], "het": [],
}


@pytest.mark.parametrize("samples", list(SAMPLE_SETS))
@pytest.mark.parametrize("report", list(REPORTS))
def test_report_files_match_pgen_tpu(fileset, tmp_path, report, samples):
    """Each report's files byte for byte against pgen_tpu's numpy and
    device providers; all samples (K8), or a subset (K14)."""
    d, prefix, _ = fileset
    command = report.split("_")[0]
    argv = [command, prefix, *REPORTS[report], *(a.format(d=d) for a in SAMPLE_SETS[samples])]
    runs = {
        "port": (port_main, ["--device", "cpu"]),
        "numpy": (tpu_main, ["--provider", "numpy"]),
        "device": (tpu_main, ["--provider", "device"]),
    }
    files = {}
    for name, (main, flags) in runs.items():
        rc, _, err = _run(main, [*argv, *flags, "-o", str(tmp_path / name)])
        assert rc == 0, err
        files[name] = (_files(tmp_path, name), err.replace(str(tmp_path / name), "OUT"))
    assert files["port"] == files["numpy"] == files["device"]
    assert all(files["port"][0].values())


@pytest.mark.parametrize("samples", list(SAMPLE_SETS))
def test_stats_matches_pgen_tpu(fileset, samples):
    d, prefix, _ = fileset
    for extra in ([], ["--per-sample"]):
        argv = ["stats", prefix, *extra, *(a.format(d=d) for a in SAMPLE_SETS[samples])]
        got = _run(port_main, [*argv, "--device", "cpu"])
        assert got[0] == 0 and got[1]
        for provider in ("numpy", "device"):
            assert got == _run(tpu_main, [*argv, "--provider", provider])


FST_CASES = {
    "hudson_pheno": ["--pheno", "{d}/pheno.tsv", "--pheno-name", "POP"],
    "wc_pheno": ["--pheno", "{d}/pheno.tsv", "--pheno-name", "POP", "--method", "wc"],
    "hudson_within_variants": ["--within", "{d}/within.txt", "--report-variants"],
    "wc_within_variants": ["--within", "{d}/within.txt", "--method", "wc", "--report-variants",
                           "--exclude-sam", 'IID == "per2"', "-r", "22:10000-18000"],
    "stdout": ["--pheno", "{d}/pheno.tsv", "--pheno-name", "POP", "-o", "-"],
}


@pytest.mark.parametrize("case", list(FST_CASES))
def test_fst_matches_pgen_tpu(fileset, tmp_path, case):
    """fst's summary (and per-variant tables) byte for byte against
    pgen_tpu's numpy and device providers; one K14 call counts every
    cohort. One sample has no cohort (NA, or absent from --within)."""
    d, prefix, n = fileset
    argv = ["fst", prefix, *(a.format(d=d) for a in FST_CASES[case])]
    results = {}
    for name, main, flags in (("port", port_main, ["--device", "cpu"]),
                              ("numpy", tpu_main, ["--provider", "numpy"]),
                              ("device", tpu_main, ["--provider", "device"])):
        out = [] if "-o" in argv else ["-o", str(tmp_path / name)]
        rc, stdout, err = _run(main, [*argv, *flags, *out])
        results[name] = (rc, stdout, err.replace(str(tmp_path / name), "OUT"),
                         _files(tmp_path, name))
    assert results["port"] == results["numpy"] == results["device"]
    if n < 5:  # fewer than two cohorts
        assert results["port"][0] == 1 and "need >= 2 cohorts" in results["port"][2]
    else:
        assert results["port"][0] == 0
        assert results["port"][1] or results["port"][3]


# -- the port's own rules ----------------------------------------------------

COMMANDS = {
    "query": ["-f", "ID"], "freq": [], "gcount": [], "missing": [], "hardy": [], "het": [],
    "stats": [], "fst": ["--pheno", "{d}/pheno.tsv", "--pheno-name", "POP"],
}


@pytest.mark.parametrize("command", list(COMMANDS))
def test_cuda_without_a_card_raises(fileset, tmp_path, monkeypatch, command):
    """--device defaults to cuda, which must be there: one error line,
    exit 1, no output (a metadata-only query included)."""
    d, prefix, _ = fileset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = [] if command in ("query", "stats") else ["-o", str(tmp_path / "x")]
    rc, stdout, err = _run(port_main, [command, prefix,
                                       *(a.format(d=d) for a in COMMANDS[command]), *out])
    assert rc == 1 and not stdout
    assert err.startswith("pgen-tpu: error: ") and "is_available" in err and err.count("\n") == 1
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("command", [c for c in COMMANDS if c != "query"])
def test_analytics_refusals(fileset, monkeypatch, capsys, command):
    """pgen_tpu's host providers and several ranks are refused (exit 2),
    naming the ROADMAP item."""
    d, prefix, _ = fileset
    argv = [command, prefix, *(a.format(d=d) for a in COMMANDS[command]), "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        port_main([*argv, "--provider", "numpy"])
    assert e.value.code == 2 and "(item 8, done)" in capsys.readouterr().err
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit) as e:
        port_main(argv)
    assert e.value.code == 2 and "ROADMAP §1 item 17" in capsys.readouterr().err


@pytest.mark.parametrize("ranks", ["WORLD_SIZE", "PGEN_TPU_NUM_PROCS"])
def test_query_refuses_ranks(fileset, monkeypatch, capsys, ranks):
    """query has no mesh step in pgen_tpu: under several ranks (either
    launcher's variables) it exits 2 naming ROADMAP §1 item 17 and prints
    no row."""
    d, prefix, _ = fileset
    monkeypatch.setenv(ranks, "2")
    with pytest.raises(SystemExit) as e:
        port_main(["query", prefix, *COMMANDS["query"], "--device", "cpu"])
    got = capsys.readouterr()
    assert e.value.code == 2 and not got.out
    assert "query under 2 ranks" in got.err and "ROADMAP §1 item 17" in got.err


@pytest.mark.parametrize("case", ["metadata", "include", "exclude", "regions", "samples"])
def test_metadata_query_counts_nothing(fileset, monkeypatch, case):
    """A query without GT_* or a GT index reads only the .pvar/.psam (and
    the .pgen header): no count or decode runs."""
    d, prefix, _ = fileset

    def refuse(*args, **kwargs):
        raise AssertionError("a metadata-only query counted genotypes")

    for name in ("gt_counts", "sample_counts", "gt_counts_subsets", "gt_counts_device",
                 "sample_counts_device", "gt_counts_masked", "stage_blocks"):
        monkeypatch.setattr(gt_stats, name, refuse)
    argv = ["query", prefix, *(a.format(d=d) for a in QUERY_ARGV[case])]
    got = _run(port_main, [*argv, "--device", "cpu"])
    assert got[0] == 0 and got == _run(tpu_main, argv)


@pytest.mark.parametrize("parts", [1, 2, 3, 7])
def test_staged_blocks_copied_on_threads_are_the_records(parts, monkeypatch):
    """``stage_blocks`` with each block's copy split over ``parts`` threads
    (``copy_rows``) yields the records' rows, a last short block included;
    more shares than rows leave some empty."""
    records = _records(37, 11, n_var=5000)
    monkeypatch.setattr(gt_stats, "STAGE_COPY_THREADS", parts)
    monkeypatch.setattr(gt_stats, "STAGE_COPY_MIN_BYTES", 1)
    got = [(lo, hi, block.clone()) for lo, hi, block in
           gt_stats.stage_blocks(records, torch.device("cpu"), 2048)]
    assert [(lo, hi) for lo, hi, _ in got] == [(0, 2048), (2048, 4096), (4096, 5256)]
    for lo, hi, block in got:
        assert np.array_equal(block.numpy(), records[lo:hi])
    few = np.zeros((3, 4), dtype=np.uint8)
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max(1, parts - 1)) as pool:
        gt_stats.copy_rows(few, records[:3, :4], pool, parts)
    assert np.array_equal(few, records[:3, :4])
