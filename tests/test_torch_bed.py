"""The port's PLINK1 ``.bed`` output and import (``pgen_tpu_torch.pipeline.
bed_import``, ``filter --out-format bed``, ``import X.bed``) against
pgen_tpu's, byte for byte.

Filesets come from test_torch_filter's ``_fileset`` (random record bytes,
pad bits included) at S = 4k..4k+3 samples, so every tail-byte layout is
met both ways. The port runs with device="cpu", where subset_repack's plain
PyTorch version re-packs; pgen_tpu runs its numpy provider and its device
provider (Pallas in interpret mode on the CPU). Also here: the copied error
paths, pgen -> bed -> pgen round trips, the CLI, and the copied functions'
source (``test_copied_verbatim``).
"""

import inspect
from pathlib import Path

import numpy as np
import pytest

from conftest import build_fileset
from pgen_tpu.cli import main as tpu_main
from pgen_tpu.formats.writer import write_pgen_packed
from pgen_tpu.pipeline import bed_import as tpu_bed
from pgen_tpu_torch.cli import main as port_main
from pgen_tpu_torch.pipeline import bed_import as port_bed
from pgen_tpu_torch.pipeline import bed_import_host as port_bed_host
from test_torch_filter import _fileset, _read

BED_SUFFIXES = (".bed", ".bim", ".fam")
PGEN_SUFFIXES = (".pgen", ".pvar", ".psam")
WIDTHS = (8, 9, 10, 11)  # S % 4 = 0, 1, 2, 3

CASES = {
    "keep_all": {},
    "sample_subset": {"sam_query": 'IID == "s4" || IID == "s1" || IID == "s2"'},
    "variant_subset": {"var_query": 'ALT == "G"'},
    "both_subsets": {"var_query": 'ALT != "C"', "sam_query": 'SEX == "F"'},
    "gt_predicates": {"var_query": "GT_AC > 4", "sam_query": "GT_MISSING_RATE < 0.5"},
    "empty_variants": {"var_query": 'ID == "none"'},
}


def _same_files(a, b, suffixes):
    for suf in suffixes:
        assert _read(f"{a}{suf}") == _read(f"{b}{suf}"), suf


def _bed_fileset(d: Path, n_var: int, n_samples: int, seed: int, name="x") -> str:
    """A PLINK1 fileset of random record bytes (pad bits too, as plink
    input may carry them), space-delimited .bim/.fam rows."""
    rng = np.random.default_rng(seed)
    rec = (n_samples + 3) // 4
    prefix = d / name
    Path(f"{prefix}.bed").write_bytes(
        port_bed_host.BED_MAGIC + rng.integers(0, 256, (n_var, rec), dtype=np.uint8).tobytes())
    Path(f"{prefix}.bim").write_text("".join(
        f"2 rs{i} 0 {100 + 7 * i} {'GCTA'[i % 4]} A\n" for i in range(n_var)))
    Path(f"{prefix}.fam").write_text("".join(
        f"fam{i} s{i} 0 0 {i % 3} {i % 2 + 1}\n" for i in range(n_samples)))
    return str(prefix)


# -- import X.bed ---------------------------------------------------------------

@pytest.mark.parametrize("n_samples", WIDTHS)
def test_import_bed_matches_pgen_tpu(tmp_path, n_samples):
    prefix = _bed_fileset(tmp_path, 13, n_samples, seed=n_samples)
    want = tpu_bed.import_bed(f"{prefix}.bed", out_prefix=tmp_path / "tpu", chunk_rows=5)
    got = port_bed.import_bed(f"{prefix}.bed", out_prefix=tmp_path / "port", chunk_rows=5)
    _same_files(tmp_path / "port", tmp_path / "tpu", PGEN_SUFFIXES)
    assert (got.num_variants, got.num_samples) == (want.num_variants, want.num_samples)


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("n_samples", WIDTHS)
def test_cli_import_bed_matches_pgen_tpu(tmp_path, capsys, n_samples, device):
    """``import X.bed`` is host code: the default --device cuda (no card
    here) and --device cpu write pgen_tpu's bytes and stderr line."""
    prefix = _bed_fileset(tmp_path, 13, n_samples, seed=n_samples)
    argv = ["import", f"{prefix}.bed"]
    assert port_main([*argv, "-o", str(tmp_path / "out_a"),
                      *(["--device", device] if device else [])]) == 0
    err_port = capsys.readouterr().err
    assert tpu_main([*argv, "-o", str(tmp_path / "out_b")]) == 0
    err_tpu = capsys.readouterr().err
    _same_files(tmp_path / "out_a", tmp_path / "out_b", PGEN_SUFFIXES)
    assert err_port.replace("out_a", "out_b") == err_tpu


def _import_errors(tmp_path):
    """test_bed_import.py::test_errors' cases: (bed path, expected match)."""
    prefix = Path(_bed_fileset(tmp_path, 1, 1, seed=1))
    good = Path(f"{prefix}.bed").read_bytes()
    cases = []
    for name, bed, bim in (
        ("magic", b"\x00" + good[1:], None),
        ("sample-major", good[:2] + b"\x00" + good[3:], None),
        ("size", port_bed_host.BED_MAGIC + b"\x00\x00", None),
        (".bim row 1", good, b"19 rs0 0 100 G\n"),
    ):
        bad = tmp_path / name.replace(" ", "_").replace(".", "")
        Path(f"{bad}.bed").write_bytes(bed)
        Path(f"{bad}.bim").write_bytes(bim or Path(f"{prefix}.bim").read_bytes())
        Path(f"{bad}.fam").write_bytes(Path(f"{prefix}.fam").read_bytes())
        cases.append((f"{bad}.bed", name))
    return cases


@pytest.mark.parametrize("case", range(4))
def test_import_bed_errors_match_pgen_tpu(tmp_path, capsys, case):
    """The copied error paths: the same exception class and text, and the
    same CLI exit code and stderr line."""
    path, match = _import_errors(tmp_path)[case]
    errors = []
    for mod in (tpu_bed, port_bed):
        with pytest.raises(ValueError, match=match) as e:
            mod.import_bed(path, out_prefix=tmp_path / "o")
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0] == errors[1] and errors[0][0] == "BedImportError"
    assert issubclass(port_bed.BedImportError, ValueError)
    rcs = [main(["import", path, "-o", str(tmp_path / "o")]) for main in (port_main, tpu_main)]
    err = capsys.readouterr().err.splitlines()
    assert rcs == [1, 1] and err[0] == err[1] and err[0].startswith("pgen-tpu: error: ")


def test_import_rejects_a_path_without_bed_suffix(tmp_path):
    for mod in (tpu_bed, port_bed):
        with pytest.raises(ValueError, match="expected a .bed path"):
            mod.import_bed(tmp_path / "x.txt")


# -- filter --out-format bed ------------------------------------------------------

@pytest.mark.parametrize("provider", ["numpy", "device"])
@pytest.mark.parametrize("n_samples", WIDTHS)
@pytest.mark.parametrize("case", list(CASES))
def test_filter_to_bed_matches_pgen_tpu(tmp_path, case, n_samples, provider):
    prefix = _fileset(tmp_path, 23, n_samples, seed=n_samples)
    kw = CASES[case]
    want = tpu_bed.filter_to_bed(prefix, out_prefix=tmp_path / "tpu", provider=provider,
                                 block_variants=7, **kw)
    got = port_bed.filter_to_bed(prefix, out_prefix=tmp_path / "port", device="cpu",
                                 block_variants=7, **kw)
    _same_files(tmp_path / "port", tmp_path / "tpu", BED_SUFFIXES)
    assert (got.num_variants, got.num_samples) == (want.num_variants, want.num_samples)
    body = np.frombuffer(_read(tmp_path / "port.bed")[3:], dtype=np.uint8)
    if got.num_samples % 4 and body.size:
        pad = ~np.uint8((1 << (2 * (got.num_samples % 4))) - 1)
        assert not (body.reshape(got.num_variants, -1)[:, -1] & pad).any()


@pytest.mark.parametrize("provider", ["auto", "device"])
def test_filter_to_bed_port_providers_agree(tmp_path, provider):
    """The port's --provider device makes the predicates' genotype counts
    with the device compute_masks (K8/K9): the same files."""
    prefix = _fileset(tmp_path, 23, 10, seed=10)
    kw = CASES["gt_predicates"]
    tpu_bed.filter_to_bed(prefix, out_prefix=tmp_path / "tpu", provider="numpy", **kw)
    port_bed.filter_to_bed(prefix, out_prefix=tmp_path / "port", device="cpu",
                           provider=provider, **kw)
    _same_files(tmp_path / "port", tmp_path / "tpu", BED_SUFFIXES)


def test_filter_to_bed_with_pheno_and_no_sex(tmp_path):
    """.fam takes PHENO1 when the .psam has it, and SEX 0 when it has none."""
    rng = np.random.default_rng(3)
    pvar = [f"1\t{100 + i}\trs{i}\tA\tG\t.\t.\t." for i in range(6)]
    psam = [f"s{i}\t{rng.normal():.3f}" for i in range(7)]
    prefix = build_fileset(tmp_path, "ph", np.zeros((6, 7), dtype=np.uint8), pvar, psam,
                           psam_columns="#IID\tPHENO1")
    write_pgen_packed(f"{prefix}.pgen", rng.integers(0, 256, (6, 2), dtype=np.uint8), 7)
    for kw in ({}, {"sam_query": 'IID != "s3"'}):
        tpu_bed.filter_to_bed(prefix, out_prefix=tmp_path / "tpu", provider="numpy", **kw)
        port_bed.filter_to_bed(prefix, out_prefix=tmp_path / "port", device="cpu", **kw)
        _same_files(tmp_path / "port", tmp_path / "tpu", BED_SUFFIXES)


@pytest.mark.parametrize("n_samples", WIDTHS)
def test_round_trip_pgen_bed_pgen(tmp_path, n_samples):
    """pgen -> bed -> pgen gives back the kept records, pad bits zero: the
    whole fileset, and a sample subset against the port's own pgen
    output of the same subset."""
    prefix = _fileset(tmp_path, 19, n_samples, seed=n_samples + 100)
    port_bed.filter_to_bed(prefix, out_prefix=tmp_path / "all", device="cpu")
    port_bed.import_bed(tmp_path / "all.bed", out_prefix=tmp_path / "back")
    rec = (n_samples + 3) // 4
    records = np.frombuffer(_read(f"{prefix}.pgen")[12:], dtype=np.uint8).reshape(19, rec).copy()
    if n_samples % 4:
        records[:, -1] &= (1 << (2 * (n_samples % 4))) - 1
    assert _read(tmp_path / "back.pgen")[12:] == records.tobytes()

    from pgen_tpu_torch.pipeline.pgen_out import filter_to_pgen

    sub = CASES["both_subsets"]
    port_bed.filter_to_bed(prefix, out_prefix=tmp_path / "sub", device="cpu", **sub)
    port_bed.import_bed(tmp_path / "sub.bed", out_prefix=tmp_path / "sub_back")
    filter_to_pgen(prefix, out_prefix=tmp_path / "sub_pgen", device="cpu", **sub)
    assert _read(tmp_path / "sub_back.pgen") == _read(tmp_path / "sub_pgen.pgen")


@pytest.mark.parametrize(
    "argv",
    [
        ["--out-format", "bed"],
        ["--out-format", "bed", "--keep", "{dir}/keep.txt", "--stats"],
        ["--out-format", "bed", "--maf", "0.2", "--provider", "device"],
        ["--out-format", "bed", "-r", "1:100-900", "--exclude-sam", 'SEX == "M"'],
        ["--out-format", "bed", "--index"],
        ["--out-format", "bed", "-o", "-"],
    ],
)
def test_cli_bed_matches_pgen_tpu(tmp_path, capsys, argv):
    """filter --out-format bed through both CLIs: the files, the exit code
    and the error line (``--index`` and ``-o -`` are VCF-only: exit 1)."""
    prefix = _fileset(tmp_path, 31, 9, seed=31)
    (tmp_path / "keep.txt").write_text("s4\ns1\nFAM s3\ns8\n")
    argv = [a.format(dir=tmp_path) for a in argv]
    out = ["-o", "-"] if "-o" in argv else []
    argv = [a for a in argv if a not in ("-o", "-")]
    rcs, errs = [], []
    for main, name, extra in ((port_main, "port", ["--device", "cpu"]), (tpu_main, "tpu", [])):
        rcs.append(main(["filter", prefix, *argv, *(out or ["-o", str(tmp_path / name)]),
                         *extra]))
        errs.append(capsys.readouterr().err)
    assert rcs[0] == rcs[1]
    if rcs[0] == 0:
        _same_files(tmp_path / "port", tmp_path / "tpu", BED_SUFFIXES)
    else:
        assert rcs[0] == 1 and errs[0] == errs[1]
        assert not list(tmp_path.glob("port.*"))


# -- the copies ----------------------------------------------------------------------

COPIED = ["BedImportError", "BedImportResult", "_read_table", "import_bed", "_sex_code",
          "_byte_lut"]


@pytest.mark.parametrize("name", COPIED)
def test_copied_verbatim(name):
    want = inspect.getsource(getattr(tpu_bed, name))
    got = inspect.getsource(getattr(port_bed_host, name)).replace("pgen_tpu_torch.", "pgen_tpu.")
    assert got == want


@pytest.mark.parametrize("name", ["BED_MAGIC", "DEFAULT_CHUNK_ROWS", "_CODE_MAP",
                                  "_CODE_MAP_INV", "_BYTE_LUT", "_BYTE_LUT_INV"])
def test_copied_constants(name):
    a, b = getattr(tpu_bed, name), getattr(port_bed_host, name)
    assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b


def test_filter_to_bed_keeps_pgen_tpu_text():
    """The port's filter_to_bed writes .bim and .fam with pgen_tpu's lines:
    the two stages' source is the same, but for the port's timer calls."""
    want = inspect.getsource(tpu_bed.filter_to_bed)
    got = inspect.getsource(port_bed.filter_to_bed)
    for stage in ("bim", "fam"):
        block = want[want.index(f'    with timer.stage("{stage}"):'):]
        block = block[: block.index("\n\n")]
        assert block in got, stage
