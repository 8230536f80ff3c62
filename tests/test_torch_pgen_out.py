"""The port's fileset output (pgen_tpu_torch.pipeline.pgen_out and
``filter --out-format pgen``) against pgen_tpu's, byte for byte.

Filesets come from test_torch_filter's ``_fileset`` (random record bytes,
pad bits included). The port runs with device="cpu", where subset_repack's
plain PyTorch version re-packs; pgen_tpu runs its numpy provider and its
device provider (Pallas in interpret mode on the CPU).
"""

import pytest
import torch

from pgen_tpu.cli import main as tpu_main
from pgen_tpu.pipeline.pgen_out import filter_to_pgen as tpu_filter_to_pgen
from pgen_tpu_torch.cli import main as port_main
from pgen_tpu_torch.pipeline.pgen_out import filter_to_pgen as port_filter_to_pgen
from test_torch_filter import _fileset, _read

SUFFIXES = (".pgen", ".pvar", ".psam")

CASES = {
    "keep_all": {},
    "sample_subset": {"sam_query": 'IID == "s4" || IID == "s1" || IID == "s2"'},
    "variant_subset": {"var_query": 'ALT == "G"'},
    "both_subsets": {"var_query": 'ALT != "C"', "sam_query": 'SEX == "F"'},
    "empty_variants": {"var_query": 'ID == "none"'},
    "empty_samples": {"sam_query": 'IID == "none"'},
    "ragged_blocks_keep_all": {"block_variants": 7},
    "ragged_blocks_subset": {"block_variants": 7, "sam_query": 'IID != "s3"'},
}


def _assert_same_fileset(a, b):
    for suf in SUFFIXES:
        assert _read(f"{a}{suf}") == _read(f"{b}{suf}"), suf


# pgen_tpu's device provider cannot keep zero samples (test below)
PAIRS = [
    (c, p) for c in CASES for p in ("numpy", "device") if (c, p) != ("empty_samples", "device")
]


@pytest.mark.parametrize("n_samples", [5, 6, 7, 8])
@pytest.mark.parametrize("case,provider", PAIRS)
def test_filter_to_pgen_matches_pgen_tpu(tmp_path, case, provider, n_samples):
    prefix = _fileset(tmp_path, 23, n_samples, seed=n_samples)
    kw = CASES[case]
    want = tpu_filter_to_pgen(prefix, out_prefix=tmp_path / "tpu", provider=provider, **kw)
    got = port_filter_to_pgen(prefix, out_prefix=tmp_path / "port", device="cpu", **kw)
    _assert_same_fileset(tmp_path / "port", tmp_path / "tpu")
    assert (got.out_prefix, got.num_variants_kept, got.num_samples_kept) == (
        str(tmp_path / "port"),
        want.num_variants_kept,
        want.num_samples_kept,
    )


@pytest.mark.parametrize("n_samples", [5, 8])
def test_empty_samples_where_pgen_tpu_device_fails(tmp_path, n_samples):
    """pgen_tpu's device provider raises on a query that keeps no sample: its
    Pallas pack gets a (V, 0) block. The port writes the empty-sample
    fileset that pgen_tpu's numpy provider writes."""
    prefix = _fileset(tmp_path, 23, n_samples, seed=n_samples)
    kw = CASES["empty_samples"]
    with pytest.raises(ZeroDivisionError):
        tpu_filter_to_pgen(prefix, out_prefix=tmp_path / "dev", provider="device", **kw)
    tpu_filter_to_pgen(prefix, out_prefix=tmp_path / "tpu", provider="numpy", **kw)
    port_filter_to_pgen(prefix, out_prefix=tmp_path / "port", device="cpu", **kw)
    _assert_same_fileset(tmp_path / "port", tmp_path / "tpu")


@pytest.mark.parametrize("case", ["keep_all", "sample_subset"])
def test_filter_to_pgen_matches_pgen_tpu_wide(tmp_path, case):
    prefix = _fileset(tmp_path, 9, 2503, seed=2503)
    kw = CASES[case]
    tpu_filter_to_pgen(prefix, out_prefix=tmp_path / "tpu", provider="device", **kw)
    port_filter_to_pgen(prefix, out_prefix=tmp_path / "port", device="cpu", **kw)
    _assert_same_fileset(tmp_path / "port", tmp_path / "tpu")


def test_default_output_prefix(tmp_path):
    prefix = _fileset(tmp_path, 6, 5, seed=6)
    res = port_filter_to_pgen(prefix, sam_query='IID != "s0"', device="cpu")
    assert res.out_prefix == f"{prefix}.pgen-rs"
    tpu_filter_to_pgen(prefix, sam_query='IID != "s0"', out_prefix=tmp_path / "tpu",
                       provider="numpy")
    _assert_same_fileset(res.out_prefix, tmp_path / "tpu")


@pytest.mark.parametrize(
    "argv",
    [
        [],
        ["--keep", "{dir}/keep.txt"],
        ["--samples", "s5,s1"],
        ["-r", "1:150-600", "--samples", "^s0", "--block-variants", "4"],
        ["--remove", "{dir}/keep.txt", "--maf", "0.3"],
        ["--extract", "{dir}/ids.txt", "--rm-dup", "force-first"],
    ],
    ids=["keep_all", "keep", "samples", "regions_samples_blocks", "remove_maf", "extract_rm_dup"],
)
def test_cli_out_format_pgen_matches_pgen_tpu(tmp_path, argv):
    prefix = _fileset(tmp_path, 31, 6, seed=31)
    (tmp_path / "keep.txt").write_text("s4\ns1\nFAM s3\n")
    (tmp_path / "ids.txt").write_text("rs2\nrs3\nrs17\nrs30\n")
    argv = ["--out-format", "pgen", *(arg.format(dir=tmp_path) for arg in argv)]
    a, b = tmp_path / "port", tmp_path / "tpu"
    assert port_main(["filter", prefix, *argv, "--device", "cpu", "-o", str(a)]) == 0
    assert tpu_main(["filter", prefix, *argv, "-o", str(b)]) == 0
    _assert_same_fileset(a, b)


def test_cli_default_output_prefix(tmp_path):
    prefix = _fileset(tmp_path, 8, 6, seed=8)
    assert port_main(["filter", prefix, "--out-format", "pgen", "--samples", "s2,s0",
                      "--device", "cpu"]) == 0
    tpu_filter_to_pgen(prefix, sam_query='IID == "s2" || IID == "s0"',
                       out_prefix=tmp_path / "tpu", provider="numpy")
    _assert_same_fileset(f"{prefix}.pgen-rs", tmp_path / "tpu")


@pytest.mark.parametrize(
    "argv,message",
    [
        (["-o", "-"], "-o - (stdout) supports VCF output only"),
        (["-o", "{dir}/x.vcf.gz", "--index"], "--index applies to VCF output only"),
        (["-o", "{dir}/x", "--index"], "--index requires -o out.vcf.gz"),
    ],
    ids=["stdout", "index", "index_not_gz"],
)
def test_cli_refuses_what_pgen_tpu_refuses(tmp_path, capsys, argv, message):
    prefix = _fileset(tmp_path, 4, 4, seed=4)
    argv = [arg.format(dir=tmp_path) for arg in argv]
    assert port_main(["filter", prefix, "--out-format", "pgen", *argv, "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert err == f"pgen-tpu: error: {message}\n"
    assert tpu_main(["filter", prefix, "--out-format", "pgen", *argv]) == 1
    assert capsys.readouterr().err == err
    assert not list(tmp_path.glob("x*"))


def test_cuda_without_a_card_raises(tmp_path, monkeypatch, capsys):
    prefix = _fileset(tmp_path, 4, 4, seed=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x"
    with pytest.raises(RuntimeError, match="is_available"):
        port_filter_to_pgen(prefix, sam_query='IID == "s1"', out_prefix=out, device="cuda")
    # the CLI fails fast: one stderr line and exit code 1, never the CPU
    assert port_main(["filter", prefix, "--out-format", "pgen", "-o", str(out)]) == 1
    err = capsys.readouterr().err
    assert err.startswith("pgen-tpu: error: ") and "is_available" in err and err.count("\n") == 1
    assert not list(tmp_path.glob("x*"))
