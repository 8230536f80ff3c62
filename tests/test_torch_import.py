"""The port's VCF import (pgen_tpu_torch.pipeline.vcf_import and the
``import`` subcommand) against pgen_tpu's, byte for byte.

VCFs are made from a seed with numpy: phased and unphased calls, missing
calls (``./.``, ``.``, ``./1``, ``.|.``) and, in some cases, ``GT:DP``
subfields; written plain, gzip-compressed and BGZF-compressed. The port runs
with device="cpu", where pack_codes' plain PyTorch version packs; pgen_tpu
runs its numpy, native and device (Pallas in interpret mode) providers.
"""

import gzip

import numpy as np
import pytest
import torch

from pgen_tpu.cli import main as tpu_main
from pgen_tpu.native import HAVE_NATIVE
from pgen_tpu.ops.unpack_host import unpack_codes_reference
from pgen_tpu.pipeline.filter import BGZF_EOF
from pgen_tpu.pipeline.vcf_import import VcfImportError
from pgen_tpu.pipeline.vcf_import import import_vcf as tpu_import
from pgen_tpu_torch.cli import main as port_main
from pgen_tpu_torch.pipeline.filter import filter_to_vcf as port_filter
from pgen_tpu_torch.pipeline.vcf_import import import_vcf as port_import
from pgen_tpu_torch.pipeline.vcf_import_host import VcfImportError as PortVcfImportError
from test_torch_filter import _fileset, _read

SUFFIXES = (".pgen", ".pvar", ".psam")
PROVIDERS = ["numpy", "device"] + (["native"] if HAVE_NATIVE else [])
TOKENS = ["0/0", "0/1", "1/0", "1/1", "0|1", "1|0", "0|0", "1|1", "./.", ".", ".|.", "./1", "0/."]
HEADER = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"


def _vcf_text(n_var, n_samples, seed, fmt="GT", final_newline=True):
    rng = np.random.default_rng(seed)
    lines = ["##fileformat=VCFv4.2", "##source=seeded", "##contig=<ID=1>",
             HEADER + "".join(f"\ts{i}" for i in range(n_samples))]
    for i in range(n_var):
        gts = [TOKENS[t] for t in rng.integers(0, len(TOKENS), n_samples)]
        if fmt != "GT":
            gts = [f"{g}:{d}" for g, d in zip(gts, rng.integers(0, 99, n_samples))]
        lines.append(f"{1 + i // 7}\t{100 + 13 * i}\trs{i}\tA\tG\t.\tPASS\tAF=0.{i}\t{fmt}\t"
                     + "\t".join(gts))
    return "\n".join(lines) + ("\n" if final_newline else "")


def _write_vcf(path, text, compression):
    data = text.encode()
    if compression == "gzip":
        data = gzip.compress(data)
    elif compression == "bgzf":
        from pgen_tpu.native import native

        data = bytes(native.bgzf_compress(np.frombuffer(data, dtype=np.uint8))) + BGZF_EOF
    path.write_bytes(data)
    return path


def _vcf(tmp_path, text, compression="vcf"):
    name = "in.vcf" if compression == "vcf" else "in.vcf.gz"
    return _write_vcf(tmp_path / name, text, compression)


def _assert_same_fileset(a, b):
    for suf in SUFFIXES:
        assert _read(f"{a}{suf}") == _read(f"{b}{suf}"), suf


CASES = {
    "gt": {},
    "gt_subfields": {"fmt": "GT:DP"},
    "chunk_48": {"chunk_bytes": 48},
    "no_final_newline": {"final_newline": False},
}
COMPRESSIONS = ["vcf", "gzip"] + (["bgzf"] if HAVE_NATIVE else [])


@pytest.mark.parametrize("provider", PROVIDERS)
@pytest.mark.parametrize("compression", COMPRESSIONS)
@pytest.mark.parametrize("case", list(CASES))
def test_import_matches_pgen_tpu(tmp_path, case, compression, provider):
    kw = dict(CASES[case])
    chunk = {"chunk_bytes": kw.pop("chunk_bytes")} if "chunk_bytes" in kw else {}
    vcf = _vcf(tmp_path, _vcf_text(40, 5, seed=len(case), **kw), compression)
    want = tpu_import(vcf, tmp_path / "tpu", provider=provider, **chunk)
    got = port_import(vcf, tmp_path / "port", device="cpu", **chunk)
    _assert_same_fileset(tmp_path / "port", tmp_path / "tpu")
    assert (got.num_variants, got.num_samples, got.bytes_read) == (
        want.num_variants, want.num_samples, want.bytes_read,
    )


@pytest.mark.parametrize("provider", PROVIDERS)
@pytest.mark.parametrize("n_samples", [1, 4, 7, 8])
def test_import_widths_match_pgen_tpu(tmp_path, n_samples, provider):
    vcf = _vcf(tmp_path, _vcf_text(30, n_samples, seed=n_samples))
    tpu_import(vcf, tmp_path / "tpu", provider=provider, chunk_bytes=300)
    port_import(vcf, tmp_path / "port", device="cpu", chunk_bytes=300)
    _assert_same_fileset(tmp_path / "port", tmp_path / "tpu")


@pytest.mark.skipif(not HAVE_NATIVE, reason="BGZF input needs the C++ runtime")
def test_import_multi_member_bgzf(tmp_path):
    """A BGZF body of several members, with chunks smaller than a member."""
    vcf = _vcf(tmp_path, _vcf_text(300, 60, seed=3, fmt="GT:DP"), "bgzf")
    tpu_import(vcf, tmp_path / "tpu", provider="numpy", chunk_bytes=5000)
    port_import(vcf, tmp_path / "port", device="cpu", chunk_bytes=5000)
    _assert_same_fileset(tmp_path / "port", tmp_path / "tpu")


BAD_ROWS = {
    "allele_2": lambda row: row.rsplit("\t", 2)[0] + "\t2/0\t0/0",
    "two_digit_allele": lambda row: row.rsplit("\t", 1)[0] + "\t0/12",
    "format_without_leading_gt": lambda row: row.replace("\tGT\t", "\tDP\t"),
    "ragged_tabs": lambda row: row.rsplit("\t", 1)[0],
    "bad_separator": lambda row: row.rsplit("\t", 1)[0] + "\t0-1",
}


@pytest.mark.parametrize("chunk_bytes", [48, 1 << 20])
@pytest.mark.parametrize("bad", list(BAD_ROWS))
def test_malformed_row_raises_as_pgen_tpu(tmp_path, bad, chunk_bytes):
    text = _vcf_text(8, 4, seed=11)
    lines = text.split("\n")
    row = 4 + 5  # the sixth data row, after 4 header lines
    lines[row] = BAD_ROWS[bad](lines[row])
    vcf = _vcf(tmp_path, "\n".join(lines))
    messages = []
    for provider in PROVIDERS:
        with pytest.raises(VcfImportError) as e:
            tpu_import(vcf, tmp_path / provider, provider=provider, chunk_bytes=chunk_bytes)
        messages.append(str(e.value))
    with pytest.raises(PortVcfImportError) as e:
        port_import(vcf, tmp_path / "port", device="cpu", chunk_bytes=chunk_bytes)
    assert "data row 6" in str(e.value)
    assert [str(e.value)] * len(messages) == messages


@pytest.mark.parametrize("n_samples", [5, 8])
def test_round_trip_of_the_port_vcf_filter(tmp_path, n_samples):
    """fileset -> the port's VCF filter -> the port's import gives back the
    genotypes; when S % 4 == 0 there are no pad bits and the records come
    back byte for byte."""
    prefix = _fileset(tmp_path, 23, n_samples, seed=n_samples)
    vcf = tmp_path / "rt.vcf"
    port_filter(prefix, out_file=vcf, device="cpu")
    port_import(vcf, tmp_path / "port", device="cpu", chunk_bytes=200)
    tpu_import(vcf, tmp_path / "tpu", provider="numpy")
    _assert_same_fileset(tmp_path / "port", tmp_path / "tpu")
    rec = (2 * n_samples + 7) // 8
    src = np.fromfile(f"{prefix}.pgen", dtype=np.uint8)[12:].reshape(23, rec)
    got = np.fromfile(tmp_path / "port.pgen", dtype=np.uint8)
    assert got[:12].tobytes() == _read(f"{prefix}.pgen")[:12]
    got = got[12:].reshape(23, rec)
    np.testing.assert_array_equal(
        unpack_codes_reference(got, n_samples), unpack_codes_reference(src, n_samples)
    )
    if n_samples % 4 == 0:
        np.testing.assert_array_equal(got, src)


@pytest.mark.parametrize("gz", [False, True], ids=["vcf", "vcf_gz"])
def test_cli_import_matches_pgen_tpu(tmp_path, capsys, gz):
    vcf = _vcf(tmp_path, _vcf_text(25, 6, seed=25), "gzip" if gz else "vcf")
    assert port_main(["import", str(vcf), "-o", str(tmp_path / "port"), "--device", "cpu",
                      "--stats"]) == 0
    port_err = capsys.readouterr().err
    assert tpu_main(["import", str(vcf), "-o", str(tmp_path / "tpu")]) == 0
    tpu_err = capsys.readouterr().err
    _assert_same_fileset(tmp_path / "port", tmp_path / "tpu")
    assert "kernel:" in port_err
    port_done = port_err.splitlines()[-1].replace(str(tmp_path / "port"), str(tmp_path / "tpu"))
    assert port_done == tpu_err.splitlines()[-1]


def test_cli_default_output_prefix(tmp_path):
    vcf = _vcf(tmp_path, _vcf_text(9, 3, seed=9), "gzip")
    assert port_main(["import", str(vcf), "--device", "cpu"]) == 0
    tpu_import(vcf, tmp_path / "tpu", provider="numpy")
    _assert_same_fileset(tmp_path / "in", tmp_path / "tpu")


def test_cuda_without_a_card_raises(tmp_path, monkeypatch, capsys):
    vcf = _vcf(tmp_path, _vcf_text(4, 4, seed=4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        port_import(vcf, tmp_path / "x", device="cuda")
    # --device defaults to cuda; the CLI fails fast with one stderr line
    assert port_main(["import", str(vcf), "-o", str(tmp_path / "x")]) == 1
    err = capsys.readouterr().err
    assert err.startswith("pgen-tpu: error: ") and "is_available" in err and err.count("\n") == 1
    assert not list(tmp_path.glob("x*"))
