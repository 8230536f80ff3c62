"""The twelve fileset subcommands of the port (ROADMAP §1 item 13) against
pgen_tpu's, through both CLIs.

describe, index, view, split, concat, sort and isec are host code alone:
the port's copies run with pgen_tpu's arguments. merge, diff, annotate,
export and roh have a card stage (K1 and K4 for merge; K1 for diff, export
and roh; K8 or K14 for ``annotate --fill-info``): the port runs them with
``--device cpu``, the kernels' plain PyTorch versions, and pgen_tpu on its
default provider (native C++ or numpy). Every output file must be
byte-equal, and the exit code, stdout and stderr equal (output paths
masked): on the error paths too (MergeError, ConcatError, VcfIndexError,
VcfViewError, annotate with no action, ...). Also here: ``filter --rm-dup
error|list`` (ROADMAP §1 item 12 (d)), the refusals the port keeps (host
providers, several ranks, cuda without a card), and the copied functions'
source (``test_copied_verbatim``).
"""

import contextlib
import gzip
import inspect
import io
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import build_fileset
from pgen_tpu.cli import main as tpu_main
from pgen_tpu.formats import describe as tpu_describe
from pgen_tpu.formats.writer import write_pgen_packed
from pgen_tpu.ops import roh as tpu_roh
from pgen_tpu.pipeline import annotate as tpu_annotate
from pgen_tpu.pipeline import concat as tpu_concat
from pgen_tpu.pipeline import diff as tpu_diff
from pgen_tpu.pipeline import export_raw as tpu_export
from pgen_tpu.pipeline import filter as tpu_filter
from pgen_tpu.pipeline import index_vcf as tpu_index
from pgen_tpu.pipeline import isec as tpu_isec
from pgen_tpu.pipeline import merge as tpu_merge
from pgen_tpu.pipeline import roh as tpu_roh_pipeline
from pgen_tpu.pipeline import sort as tpu_sort
from pgen_tpu.pipeline import split as tpu_split
from pgen_tpu.pipeline import view as tpu_view
from pgen_tpu_torch.cli import CARD_FILES, HOST_FILES
from pgen_tpu_torch.cli import main as port_main
from pgen_tpu_torch.formats import describe as port_describe
from pgen_tpu_torch.ops import roh as port_roh
from pgen_tpu_torch.pipeline import annotate_host as port_annotate
from pgen_tpu_torch.pipeline import concat as port_concat
from pgen_tpu_torch.pipeline import diff_host as port_diff
from pgen_tpu_torch.pipeline import export_raw_host as port_export
from pgen_tpu_torch.pipeline import filter_host as port_filter
from pgen_tpu_torch.pipeline import index_vcf as port_index
from pgen_tpu_torch.pipeline import isec as port_isec
from pgen_tpu_torch.pipeline import merge_host as port_merge
from pgen_tpu_torch.pipeline import roh_host as port_roh_pipeline
from pgen_tpu_torch.pipeline import sort as port_sort
from pgen_tpu_torch.pipeline import split as port_split
from pgen_tpu_torch.pipeline import view as port_view
from test_torch_filter import _fileset


def _run(main, argv):
    """rc, stdout bytes (text and ``sys.stdout.buffer`` writes in order) and
    stderr of one CLI run."""
    raw = io.BytesIO()
    out = io.TextIOWrapper(raw, encoding="utf-8", write_through=True)
    err = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main([str(a) for a in argv])
    out.flush()
    return rc, raw.getvalue(), err.getvalue()


def _both(tmp_path, argv, prep=None, rc=0):
    """argv through pgen_tpu's CLI and the port's (``--device cpu`` where the
    subcommand has a card stage), ``{o}`` an output directory of each side's
    own (``prep(o)`` fills it first) and ``{d}`` the input directory: equal
    exit codes, stdout and stderr (each side's directory masked), and the same
    files in both directories, byte for byte. Returns the port's directory,
    stdout and stderr."""
    got = {}
    for who, main in (("tpu", tpu_main), ("port", port_main)):
        o = tmp_path / who
        o.mkdir()
        if prep:
            prep(o)
        args = [str(a).format(o=o, d=tmp_path) for a in argv]
        if who == "port" and argv[0] in CARD_FILES + ("filter",):
            args += ["--device", "cpu"]
        code, out, err = _run(main, args)
        files = {f.name: f.read_bytes() for f in sorted(o.iterdir())}
        got[who] = (code, out.replace(str(o).encode(), b"{o}"), err.replace(str(o), "{o}"),
                    files)
    assert got["port"][:3] == got["tpu"][:3]
    assert sorted(got["port"][3]) == sorted(got["tpu"][3])
    for name, data in got["tpu"][3].items():
        assert got["port"][3][name] == data, name
    assert got["port"][0] == rc, got["port"][2]
    return tmp_path / "port", got["port"][1], got["port"][2]


@pytest.fixture
def fs(tmp_path):
    """23 variants on contigs 1 and 2 (every fifth ID a duplicate) x 7
    samples, random record bytes (pad bits included)."""
    return _fileset(tmp_path, 23, 7, seed=14)


# -- describe ---------------------------------------------------------------


def _general_pgen(path, n_var=300, type_bits=4, len_bytes=2):
    """A variable-record (general-mode) header, as tests/test_describe.py
    writes it."""
    fmt = (0b01 << 6) | ((0 if type_bits == 4 else 4) + (len_bytes - 1))
    out = bytearray(b"\x6c\x1b\x10" + struct.pack("<II", n_var, 100) + bytes([fmt]))
    out += struct.pack("<Q", 1000)
    rng = np.random.default_rng(0)
    out += rng.integers(0, 256, (n_var + 1) // 2 if type_bits == 4 else n_var,
                        dtype=np.uint8).tobytes()
    out += rng.integers(0, 256, n_var * len_bytes, dtype=np.uint8).tobytes()
    path.write_bytes(bytes(out))


@pytest.mark.parametrize("kind", ["mode2", "general4", "general8", "bad_magic", "truncated"])
def test_describe(tmp_path, fs, kind):
    pgen = tmp_path / "x.pgen"
    if kind == "mode2":
        pgen = f"{fs}.pgen"
    elif kind == "general4":
        _general_pgen(pgen)
    elif kind == "general8":
        _general_pgen(pgen, type_bits=8, len_bytes=3)
    elif kind == "bad_magic":
        pgen.write_bytes(b"\x00\x00\x10" + bytes(20))
    else:
        pgen.write_bytes(b"\x6c\x1b\x10\x05")
    ok = kind.startswith(("mode2", "gen"))
    _, out, err = _both(tmp_path, ["describe", pgen], rc=0 if ok else 1)
    assert (b"variants: 23" in out) == (kind == "mode2")
    assert err.startswith("pgen-tpu: error: ") == (kind in ("bad_magic", "truncated"))


# -- index and view ----------------------------------------------------------


@pytest.fixture
def gz(tmp_path):
    """A .vcf.gz written by the port's filter (BGZF, one member set a block
    of 5 rows), 60 variants on contigs 1 and 2, with its --index .tbi."""
    prefix = _fileset(tmp_path, 60, 6, seed=15)
    out = tmp_path / "in.vcf.gz"
    assert port_main(["filter", prefix, "-o", str(out), "--index", "--block-variants", "5",
                      "--device", "cpu"]) == 0
    return out


@pytest.mark.parametrize("fmt", ["auto", "tbi", "csi"])
def test_index(tmp_path, gz, fmt):
    def prep(o):
        shutil.copy(gz, o / "x.vcf.gz")

    port, _, err = _both(tmp_path, ["index", "{o}/x.vcf.gz", "--index-format", fmt], prep)
    ext = ".csi" if fmt == "csi" else ".tbi"
    assert err == f"wrote {{o}}/x.vcf.gz{ext}\n"
    if ext == ".tbi":  # the scan's index is the one filter --index wrote
        assert (port / "x.vcf.gz.tbi").read_bytes() == Path(f"{gz}.tbi").read_bytes()


@pytest.mark.parametrize("bad", ["plain_gzip", "header_after_rows", "short_row"])
def test_index_refuses(tmp_path, bad):
    """VcfIndexError: exit 1 and one stderr line, equal on both sides."""
    from pgen_tpu_torch.native import native

    text = b"##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\n1\t5\ta\tA\tG\n"
    if bad == "header_after_rows":
        text += b"#late\n"
    elif bad == "short_row":
        text += b"1\t9\tb\n"

    def prep(o):
        if bad == "plain_gzip":
            (o / "x.vcf.gz").write_bytes(gzip.compress(text))
        else:
            data = np.frombuffer(text, dtype=np.uint8)
            (o / "x.vcf.gz").write_bytes(bytes(native.bgzf_compress(data, 6))
                                         + port_filter.BGZF_EOF)

    _, _, err = _both(tmp_path, ["index", "{o}/x.vcf.gz"], prep, rc=1)
    assert err.startswith("pgen-tpu: error: ") and err.count("\n") == 1


@pytest.mark.parametrize("argv", [[], ["-H"], ["-r", "1:200-700"], ["-r", "2", "-H"],
                                  ["-r", "1:300,2:1-5000"], ["-r", "9"]],
                         ids=["all", "no_header", "span", "contig", "two", "absent"])
def test_view(tmp_path, gz, argv):
    _, out, _ = _both(tmp_path, ["view", gz, *argv])
    assert out.count(b"\n") >= (0 if argv[-1:] == ["9"] else 1)


def test_view_without_an_index(tmp_path, gz):
    """VcfViewError when -r has no .tbi/.csi to read."""
    bare = tmp_path / "bare.vcf.gz"
    shutil.copy(gz, bare)
    _, _, err = _both(tmp_path, ["view", bare, "-r", "1"], rc=1)
    assert "no .tbi/.csi index" in err


# -- split, concat, sort, isec ---------------------------------------------------


@pytest.mark.parametrize("how", [["--by-chrom"], ["--parts", "1"], ["--parts", "3"],
                                 ["--parts", "10"]], ids=lambda a: "".join(a))
def test_split_then_concat(tmp_path, fs, how):
    port, _, _ = _both(tmp_path, ["split", fs, *how, "-o", "{o}/sp"])
    parts = sorted({p.name.rsplit(".", 1)[0] for p in port.glob("sp.*.pgen")})
    if how[0] == "--parts":
        (tmp_path / "cat").mkdir()
        assert port_main(["concat", *[str(port / p) for p in parts], "-o",
                          str(tmp_path / "cat" / "c")]) == 0
        for ext in ("pgen", "pvar", "psam"):
            assert (tmp_path / "cat" / f"c.{ext}").read_bytes() == Path(f"{fs}.{ext}").read_bytes()


def test_split_refuses_zero_parts(tmp_path, fs):
    _both(tmp_path, ["split", fs, "--parts", "0", "-o", "{o}/sp"], rc=1)


def _parts(tmp_path, fs, n):
    d = tmp_path / "parts"
    d.mkdir()
    assert port_main(["split", fs, "--parts", str(n), "-o", str(d / "p")]) == 0
    return [d / f"p.part{i + 1}" for i in range(n)]


@pytest.mark.parametrize("n", [1, 2, 3])
def test_concat(tmp_path, fs, n):
    _both(tmp_path, ["concat", *_parts(tmp_path, fs, n), "-o", "{o}/c"])


@pytest.mark.parametrize("bad", ["samples", "iids", "columns"])
def test_concat_refuses(tmp_path, fs, bad):
    """ConcatError: exit 1, one equal stderr line."""
    other = tmp_path / "other"
    other.mkdir()
    if bad == "samples":
        second = _fileset(other, 23, 6, seed=14)
    else:
        second = str(other / "fs")
        for ext in ("pgen", "pvar", "psam"):
            shutil.copy(f"{fs}.{ext}", f"{second}.{ext}")
        if bad == "iids":
            psam = Path(f"{second}.psam")
            psam.write_text(psam.read_text().replace("s3\t", "t3\t"))
        else:
            pvar = Path(f"{second}.pvar")
            pvar.write_text(pvar.read_text().replace("\tINFO\n", "\tINFO\tX\n"))
    _, _, err = _both(tmp_path, ["concat", fs, second, "-o", "{o}/c"], rc=1)
    assert err.startswith("pgen-tpu: error: ")


def _shuffled(tmp_path, fs, seed=3, contig_lines=""):
    """fs with its rows in a seeded order and ##contig lines added."""
    rows = [ln for ln in Path(f"{fs}.pvar").read_text().splitlines(True)
            if not ln.startswith("#")]
    head = [ln for ln in Path(f"{fs}.pvar").read_text().splitlines(True) if ln.startswith("#")]
    perm = np.random.default_rng(seed).permutation(len(rows))
    out = tmp_path / "shuf"
    Path(f"{out}.pvar").write_text(head[0] + contig_lines + "".join(head[1:])
                                   + "".join(rows[i] for i in perm))
    rec = np.fromfile(f"{fs}.pgen", dtype=np.uint8)[12:].reshape(len(rows), -1)
    write_pgen_packed(f"{out}.pgen", rec[perm], 7)
    shutil.copy(f"{fs}.psam", f"{out}.psam")
    return out


@pytest.mark.parametrize("case", ["shuffled", "contig_lines", "sorted"])
def test_sort(tmp_path, fs, case):
    src = fs if case == "sorted" else _shuffled(
        tmp_path, fs, contig_lines="##contig=<ID=2>\n##contig=<ID=1>\n" if case == "contig_lines"
        else "")
    port, _, err = _both(tmp_path, ["sort", src, "-o", "{o}/so"])
    assert ("already sorted" in err) == (case == "sorted")
    if case == "shuffled":  # back to the original records
        assert (port / "so.pgen").read_bytes() == Path(f"{fs}.pgen").read_bytes()


@pytest.mark.parametrize("case", ["sorted", "shuffled"])
def test_sort_check(tmp_path, fs, case):
    src = fs if case == "sorted" else _shuffled(tmp_path, fs)
    _both(tmp_path, ["sort", src, "--check"], rc=0 if case == "sorted" else 1)


@pytest.fixture
def isec_sides(tmp_path, fs):
    """B: rows 5-22 of fs with the POS of two rows moved and the ALT of one
    row changed; C: rows 0-9."""
    lines = Path(f"{fs}.pvar").read_text().splitlines(True)
    head = [ln for ln in lines if ln.startswith("#")]
    rows = [ln for ln in lines if not ln.startswith("#")]
    rec = np.fromfile(f"{fs}.pgen", dtype=np.uint8)[12:].reshape(len(rows), -1)

    def side(name, keep, edit=lambda i, r: r):
        d = tmp_path / name
        d.mkdir()
        Path(f"{d}/s.pvar").write_text("".join(head) + "".join(edit(i, rows[i]) for i in keep))
        write_pgen_packed(f"{d}/s.pgen", rec[keep], 7)
        shutil.copy(f"{fs}.psam", f"{d}/s.psam")
        return f"{d}/s"

    def edit(i, r):
        f = r.split("\t")
        if i in (7, 11):
            f[1] = str(int(f[1]) + 1)
        if i == 15:
            f[4] = "T" if f[4] != "T" else "C"
        return "\t".join(f)

    return fs, side("b", list(range(5, 23)), edit), side("c", list(range(10)))


@pytest.mark.parametrize("argv", [[], ["--key", "pos"], ["--write", "a_only,both_b"],
                                  ["-n", "+2", "C"], ["-n", "=1", "C"], ["-n", "-1", "C"],
                                  ["-n", "~101", "C"], ["-n", "+1"]],
                         ids=["pair", "key_pos", "write", "n+2", "n=1", "n-1", "bitmap", "n2"])
def test_isec(tmp_path, isec_sides, argv):
    a, b, c = isec_sides
    argv = [c if x == "C" else x for x in argv]
    extra = [argv.pop()] if argv[-1:] == [c] else []
    _both(tmp_path, ["isec", a, b, *extra, "-o", "{o}/is", *argv])


@pytest.mark.parametrize("argv", [["C"], ["-n", "~11", "C"], ["--write", "nope"]],
                         ids=["three_without_n", "bitmap_width", "bad_write"])
def test_isec_refuses(tmp_path, isec_sides, argv):
    a, b, c = isec_sides
    argv = [c if x == "C" else x for x in argv]
    extra = [argv.pop()] if argv[-1:] == [c] else []
    _, _, err = _both(tmp_path, ["isec", a, b, *extra, "-o", "{o}/is", *argv], rc=1)
    assert err.startswith("pgen-tpu: error: ")


# -- merge (K1, K4) ------------------------------------------------------------


def _cohort(d, name, n_var, iids, seed, psam_columns="#IID\tSEX"):
    """One cohort over the same n_var variants (the pvar of seed 0), random
    record bytes of its own (pad bits included)."""
    pvar = [f"{1 + (2 * i) // n_var}\t{100 + 7 * i}\trs{i}\tA\tG\t.\tPASS\t." for i in range(n_var)]
    psam = [f"{iid}\tF" if "SEX" in psam_columns else iid for iid in iids]
    prefix = build_fileset(d, name, np.zeros((n_var, len(iids)), np.uint8), pvar, psam,
                           psam_columns=psam_columns)
    rec = (2 * len(iids) + 7) // 8
    write_pgen_packed(f"{prefix}.pgen", np.random.default_rng(seed).integers(
        0, 256, (n_var, rec), dtype=np.uint8), len(iids))
    return prefix


@pytest.mark.parametrize("widths", [(5, 3), (6, 3), (7, 3), (8, 3), (9, 6, 7), (1, 1, 1, 1, 2),
                                    (4,)], ids=lambda w: "-".join(map(str, w)))
def test_merge(tmp_path, widths):
    """Input widths 4k+1, 4k+2, 4k+3 and 4k before a later input shift its
    codes inside the packed byte; the merged records have zero pad bits."""
    prefixes, start = [], 0
    for k, w in enumerate(widths):
        prefixes.append(_cohort(tmp_path, f"c{k}", 21, [f"i{start + j}" for j in range(w)], k))
        start += w
    port, _, err = _both(tmp_path, ["merge", *prefixes, "-o", "{o}/m"])
    assert f"x {start} samples" in err
    assert (port / "m.pgen").stat().st_size == 12 + 21 * ((start + 3) // 4)


def test_merge_heterogeneous_psams(tmp_path):
    a = _cohort(tmp_path, "a", 9, ["x", "y", "z"], 1)
    b = _cohort(tmp_path, "b", 9, ["u", "v"], 2, psam_columns="#IID")
    port, _, _ = _both(tmp_path, ["merge", a, b, "-o", "{o}/m"])
    assert (port / "m.psam").read_text() == "#IID\nx\ny\nz\nu\nv\n"


@pytest.mark.parametrize("bad", ["variants", "rows", "iids"])
def test_merge_refuses(tmp_path, bad):
    """MergeError: exit 1, one equal stderr line, no .pgen written."""
    a = _cohort(tmp_path, "a", 9, ["x", "y"], 1)
    if bad == "variants":
        b = _cohort(tmp_path, "b", 8, ["u"], 2)
    elif bad == "rows":
        b = _cohort(tmp_path, "b", 9, ["u"], 2)
        pvar = Path(f"{b}.pvar")
        pvar.write_text(pvar.read_text().replace("rs3\t", "rs3b\t"))
    else:
        b = _cohort(tmp_path, "b", 9, ["u", "x"], 2)
    port, _, err = _both(tmp_path, ["merge", a, b, "-o", "{o}/m"], rc=1)
    assert err.startswith("pgen-tpu: error: ") and not list(port.iterdir())


# -- diff (K1) -----------------------------------------------------------------


def _diff_sides(tmp_path, swap=None):
    """A and B over 30 variants, B with three rows dropped, a duplicate key
    (its first row counts), its samples reordered with one missing and one
    extra, and a seeded share of its codes changed (some to or from
    missing); with ``swap``, B's rows at those two positions trade places."""
    rng = np.random.default_rng(21)
    n_var, iids_a = 30, [f"p{i}" for i in range(9)]
    codes_a = rng.integers(0, 4, (n_var, 9), dtype=np.uint8)
    pvar = [f"{1 + i // 20}\t{100 + 9 * i}\trs{i}\tA\t{'GCT'[i % 3]}\t.\tPASS\t." for i in range(n_var)]
    a = build_fileset(tmp_path, "a", codes_a, pvar, [f"{s}\tM" for s in iids_a])
    rows_b = [i for i in range(n_var) if i not in (4, 5, 17)]
    if swap:
        rows_b[swap[0]], rows_b[swap[1]] = rows_b[swap[1]], rows_b[swap[0]]
    rows_b.append(9)  # a second B row with row 9's key: the first one counts
    cols_b = [7, 2, 0, 1, 3, 4, 5, 6]  # p8 is not in B; "q" is not in A
    codes_b = codes_a[np.ix_(rows_b, cols_b)]
    codes_b = np.concatenate([codes_b, rng.integers(0, 4, (len(rows_b), 1), dtype=np.uint8)], 1)
    flip = rng.random(codes_b.shape) < 0.15
    codes_b[flip] = (codes_b[flip] + rng.integers(1, 4, flip.sum())) % 4
    b = build_fileset(tmp_path, "b", codes_b, [pvar[i] for i in rows_b],
                      [f"{iids_a[c]}\tM" for c in cols_b] + ["q\tF"])
    return a, b


@pytest.fixture
def diff_sides(tmp_path):
    return _diff_sides(tmp_path)


@pytest.mark.parametrize("argv", [[], ["--key", "pos"], ["--include-missing"], ["--per-sample"],
                                  ["--per-sample", "--include-missing", "--block-variants", "4"],
                                  ["-o", "-"], ["--block-variants", "1"]],
                         ids=["default", "key_pos", "missing", "per_sample", "ragged",
                              "stdout", "one_row_blocks"])
def test_diff(tmp_path, diff_sides, argv):
    a, b = diff_sides
    out = [] if "-o" in argv else ["-o", "{o}/d.pdiff"]
    port, stdout, err = _both(tmp_path, ["diff", a, b, *out, *argv])
    assert "discordant of" in err and " 8 shared samples" in err
    text = stdout if "-o" in argv else (port / "d.pdiff").read_bytes()
    assert text.startswith(b"#CHROM\tPOS\tID\tIID\tGT1\tGT2\n") and text.count(b"\n") > 5


def _pdiff_oracle(a, b):
    """diff's discordant calls with numpy alone: keys CHROM:POS:REF:ALT
    (first occurrence), shared IIDs, half-missing pairs skipped."""
    def side(prefix):
        rows = [ln.split("\t") for ln in Path(f"{prefix}.pvar").read_text().splitlines()
                if not ln.startswith("#")]
        iids = [ln.split("\t")[0] for ln in Path(f"{prefix}.psam").read_text().splitlines()[1:]]
        rec = np.fromfile(f"{prefix}.pgen", np.uint8)[12:].reshape(len(rows), -1)
        codes = (rec[:, np.arange(len(iids)) // 4] >> (2 * (np.arange(len(iids)) % 4))) & 3
        return rows, iids, codes

    (ra, ia, ca), (rb, ib, cb) = side(a), side(b)
    first_b = {}
    for j, r in enumerate(rb):
        first_b.setdefault(tuple(r[k] for k in (0, 1, 3, 4)), j)
    gt = ["0/0", "0/1", "1/1", "./."]
    out, seen = ["#CHROM\tPOS\tID\tIID\tGT1\tGT2\n"], set()
    for i, r in enumerate(ra):
        key = tuple(r[k] for k in (0, 1, 3, 4))
        if key in seen or key not in first_b:
            continue
        seen.add(key)
        j = first_b[key]
        for s, iid in enumerate(ia):
            if iid in ib:
                x, y = ca[i, s], cb[j, ib.index(iid)]
                if x != y and x != 3 and y != 3:
                    out.append(f"{r[0]}\t{r[1]}\t{r[2]}\t{iid}\t{gt[x]}\t{gt[y]}\n")
    return "".join(out)


def test_diff_of_reordered_rows_is_right_where_pgen_tpu_is_not(tmp_path):
    """B's rows 3 and 4 trade places, so the matched B rows of a block are
    [0, 1, 2, 4, 3, 5, ...]: pgen_tpu's row gather (``_gather_rows``) takes
    the slice [0, n) because the block's ends are n - 1 apart, and compares
    A's rows 3 and 6 with the wrong B rows (ROADMAP §3). The port's equals a
    numpy oracle."""
    a, b = _diff_sides(tmp_path, swap=(3, 4))
    want = _pdiff_oracle(a, b)
    assert port_main(["diff", a, b, "-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert tpu_main(["diff", a, b, "-o", str(tmp_path / "tpu")]) == 0
    assert (tmp_path / "port").read_text() == want
    assert (tmp_path / "tpu").read_text() != want


def test_diff_matches_the_oracle(tmp_path, diff_sides):
    assert port_main(["diff", *diff_sides, "-o", str(tmp_path / "d"), "--device", "cpu"]) == 0
    assert (tmp_path / "d").read_text() == _pdiff_oracle(*diff_sides)


def test_sort_of_a_swapped_pair_is_right_where_pgen_tpu_is_not(tmp_path, fs):
    """Rows 1 and 2 trade places: sort's order starts [0, 2, 1, 3, ...] and
    pgen_tpu's row gather reads its block in file order (ROADMAP §3), so its
    .pgen no longer matches its .pvar. The port's sorted fileset is the
    original."""
    lines = Path(f"{fs}.pvar").read_text().splitlines(True)
    head = [ln for ln in lines if ln.startswith("#")]
    rows = [ln for ln in lines if not ln.startswith("#")]
    perm = np.arange(len(rows))
    perm[[1, 2]] = perm[[2, 1]]
    src = tmp_path / "swapped"
    Path(f"{src}.pvar").write_text("".join(head) + "".join(rows[i] for i in perm))
    rec = np.fromfile(f"{fs}.pgen", dtype=np.uint8)[12:].reshape(len(rows), -1)
    write_pgen_packed(f"{src}.pgen", rec[perm], 7)
    shutil.copy(f"{fs}.psam", f"{src}.psam")
    for who, main, extra in (("port", port_main, []), ("tpu", tpu_main, [])):
        assert main(["sort", str(src), "-o", str(tmp_path / who), *extra]) == 0
        assert Path(f"{tmp_path / who}.pvar").read_bytes() == Path(f"{fs}.pvar").read_bytes()
    assert Path(f"{tmp_path / 'port'}.pgen").read_bytes() == Path(f"{fs}.pgen").read_bytes()
    assert Path(f"{tmp_path / 'tpu'}.pgen").read_bytes() != Path(f"{fs}.pgen").read_bytes()


def test_diff_of_a_fileset_with_itself(tmp_path, fs):
    port, _, err = _both(tmp_path, ["diff", fs, fs, "-o", "{o}/d", "--per-sample"])
    assert err.startswith("diff: 0 discordant of")
    assert (port / "d").read_text() == "#CHROM\tPOS\tID\tIID\tGT1\tGT2\n"


# -- annotate (K8, K14) -------------------------------------------------------------


@pytest.fixture
def ann(tmp_path):
    """A fileset with INFO holding AC=, AF= and other fields, two contigs,
    and the mapping and annotation inputs annotate reads."""
    rng = np.random.default_rng(31)
    n_var, n = 26, 11
    codes = rng.integers(0, 4, (n_var, n), dtype=np.uint8)
    infos = ["AC=9;DP=3", ".", "DP=7", "AF=0.5;AC=1", "X"]
    pvar = [f"{'1' if i < 15 else 'chr2'}\t{50 + 5 * i}\tv{i}\tA\tG\t{i}\tPASS\t{infos[i % 5]}"
            for i in range(n_var)]
    prefix = build_fileset(
        tmp_path, "ann", codes, pvar, [f"s{i}\t{'MF'[i % 2]}" for i in range(n)],
        pvar_comments="##fileformat=VCFv4.2\n##contig=<ID=1>\n##contig=<ID=chr2,length=9>\n"
        '##INFO=<ID=AC,Number=A,Type=Integer,Description="x">\n'
        '##INFO=<ID=DP,Number=1,Type=Integer,Description="d">\n')
    (tmp_path / "chrs.txt").write_text("1 chr1\nchr2 2\n")
    (tmp_path / "pairs.txt").write_text("s0 a0\ns5 a5\n")
    (tmp_path / "names.txt").write_text("".join(f"n{i}\n" for i in range(n)))
    (tmp_path / "keep.txt").write_text("s1\ns4\ns9\n")
    src = build_fileset(
        tmp_path, "src", codes[:8], [f"{'1'}\t{50 + 5 * i}\tnew{i}\tA\tG\t.\tPASS\tDP={i};Z=1"
                                     for i in range(0, 16, 2)],
        [f"s{i}\tM" for i in range(n)],
        pvar_comments='##INFO=<ID=DP,Number=1,Type=Integer,Description="src">\n'
        '##INFO=<ID=Z,Number=0,Type=Flag,Description="z">\n')
    return prefix, src


ANNOTATE = {
    "set_id": ["--set-id", 'CHROM + ":" + POS + ":" + REF + ":" + ALT'],
    "rename_chrs": ["--rename-chrs", "{d}/chrs.txt"],
    "rename_then_set_id": ["--rename-chrs", "{d}/chrs.txt", "--set-id", 'CHROM + "_" + POS'],
    "rename_samples_pairs": ["--rename-samples", "{d}/pairs.txt"],
    "rename_samples_names": ["--rename-samples", "{d}/names.txt"],
    "fill_all": ["--fill-info", "all"],
    "fill_ac_an": ["--fill-info", "AC,AN"],
    "fill_samples": ["--fill-info", "AF,MAF,NS,F_MISSING,HWE", "--samples", "s2,s0,s7"],
    "fill_keep": ["--fill-info", "all", "--keep", "{d}/keep.txt"],
    "fill_include_sam": ["--fill-info", "AC,NS", "--include-sam", 'SEX == "F"'],
    "fill_then_set_id": ["--fill-info", "AC", "--set-id", 'ID + "_" + INFO_AC'],
    "annotations_id": ["-a", "SRC"],
    "annotations_info": ["-a", "SRC", "-c", "INFO"],
    "annotations_tag": ["-a", "SRC", "-c", "INFO/DP,INFO/Z", "--fill-info", "AN"],
    "remove": ["-x", "ID,QUAL,INFO/AC"],
    "remove_info": ["-x", "INFO"],
}


@pytest.mark.parametrize("case", list(ANNOTATE))
def test_annotate(tmp_path, ann, case):
    prefix, src = ann
    argv = [str(src) if a == "SRC" else a for a in ANNOTATE[case]]
    port, _, err = _both(tmp_path, ["annotate", prefix, "-o", "{o}/an", *argv])
    assert err.startswith("annotated 26 variants x 11 samples")
    assert (port / "an.pgen").read_bytes() == Path(f"{prefix}.pgen").read_bytes()


@pytest.mark.parametrize("argv", [[], ["--samples", "s1"], ["--fill-info", "AC,XX"],
                                  ["--set-id", "ID", "-x", "NOPE"],
                                  ["--rename-samples", "{d}/chrs.txt"]],
                         ids=["no_action", "samples_alone", "bad_tag", "bad_remove",
                              "unknown_iids"])
def test_annotate_refuses(tmp_path, ann, argv):
    _, _, err = _both(tmp_path, ["annotate", ann[0], "-o", "{o}/an", *argv],
                      rc=0 if "{d}/chrs.txt" in argv else 1)
    assert err.startswith("pgen-tpu: error: ") != ("{d}/chrs.txt" in argv)


# -- export (K1) ------------------------------------------------------------------


@pytest.fixture
def ex(tmp_path):
    """Single-base and indel alleles, a PHENO1 and a FID column."""
    rng = np.random.default_rng(41)
    n_var, n = 17, 10
    codes = rng.integers(0, 4, (n_var, n), dtype=np.uint8)
    refs, alts = ["A", "C", "GT", "T"], ["G", "T", "G", "TAA"]
    pvar = [f"{1 + i // 9}\t{10 + i}\tx{i}\t{refs[i % 4]}\t{alts[i % 4]}\t.\tPASS\t."
            for i in range(n_var)]
    psam = [f"f{i // 3}\ts{i}\t{'12'[i % 2]}\t{['-9', '1.5', '.', '2'][i % 4]}" for i in range(n)]
    return build_fileset(tmp_path, "ex", codes, pvar, psam,
                         psam_columns="#FID\tIID\tSEX\tPHENO1")


EXPORT = {
    "A": ["A", "-o", "{o}/e.raw"],
    "AD": ["AD", "-o", "{o}/e.raw"],
    "A_samples": ["A", "-o", "{o}/e.raw", "--samples", "s9,s2,s4"],
    "AD_query": ["AD", "-o", "{o}/e.raw", "--include-var", 'num(POS) > 13', "--exclude-sam",
                 'SEX == 2'],
    "A_gt_query": ["A", "-o", "{o}/e.raw", "--include-var", "GT_MAF > 0.2", "-r", "1"],
    "A_stdout": ["A", "-o", "-", "--samples", "s1"],
    "ped": ["ped", "-o", "{o}/p"],
    "ped_snps": ["ped", "-o", "{o}/p.ped", "--include-var", 'ALT == "G" || ALT == "T"'],
    "ped_samples": ["ped", "-o", "{o}/p", "--keep", "{d}/keep.txt"],
}


@pytest.mark.parametrize("case", list(EXPORT))
def test_export(tmp_path, ex, case):
    (tmp_path / "keep.txt").write_text("s3\ns0\n")
    _, out, err = _both(tmp_path, ["export", ex, *EXPORT[case]])
    assert err.startswith("export ")
    assert (out.startswith(b"FID\tIID") and out.count(b"\n") == 2) == (case == "A_stdout")


@pytest.mark.parametrize("argv", [["ped", "-o", "-"], ["ped", "-o", "{o}/p", "-r", "2"]],
                         ids=["ped_stdout", "multiallelic"])
def test_export_refuses(tmp_path, ex, argv):
    if argv[-1] == "2":
        pvar = Path(f"{ex}.pvar")
        pvar.write_text(pvar.read_text().replace("\tG\t.\tPASS", "\tG,C\t.\tPASS"))
    _, _, err = _both(tmp_path, ["export", ex, *argv], rc=2 if "-" in argv else 1)
    assert err.startswith("export: error: " if "-" in argv else "pgen-tpu: error: ")


# -- roh (K1) -----------------------------------------------------------------------


@pytest.fixture
def roh_fs(tmp_path):
    """Het-rich background with homozygous runs planted in three samples,
    two contigs, and a missing call inside one run."""
    rng = np.random.default_rng(51)
    n_var, n = 400, 9
    codes = np.where(rng.random((n_var, n)) < 0.5, 1, rng.integers(0, 2, (n_var, n)) * 2)
    for s, lo, hi in ((1, 40, 160), (4, 230, 390), (7, 10, 80), (7, 250, 330)):
        codes[lo:hi, s] = rng.integers(0, 2, hi - lo) * 2
    codes[100, 1] = 3
    codes = codes.astype(np.uint8)
    pvar = [f"{1 + i // 200}\t{(i % 200 + 1) * 10_000}\tr{i}\tA\tG\t.\tPASS\t." for i in range(n_var)]
    return build_fileset(tmp_path, "roh", codes, pvar, [f"s{i}\tM" for i in range(n)])


ROH = {
    "defaults_scaled": [],
    "samples": ["--samples", "s7,s1,s3"],
    "region": ["-r", "1:300000-2000000"],
    "strict": ["--window-het", "0", "--window-missing", "0", "--window-threshold", "0.5"],
    "gap": ["--gap", "50"],
    "blocks": ["--block-variants", "7", "--exclude-var", 'ID == "r20"'],
}


@pytest.mark.parametrize("case", list(ROH))
def test_roh(tmp_path, roh_fs, case):
    argv = ["--window-snp", "20", "--min-snp", "30", "--min-kb", "100", *ROH[case]]
    port, _, err = _both(tmp_path, ["roh", roh_fs, "-o", "{o}/r", *argv])
    n_seg = int(err.split()[1])
    assert n_seg == len((port / "r.hom").read_text().splitlines()) - 1
    assert n_seg >= (1 if case in ("region", "gap") else 3)


# -- filter --rm-dup error|list (ROADMAP §1 item 12 (d)) ---------------------------------


@pytest.mark.parametrize("argv", [["--rm-dup", "error"], ["--rm-dup", "list"],
                                  ["--rm-dup", "error", "--include-var", 'ID != "rs3"'],
                                  ["--rm-dup", "list", "--maf", "0.2", "--samples", "s1,s2,s4"],
                                  ["--rm-dup", "list", "--out-format", "pgen"]],
                         ids=["error", "list", "error_none_kept", "list_gt", "list_pgen"])
def test_rm_dup_report(tmp_path, fs, argv):
    """The report, its exit code and the filter after it equal pgen_tpu's."""
    name = "f" if "pgen" in argv else "f.vcf"
    if "rs3" in " ".join(argv):  # drop every duplicated ID
        argv = ["--rm-dup", "error", "--include-var", "ID != \"rs3\" && "
                "ID != \"rs8\" && ID != \"rs13\" && ID != \"rs18\""]
    port, _, err = _both(tmp_path, ["filter", fs, "-o", f"{{o}}/{name}", *argv],
                         rc=2 if argv == ["--rm-dup", "error"] else 0)
    if argv[1] == "list":
        assert (port / f"{name}.rmdup.list").read_text().splitlines()


def test_rm_dup_is_served():
    from pgen_tpu_torch.cli import _UNSERVED

    assert "rm_dup" not in _UNSERVED


# -- the port's own refusals ---------------------------------------------------------


@pytest.mark.parametrize("command", ["export", "roh", "annotate"])
@pytest.mark.parametrize("provider", ["native", "numpy"])
def test_host_providers_refused(tmp_path, fs, capsys, command, provider):
    argv = [command, fs, "--provider", provider, "-o", tmp_path / "x", "--device", "cpu"]
    if command == "annotate":
        argv += ["--fill-info", "AC"]
    with pytest.raises(SystemExit) as e:
        port_main([str(a) for a in argv])
    assert e.value.code == 2 and "(item 13, done)" in capsys.readouterr().err


@pytest.mark.parametrize("command", CARD_FILES)
def test_cuda_without_a_card_raises(tmp_path, fs, monkeypatch, command):
    """With --device cuda (the default) and no card, exit 1 and nothing
    written: no host codec stands in."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"merge": ["merge", fs, fs], "diff": ["diff", fs, fs],
            "annotate": ["annotate", fs, "--fill-info", "AC"],
            "export": ["export", fs], "roh": ["roh", fs]}[command]
    out = tmp_path / "out"
    out.mkdir()
    rc, stdout, err = _run(port_main, [*argv, "-o", out / "x"])
    assert rc == 1 and not stdout and not list(out.iterdir())
    assert err.startswith("pgen-tpu: error: ") and "is_available" in err and err.count("\n") == 1


def test_annotate_without_fill_info_needs_no_card(tmp_path, fs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_main(["annotate", fs, "--set-id", 'ID + "x"', "-o", str(tmp_path / "a")]) == 0


@pytest.mark.parametrize("command", CARD_FILES + HOST_FILES)
def test_ranks_refused(tmp_path, fs, capsys, monkeypatch, command):
    from test_torch_standalone import ARGV_TABLE

    argv = next(a for a in ARGV_TABLE if a[0] == command)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit) as e:
        port_main(argv)
    assert e.value.code == 2 and "ROADMAP §1 item 17" in capsys.readouterr().err


def test_device_only_on_card_subcommands():
    """--device on the five subcommands with a card stage; the other seven
    parse exactly as pgen_tpu's (test_torch_standalone.py holds them)."""
    from pgen_tpu_torch.cli import build_torch_arg_parser

    sub = next(a for a in build_torch_arg_parser()._actions if hasattr(a, "choices")
               and isinstance(a.choices, dict))
    for command in CARD_FILES + HOST_FILES:
        dests = {a.dest for a in sub.choices[command]._actions}
        assert ("device" in dests) == (command in CARD_FILES), command


# -- the copies ------------------------------------------------------------------------

# whole modules: every top-level function and class
WHOLE = [(tpu_describe, port_describe), (tpu_index, port_index), (tpu_view, port_view),
         (tpu_split, port_split), (tpu_concat, port_concat), (tpu_sort, port_sort),
         (tpu_isec, port_isec), (tpu_roh, port_roh)]
PART = [
    (tpu_merge, port_merge, ["MergeError", "MergeResult", "_psam_lines"]),
    (tpu_diff, port_diff, ["DiffResult", "_first_occurrence_match"]),
    (tpu_export, port_export, ["ExportResult", "_sex_str", "_pheno_str", "_sample_prefixes",
                               "_ped_prefixes"]),
    (tpu_roh_pipeline, port_roh_pipeline, ["RohResult", "_chrom_runs"]),
    (tpu_filter, port_filter, ["duplicated_ids"]),
    (tpu_annotate, port_annotate, [
        n for n, v in vars(tpu_annotate).items()
        if inspect.isfunction(v) and v.__module__ == tpu_annotate.__name__
        and n not in ("fill_info_column", "annotate_pgen")] + ["AnnotateResult"]),
]
COPIED = [(t, p, [n for n, v in vars(t).items()
                  if (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == t.__name__])
          for t, p in WHOLE] + PART
_HOSTS = {"filter_host": "filter", "pgen_out_host": "pgen_out", "vcf_import_host": "vcf_import"}


@pytest.mark.parametrize("name", [f"{t.__name__.split('.', 1)[1]}.{n}"
                                  for t, _, names in COPIED for n in names])
def test_copied_verbatim(name):
    module, attr = name.rsplit(".", 1)
    tpu, port = next((t, p) for t, p, _ in COPIED if t.__name__ == f"pgen_tpu.{module}")
    want = inspect.getsource(getattr(tpu, attr))
    got = inspect.getsource(getattr(port, attr)).replace("pgen_tpu_torch.", "pgen_tpu.")
    for host, mod in _HOSTS.items():
        got = got.replace(f"pipeline.{host} import", f"pipeline.{mod} import")
    assert got == want


@pytest.mark.parametrize("pair", [(tpu_annotate, port_annotate, ["FILL_INFO_TAGS", "_INFO_DECLS"]),
                                  (tpu_export, port_export, ["_TOKENS_A", "_TOKENS_AD"]),
                                  (tpu_isec, port_isec, ["OUTPUTS", "DEFAULT_BLOCK"]),
                                  (tpu_sort, port_sort, ["_SPECIAL_RANK", "DEFAULT_BLOCK"]),
                                  (tpu_merge, port_merge, ["DEFAULT_BLOCK"]),
                                  (tpu_diff, port_diff, ["_GT"])],
                         ids=lambda p: p[0].__name__.rsplit(".", 1)[1])
def test_copied_constants(pair):
    tpu, port, names = pair
    for n in names:
        a, b = getattr(tpu, n), getattr(port, n)
        assert (np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b), n
