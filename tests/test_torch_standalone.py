"""pgen_tpu_torch stands alone: it imports nothing of pgen_tpu, and its
copies of pgen_tpu's jax-free host code give pgen_tpu's results.

- An AST scan: no module of the port, and neither ``chip_smoke.py`` nor
  ``chip_diag.py``, imports pgen_tpu at any level, and no string of those
  two scripts names a pgen_tpu module.
- Each entry point of the port in a subprocess that could import pgen_tpu
  (the repository root on ``sys.path``), after which neither pgen_tpu nor
  jax is loaded.
- Copy parity: the port's chr22 fixture writer, argument parser and C++
  host library against pgen_tpu's (and ``tools/make_fixtures.py``'s).
- The library surface: every name of each pgen_tpu package's ``__all__``
  resolves in the port's counterpart (under the port's name where
  ``pgen_tpu_torch.ops.RENAMES`` lists one), each exported function takes
  pgen_tpu's parameters by name and default with ``device`` after them,
  and importing any of the port's packages loads neither torch nor jax.
"""

import argparse
import ast
import importlib
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import make_fixtures
from pgen_tpu.cli import build_arg_parser as tpu_parser
from pgen_tpu.native import HAVE_NATIVE
from pgen_tpu.native import native as tpu_native
from pgen_tpu_torch.cli_parser import build_arg_parser as port_parser
from pgen_tpu_torch.formats.fixtures import ensure_chr22
from test_torch_filter import _fileset

REPO = Path(__file__).resolve().parent.parent
CHIP_SCRIPTS = [REPO / "chip_smoke.py", REPO / "chip_diag.py"]
PORT_FILES = sorted((REPO / "pgen_tpu_torch").rglob("*.py")) + CHIP_SCRIPTS


def _imports_pgen_tpu(node) -> bool:
    if isinstance(node, ast.Import):
        return any(a.name == "pgen_tpu" or a.name.startswith("pgen_tpu.") for a in node.names)
    if isinstance(node, ast.ImportFrom):
        mod = node.module or ""
        return node.level == 0 and (mod == "pgen_tpu" or mod.startswith("pgen_tpu."))
    return False


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_pgen_tpu(path):
    tree = ast.parse(path.read_text(), str(path))
    bad = [n.lineno for n in ast.walk(tree) if _imports_pgen_tpu(n)]
    assert not bad, f"{path.name} imports pgen_tpu at lines {bad}"
    if path in CHIP_SCRIPTS:
        named = [n.lineno for n in ast.walk(tree)
                 if isinstance(n, ast.Constant) and isinstance(n.value, str)
                 and "pgen_tpu." in n.value]
        assert not named, f"{path.name} names a pgen_tpu module in strings at lines {named}"


def _imports_jax(node) -> bool:
    if isinstance(node, ast.Import):
        return any(a.name.split(".")[0] in ("jax", "jaxlib") for a in node.names)
    if isinstance(node, ast.ImportFrom):
        return node.level == 0 and (node.module or "").split(".")[0] in ("jax", "jaxlib")
    return False


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_jax(path):
    tree = ast.parse(path.read_text(), str(path))
    bad = [n.lineno for n in ast.walk(tree) if _imports_jax(n)]
    assert not bad, f"{path.name} imports jax at lines {bad}"


# -- the library surface ------------------------------------------------------

PACKAGES = ["", ".pipeline", ".parallel", ".ops"]


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: f"pgen_tpu{s}")
def test_pgen_tpu_exports_resolve_in_the_port(sub):
    """Each name of pgen_tpu{sub}.__all__ is an attribute of
    pgen_tpu_torch{sub}, under the port's name where RENAMES lists one;
    the renames name exactly the names the port does not carry."""
    from pgen_tpu_torch.ops import RENAMES

    tpu = importlib.import_module(f"pgen_tpu{sub}")
    port = importlib.import_module(f"pgen_tpu_torch{sub}")
    missing = {n for n in tpu.__all__ if not hasattr(port, n)}
    assert missing == (set(RENAMES) if sub == ".ops" else set())
    for name in tpu.__all__:
        assert getattr(port, RENAMES.get(name, name)) is not None
        assert RENAMES.get(name, name) in port.__all__


def test_renamed_and_moved_exports():
    """K4 is pack_codes, K2 genotype_text (pgen_tpu's planes were a Mosaic
    workaround), and the numpy oracle lives in ops/unpack_host.py."""
    import pgen_tpu_torch.ops as ops
    from pgen_tpu_torch.ops import gt_text, pack, unpack_host

    assert ops.RENAMES == {"pack_codes_device": "pack_codes",
                           "genotype_text_planes": "genotype_text"}
    assert ops.pack_codes is pack.pack_codes
    assert ops.genotype_text is gt_text.genotype_text
    assert ops.unpack_codes_reference is unpack_host.unpack_codes_reference


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: f"pgen_tpu_torch{s}")
def test_every_port_export_resolves(sub):
    port = importlib.import_module(f"pgen_tpu_torch{sub}")
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    with pytest.raises(AttributeError):
        getattr(port, "no_such_name")


# (pgen_tpu module, port module, function): every exported function of
# pgen_tpu's packages, and the distributed API
SIGNATURES = [
    ("pipeline.filter", "pipeline.filter", "filter_to_vcf"),
    ("pipeline.query", "pipeline.query", "query_metadata"),
    ("parallel.shard", "parallel.shard", "filter_to_vcf_sharded"),
    ("parallel.shard", "parallel.shard", "plan_shards"),
    ("formats.header", "formats.header", "read_pgen_header"),
    ("formats.metadata", "formats.metadata", "read_metadata"),
    ("parallel.distributed", "parallel.distributed", "run_distributed_filter"),
    ("parallel.distributed", "parallel.distributed", "initialize_from_env"),
]


@pytest.mark.parametrize("tpu_mod,port_mod,name", SIGNATURES, ids=[s[2] for s in SIGNATURES])
def test_signature_takes_pgen_tpu_parameters(tpu_mod, port_mod, name):
    """pgen_tpu's parameters, in order, by the same names, kinds and
    defaults; the port adds ``device`` alone, after them (before a
    ``**kwargs``, which must stay last)."""
    want = inspect.signature(getattr(importlib.import_module(f"pgen_tpu.{tpu_mod}"), name))
    got = inspect.signature(getattr(importlib.import_module(f"pgen_tpu_torch.{port_mod}"), name))

    def split(sig):
        params = list(sig.parameters.values())
        kw = [p for p in params if p.kind is p.VAR_KEYWORD]
        return [p for p in params if p.kind is not p.VAR_KEYWORD], kw

    (tpu_params, tpu_kw), (port_params, port_kw) = split(want), split(got)
    assert [(p.name, p.kind) for p in port_kw] == [(p.name, p.kind) for p in tpu_kw]
    assert [(p.name, p.default, p.kind) for p in port_params[: len(tpu_params)]] == \
        [(p.name, p.default, p.kind) for p in tpu_params]
    assert [p.name for p in port_params[len(tpu_params):]] in ([], ["device"])


@pytest.mark.parametrize("provider", ["native", "numpy", "nope"])
def test_filter_to_vcf_refuses_host_providers(tmp_path, provider):
    """pgen_tpu's call with its host providers: refused by decision (the
    port's host path is device="cpu"), an unknown one as unknown."""
    from pgen_tpu_torch.pipeline.filter import filter_to_vcf

    prefix = _fileset(tmp_path, 5, 3, seed=1)
    with pytest.raises(ValueError, match="ROADMAP" if provider != "nope" else "unknown"):
        filter_to_vcf(prefix, None, None, tmp_path / "o.vcf", provider, device="cpu")
    assert not (tmp_path / "o.vcf").exists()


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: f"pgen_tpu_torch{s}")
def test_package_import_loads_no_torch(sub):
    """Importing the package (and its parents) in a fresh interpreter loads
    neither torch nor jax nor pgen_tpu."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"import pgen_tpu_torch{sub}\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] in ('torch', 'jax', 'pgen_tpu'))\n"
        "assert not loaded, loaded[:5]\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 0, r.stderr[-2000:]


# -- each entry point in a subprocess --------------------------------------

_CHECK = (
    "loaded = sorted(m for m in sys.modules if m.split('.')[0] in ('pgen_tpu', 'jax'))\n"
    "assert not loaded, f'{{what}} loaded {{loaded[:5]}}'\n"
)

ENTRY_POINTS = {
    "filter_vcf": [["filter", "{p}", "--samples", "s1,s2", "--maf", "0.1", "-o", "{o}.vcf"]],
    "filter_gz_index": [["filter", "{p}", "-o", "{o}.vcf.gz", "--index"]],
    "filter_pgen": [["filter", "{p}", "--out-format", "pgen", "--keep", "{d}/keep.txt",
                     "-o", "{o}.sub"]],
    "import": [["filter", "{p}", "-o", "{o}.vcf"], ["import", "{o}.vcf", "-o", "{o}.imp"]],
    # ROADMAP §1 items 14, 15 and 12 (e)
    "filter_bed": [["filter", "{p}", "--out-format", "bed", "--keep", "{d}/keep.txt",
                    "-o", "{o}.b"]],
    "import_bed": [["filter", "{p}", "--out-format", "bed", "-o", "{o}.b"],
                   ["import", "{o}.b.bed", "-o", "{o}.bi"]],
    "filter_workers": [["filter", "{p}", "--workers", "2", "--samples", "s1,s2", "-o",
                        "{o}.w.vcf"]],
    "filter_shards_threads": [["filter", "{p}", "--shards", "3", "-o", "{o}.s.vcf.gz", "--index"],
                              ["filter", "{p}", "--threads", "2", "--block-variants", "5",
                               "-o", "{o}.t.vcf"]],
    "provider_device": [["filter", "{p}", "--provider", "device", "--maf", "0.1",
                         "--include-var", 'ALT == "G"', "-o", "{o}.dev.vcf"],
                        ["filter", "{p}", "--provider", "device", "-r", "1:100-900",
                         "-o", "{o}.dev.vcf.gz", "--index"]],
    # --provider device's GT_* counts under --shards and --rm-dup list
    "provider_device_shards": [["filter", "{p}", "--provider", "device", "--shards", "2",
                                "--maf", "0.1", "--rm-dup", "list", "--index",
                                "-o", "{o}.ds.vcf.gz"]],
    "glm_linear": [["glm", "{p}", "--pheno", "{d}/ph.tsv", "--pheno-name", "QT", "--covar",
                    "{d}/ph.tsv", "--covar-name", "C1", "--adjust", "-o", "{o}.lin"]],
    "glm_logistic": [["glm", "{p}", "--pheno", "{d}/ph.tsv", "--pheno-name", "CC", "--covar",
                      "{d}/ph.tsv", "--covar-name", "C1", "-o", "{o}.log"]],
    "score": [["score", "{p}", "--score", "{d}/w.tsv", "--center", "-o", "{o}.ss"]],
    "king": [["king", "{p}", "-o", "{o}.kin0"], ["king", "{p}", "--cutoff", "0.05", "-o", "{o}"]],
    "genome": [["genome", "{p}", "--min-pi-hat", "0.0", "-o", "{o}.genome"]],
    "pca": [["pca", "{p}", "-k", "3", "--make-rel", "-o", "{o}.exact"],
            ["pca", "{p}", "-k", "2", "--approx", "-o", "{o}.approx"]],
    "query": [["query", "{p}", "-f", 'ID + " " + str::from(GT_AC)', "-i", "GT_MAF > 0.05"],
              ["query", "{p}", "-s", "-f", 'IID + " " + str::from(GT_NOBS)']],
    **{report: [[report, "{p}", "--samples", "s1,s3,s4,s9", "-o", "{o}"]]
       for report in ("freq", "gcount", "missing", "hardy", "het")},
    "stats": [["stats", "{p}", "--per-sample", "--samples", "s1,s3,s4,s9"]],
    "fst": [["fst", "{p}", "--pheno-name", "SEX", "--report-variants", "-o", "{o}"]],
    "ld": [["ld", "{p}", "--ld-window", "4", "--ld-window-r2", "0", "--samples", "s1,s3,s4,s9",
            "-o", "{o}.ld"]],
    "prune": [["prune", "{p}", "--indep-pairwise", "4", "1", "0.1", "-o", "{o}"]],
    "clump": [["clump", "{p}", "--clump", "{d}/assoc.tsv", "--clump-p1", "0.5", "--clump-r2",
               "0.01", "-o", "{o}.clumps"]],
    # ROADMAP §1 item 13: the card stages with --device cpu, the host-only
    # subcommands as pgen_tpu parses them (no --device)
    "merge": [["merge", "{p}", "-o", "{o}.m"]],
    "diff": [["diff", "{p}", "{p}", "--per-sample", "-o", "{o}.pdiff"]],
    "annotate": [["annotate", "{p}", "--fill-info", "all", "--samples", "s1,s3,s4", "--set-id",
                  'ID + "_" + INFO_AC', "-o", "{o}.an"]],
    "export": [["export", "{p}", "AD", "--include-var", "GT_MAF > 0.1", "-o", "{o}.raw"],
               ["export", "{p}", "ped", "-o", "{o}"]],
    "roh": [["roh", "{p}", "--window-snp", "3", "--min-snp", "3", "--min-kb", "0", "-o", "{o}"]],
    "describe": [["describe", "{p}.pgen"]],
    "index": [["filter", "{p}", "-o", "{o}.vcf.gz"], ["index", "{o}.vcf.gz"]],
    "view": [["filter", "{p}", "-o", "{o}.vcf.gz", "--index"],
             ["view", "{o}.vcf.gz", "-r", "1:100-900"]],
    "split": [["split", "{p}", "--by-chrom", "-o", "{o}.sp"]],
    "concat": [["split", "{p}", "--parts", "2", "-o", "{o}.sp"],
               ["concat", "{o}.sp.part1", "{o}.sp.part2", "-o", "{o}.cat"]],
    "sort": [["sort", "{p}", "-o", "{o}.sorted"]],
    "isec": [["isec", "{p}", "{p}", "-n", "+2", "-o", "{o}.is"]],
}
# the subcommands that parse no --device (cli.HOST_FILES)
HOST_ONLY = ("describe", "index", "view", "split", "concat", "sort", "isec")


@pytest.fixture(scope="module")
def fileset(tmp_path_factory):
    d = tmp_path_factory.mktemp("standalone")
    prefix = _fileset(d, 12, 20, seed=12)
    rng = np.random.default_rng(12)
    (d / "ph.tsv").write_text("#IID\tQT\tCC\tC1\n" + "".join(
        f"s{i}\t{rng.normal():.5g}\t{1 + i % 2}\t{rng.normal():.5g}\n" for i in range(20)))
    (d / "w.tsv").write_text("".join(f"rs{i}\tA\t{rng.normal():.4g}\n" for i in range(8)))
    (d / "keep.txt").write_text("s3\ns1\ns7\n")
    (d / "assoc.tsv").write_text("#ID\tP\n" + "".join(f"rs{i}\t{0.01 * (i + 1)}\n"
                                                       for i in range(12)))
    return d, prefix


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_point_loads_no_pgen_tpu(fileset, tmp_path, entry):
    """The port's CLI on the CPU with the repository root on sys.path, so
    that a stray (even lazy) import of pgen_tpu would succeed and be seen."""
    d, prefix = fileset
    out = tmp_path / "o"
    runs = [[a.format(p=prefix, o=out, d=d) for a in argv]
            + ([] if argv[0] in HOST_ONLY else ["--device", "cpu"])
            for argv in ENTRY_POINTS[entry]]
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from pgen_tpu_torch.cli import main\n"
        + _CHECK.format(what="importing the port's CLI")
        + "".join(f"assert main({argv!r}) == 0\n" for argv in runs)
        + _CHECK.format(what=entry)
    )
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "WORLD_SIZE", "RANK")}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert all(p.stat().st_size > 0 for p in tmp_path.iterdir())


# -- copy parity ------------------------------------------------------------

@pytest.mark.parametrize("uniform_bytes", [False, True])
@pytest.mark.parametrize("num_samples", [2504, 37])
def test_fixture_writer_matches_make_fixtures(tmp_path, monkeypatch, uniform_bytes, num_samples):
    """ensure_chr22's copy writes the bytes tools/make_fixtures.py writes,
    when no reference .psam is installed for the source to copy."""
    monkeypatch.setattr(make_fixtures, "REFERENCE_DATA", tmp_path / "no_reference")
    kw = dict(num_variants=3001, num_samples=num_samples, seed=5, uniform_bytes=uniform_bytes)
    want = make_fixtures.ensure_chr22(out_dir=tmp_path / "tools", **kw)
    got = ensure_chr22(tmp_path / "port", **kw)
    for ext in ("pgen", "pvar", "psam"):
        assert Path(f"{got}.{ext}").read_bytes() == Path(f"{want}.{ext}").read_bytes(), ext
    # a second call with other parameters rewrites, with the same ones reuses
    assert ensure_chr22(tmp_path / "port", **kw) == got
    ensure_chr22(tmp_path / "port", **{**kw, "num_variants": 10})
    assert Path(f"{got}.pvar").read_text().count("\n") == 10 + 4


ARGV_TABLE = [
    ["query", "P", "-f", "ID", "-i", 'ALT == "G"', "-s"],
    ["filter", "P"],
    ["filter", "P", "--include-var", "POS > 5", "--include-sam", 'IID != "a"', "-o", "o.vcf.gz",
     "--index", "--index-format", "csi", "--provider", "device", "--block-variants", "17",
     "--stats", "--profile", "prof"],
    ["filter", "P", "--keep", "k.txt", "--remove", "r.txt", "-r", "22:1-5", "-R", "reg.txt",
     "--exclude-var", "ALT == \"C\"", "--exclude-sam", "SEX == 1", "--samples", "a,b",
     "--samples-file", "s.txt", "--extract", "e.txt", "--exclude-ids", "x.txt"],
    ["filter", "P", "--maf", "0.01", "--max-maf", "0.4", "--geno", "0.1", "--hwe", "1e-6",
     "--hwe-midp", "--mind", "0.2", "--rm-dup", "exclude-all", "--out-format", "pgen",
     "--workers", "3", "--shards", "4", "--shard-index", "1", "--resume", "--threads", "2"],
    ["stats", "P"], ["freq", "P"], ["missing", "P"], ["hardy", "P"], ["het", "P"],
    ["gcount", "P"], ["fst", "P"], ["king", "P"], ["genome", "P"], ["pca", "P"],
    ["score", "P", "--score", "w.tsv", "--score-col-nums", "3-5", "--score-sums",
     "--no-mean-imputation", "--center", "--q-score-range", "r.txt", "d.txt", "-o", "-"],
    ["score", "P", "--score", "w.tsv", "--variance-standardize", "--header-row", "yes"],
    ["glm", "P", "--pheno", "p.tsv", "--pheno-name", "QT,CC", "--covar", "c.tsv",
     "--covar-name", "C1,C2", "--covar-variance-standardize", "--adjust", "-o", "g"],
    ["glm", "P", "--pheno-name", "QT", "--modifier", "hethom", "--interaction", "--firth",
     "--condition", "rs1", "--condition-list", "c.txt", "--provider", "numpy"],
    ["clump", "P", "--clump", "a.assoc"], ["roh", "P"], ["export", "P", "ped", "-o", "x"],
    ["import", "x.vcf.gz", "-o", "imp"], ["import", "x.bed", "--provider", "numpy"],
    ["concat", "a", "b", "-o", "c"], ["split", "P", "--parts", "2", "-o", "s"], ["merge", "a", "b", "-o", "m"],
    ["prune", "P", "--indep-pairwise", "50", "5", "0.2"], ["ld", "P"],
    ["isec", "a", "b", "-o", "i"], ["diff", "a", "b"], ["sort", "P"], ["annotate", "P"],
    ["index", "x.vcf.gz"], ["view", "x.vcf.gz"], ["describe", "x.pgen"],
]


def test_argv_table_covers_every_subcommand():
    sub = next(a for a in port_parser()._actions if isinstance(a, argparse._SubParsersAction))
    assert set(sub.choices) == {argv[0] for argv in ARGV_TABLE}


@pytest.mark.parametrize("argv", ARGV_TABLE, ids=lambda a: " ".join(a[:3]))
def test_parser_matches_pgen_tpu(argv):
    assert vars(port_parser().parse_args(argv)) == vars(tpu_parser().parse_args(argv))


@pytest.mark.parametrize("argv", [["--version"], ["filter"], ["glm", "P", "--modifier", "x"],
                                  ["nosuch", "P"]])
def test_parser_refuses_and_reports_as_pgen_tpu(argv, capsys):
    out = []
    for build in (tpu_parser, port_parser):
        with pytest.raises(SystemExit) as e:
            build().parse_args(argv)
        out.append((e.value.code, capsys.readouterr()))
    assert out[0] == out[1]


@pytest.mark.skipif(not HAVE_NATIVE, reason="needs pgen_tpu's C++ runtime to compare with")
@pytest.mark.parametrize("n_var,gt_len", [(1, 0), (7, 4), (300, 4 * 2503), (1000, 8)])
def test_native_library_matches_pgen_tpu(n_var, gt_len):
    """assemble_rows_buf and bgzf_compress of the port's build of its copy
    of pgen_native.cpp give the bytes pgen_tpu's build gives."""
    from pgen_tpu_torch.native import HAVE_NATIVE as PORT_NATIVE
    from pgen_tpu_torch.native import native as port_native

    assert PORT_NATIVE and port_native is not tpu_native
    rng = np.random.default_rng(n_var + gt_len)
    text = rng.integers(0, 256, (n_var, gt_len), dtype=np.uint8)
    lens = rng.integers(5, 60, n_var)
    prefix_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    prefix_buf = rng.integers(32, 127, int(prefix_off[-1]), dtype=np.uint8)
    outs = []
    for lib in (tpu_native, port_native):
        out = np.zeros(int(prefix_off[-1]) + n_var * (gt_len + 1) + 8, dtype=np.uint8)
        n = lib.assemble_rows_buf(text, prefix_buf, prefix_off, out)
        outs.append(out[:n])
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].size == int(prefix_off[-1]) + n_var * (gt_len + 1)
    for level in (1, 6):
        np.testing.assert_array_equal(port_native.bgzf_compress(outs[0], level),
                                      tpu_native.bgzf_compress(outs[0], level))
