"""The port's filter (pgen_tpu_torch.pipeline.filter, pgen_tpu_torch.cli)
against pgen_tpu's, byte for byte.

Filesets are synthesized from a seed (conftest.build_fileset, then random
record bytes, pad bits included). The port runs with device="cpu", where
the kernels' plain PyTorch versions make the text; pgen_tpu runs its numpy
provider and its device provider (JAX on the CPU).
"""

import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import build_fileset
from pgen_tpu.cli import main as tpu_main
from pgen_tpu.formats.writer import write_pgen_packed
from pgen_tpu.native import HAVE_NATIVE
from pgen_tpu.pipeline.filter import filter_to_vcf as tpu_filter
from pgen_tpu_torch.cli import main as port_main
from pgen_tpu_torch.pipeline.filter import filter_to_vcf as port_filter

REPO = Path(__file__).resolve().parent.parent


def _fileset(dirpath, n_var, n_samples, seed, name="fs"):
    """n_var variants on contigs 1 and 2, every fifth ID a duplicate of the
    one before, ALT cycling G/C/T; records are random bytes."""
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.integers(1, 60, n_var)) + 100
    alts = "GCT"
    pvar = [
        f"{1 + (2 * i) // n_var}\t{pos[i]}\trs{i - (i % 5 == 4)}\tA\t{alts[i % 3]}\t.\tPASS\tAF=0.{i}"
        for i in range(n_var)
    ]
    psam = [f"s{i}\t{'F' if i % 2 else 'M'}" for i in range(n_samples)]
    codes = np.zeros((n_var, n_samples), dtype=np.uint8)
    prefix = build_fileset(dirpath, name, codes, pvar, psam)
    rec = (2 * n_samples + 7) // 8
    write_pgen_packed(
        f"{prefix}.pgen", rng.integers(0, 256, (n_var, rec), dtype=np.uint8), n_samples
    )
    return prefix


def _read(path):
    with open(path, "rb") as f:
        return f.read()


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


@pytest.mark.parametrize("provider", ["numpy", "device"])
@pytest.mark.parametrize("n_samples", [5, 6, 7, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_filter_matches_pgen_tpu(tmp_path, case, n_samples, provider):
    prefix = _fileset(tmp_path, 23, n_samples, seed=n_samples)
    kw = CASES[case]
    want = tpu_filter(prefix, out_file=tmp_path / "tpu.vcf", provider=provider, **kw)
    got = port_filter(prefix, out_file=tmp_path / "port.vcf", device="cpu", **kw)
    assert _read(tmp_path / "port.vcf") == _read(tmp_path / "tpu.vcf")
    assert (got.num_variants_kept, got.num_samples_kept, got.bytes_written) == (
        want.num_variants_kept,
        want.num_samples_kept,
        want.bytes_written,
    )


@pytest.mark.parametrize("provider", ["numpy", "device"])
@pytest.mark.parametrize("case", ["keep_all", "sample_subset"])
def test_filter_matches_pgen_tpu_wide(tmp_path, case, provider):
    prefix = _fileset(tmp_path, 9, 2503, seed=2503)
    kw = CASES[case]
    tpu_filter(prefix, out_file=tmp_path / "tpu.vcf", provider=provider, **kw)
    port_filter(prefix, out_file=tmp_path / "port.vcf", device="cpu", **kw)
    assert _read(tmp_path / "port.vcf") == _read(tmp_path / "tpu.vcf")


@pytest.mark.skipif(not HAVE_NATIVE, reason="BGZF output needs the C++ runtime")
@pytest.mark.parametrize("provider", ["numpy", "device"])
@pytest.mark.parametrize("case", ["keep_all", "ragged_blocks_subset", "empty_variants"])
def test_bgzf_and_index_match_pgen_tpu(tmp_path, case, provider):
    prefix = _fileset(tmp_path, 40, 7, seed=40)
    kw = CASES[case]
    tpu_filter(prefix, out_file=tmp_path / "tpu.vcf.gz", provider=provider, index=True, **kw)
    port_filter(prefix, out_file=tmp_path / "port.vcf.gz", device="cpu", index=True, **kw)
    assert _read(tmp_path / "port.vcf.gz") == _read(tmp_path / "tpu.vcf.gz")
    assert _read(tmp_path / "port.vcf.gz.tbi") == _read(tmp_path / "tpu.vcf.gz.tbi")


def test_fifo_output_matches(tmp_path):
    """A non-regular output takes the fd sink instead of the memory map."""
    import threading

    prefix = _fileset(tmp_path, 30, 6, seed=30)
    tpu_filter(prefix, out_file=tmp_path / "tpu.vcf", provider="numpy", block_variants=8)
    fifo = tmp_path / "out.fifo"
    os.mkfifo(fifo)
    chunks = []
    reader = threading.Thread(target=lambda: chunks.append(_read(fifo)))
    reader.start()
    port_filter(prefix, out_file=fifo, device="cpu", block_variants=8)
    reader.join(timeout=60)
    assert not reader.is_alive()
    assert chunks == [_read(tmp_path / "tpu.vcf")]


def test_default_output_name(tmp_path):
    prefix = _fileset(tmp_path, 6, 5, seed=6)
    res = port_filter(prefix, device="cpu")
    assert res.out_path == f"{prefix}.pgen-rs.vcf"
    tpu_filter(prefix, out_file=tmp_path / "tpu.vcf", provider="numpy")
    assert _read(res.out_path) == _read(tmp_path / "tpu.vcf")


@pytest.mark.parametrize(
    "argv",
    [
        ["-r", "1:150-600"],
        ["--samples", "s5,s1"],
        ["--exclude-var", 'ALT == "G"'],
        ["--rm-dup", "force-first"],
        ["-r", "2", "--samples", "^s0", "--rm-dup", "exclude-all", "--block-variants", "4"],
        ["--maf", "0.35"],
        ["--max-maf", "0.45", "--geno", "0.34"],
        ["--hwe", "0.3"],
        ["--hwe", "0.3", "--hwe-midp"],
        ["--mind", "0.25"],
        ["--keep", "{dir}/keep.txt"],
        ["--remove", "{dir}/keep.txt", "--maf", "0.3"],
        ["--extract", "{dir}/ids.txt"],
        ["--exclude-ids", "{dir}/ids.txt", "--rm-dup", "force-first"],
    ],
    ids=[
        "regions", "samples", "exclude", "rm_dup_force_first", "combined", "maf",
        "max_maf_geno", "hwe", "hwe_midp", "mind", "keep", "remove_maf", "extract",
        "exclude_ids_rm_dup",
    ],
)
def test_cli_matches_pgen_tpu(tmp_path, argv):
    prefix = _fileset(tmp_path, 31, 6, seed=31)
    (tmp_path / "keep.txt").write_text("s4\ns1\nFAM s3\n")
    (tmp_path / "ids.txt").write_text("rs2\nrs3\nrs17\nrs30\n")
    argv = [arg.format(dir=tmp_path) for arg in argv]
    a, b = tmp_path / "port.vcf", tmp_path / "tpu.vcf"
    assert port_main(["filter", prefix, *argv, "--device", "cpu", "-o", str(a)]) == 0
    assert tpu_main(["filter", prefix, *argv, "-o", str(b)]) == 0
    assert _read(a) == _read(b)


@pytest.mark.parametrize("threads", [1, 2, 3, 4])
@pytest.mark.parametrize("case", ["keep_all", "sample_subset", "both_subsets"])
def test_threads_match_pgen_tpu(tmp_path, case, threads):
    """emit_threads (--threads): T host threads emit disjoint blocks into the
    mapped output, the bytes of pgen_tpu's filter at the same T; each
    block's stages are counted once, and one emit stage spans the threads."""
    prefix = _fileset(tmp_path, 37, 7, seed=37 + threads)
    kw = {**CASES[case], "block_variants": 5}
    tpu_filter(prefix, out_file=tmp_path / "tpu.vcf", provider="numpy", emit_threads=threads,
               **kw)
    got = port_filter(prefix, out_file=tmp_path / "port.vcf", device="cpu",
                      emit_threads=threads, **kw)
    assert _read(tmp_path / "port.vcf") == _read(tmp_path / "tpu.vcf")
    blocks = -(-got.num_variants_kept // 5)
    stages = got.timer.stages
    assert stages["gather"].calls == stages["kernel"].calls == stages["assemble"].calls == blocks
    assert ("emit" in stages) == (threads > 1)


@pytest.mark.parametrize("threads", [2, 4])
def test_threads_leave_stream_outputs_to_one_loop(tmp_path, threads):
    """--threads applies to the mapped output only, as in pgen_tpu: a
    .vcf.gz (and -o -) keeps its one ordered loop, with no emit stage."""
    prefix = _fileset(tmp_path, 37, 7, seed=5)
    argv = ["filter", prefix, "--block-variants", "5", "--threads", str(threads)]
    assert port_main([*argv, "--device", "cpu", "-o", str(tmp_path / "port.vcf.gz"),
                      "--index"]) == 0
    assert tpu_main([*argv, "-o", str(tmp_path / "tpu.vcf.gz"), "--index"]) == 0
    for suf in ("", ".tbi"):
        assert _read(f"{tmp_path}/port.vcf.gz{suf}") == _read(f"{tmp_path}/tpu.vcf.gz{suf}")
    got = port_filter(prefix, out_file=tmp_path / "x.vcf.gz", device="cpu",
                      emit_threads=threads, block_variants=5)
    assert "emit" not in got.timer.stages


def test_launch_counts_stay_exact_under_threads(monkeypatch):
    """kernels.launch counts under a lock: 16 threads (more than the cores
    here) launching at a shortened switch interval lose no count, though
    reading the count yields to the other threads (a read-modify-write
    without the lock loses updates so). The library and the CUDA stream
    are stand-ins; only the count is tested."""
    import threading
    import time
    import types

    from pgen_tpu_torch import kernels

    lib = types.SimpleNamespace(pgen_fake=lambda *args: 0)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))

    class Wrapper:
        __name__ = "fake_kernel"
        count = 0

        @property
        def launches(self):
            n = self.count
            time.sleep(0)
            return n

        @launches.setter
        def launches(self, n):
            self.count = n

    wrapper = Wrapper()
    t = torch.zeros(1)
    threads = [threading.Thread(target=lambda: [kernels.launch(wrapper, "pgen_fake", t)
                                                for _ in range(500)]) for _ in range(16)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert wrapper.count == 16 * 500


def _port_cli_in_subprocess(argv: list, cwd, env: dict | None = None, timeout: float = 240,
                            before: str = "") -> subprocess.CompletedProcess:
    """The port's CLI ``main(argv)`` in a fresh interpreter (``python -c``,
    the repository first on sys.path; ``before`` runs ahead of it), under
    ``timeout`` seconds: how the tests run a path that starts processes, so
    that a hung worker fails its test instead of holding the suite."""
    code = (f"import sys\nsys.path.insert(0, {str(REPO)!r})\n{before}"
            f"from pgen_tpu_torch.cli import main\nsys.exit(main({argv!r}))\n")
    env = {k: v for k, v in {**os.environ, **(env or {})}.items()
           if k not in ("PYTHONPATH", "WORLD_SIZE", "RANK")}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _outputs(d: Path, stem: str) -> dict:
    """Suffix -> bytes of every file named ``stem`` plus a suffix in d."""
    return {p.name[len(stem):]: p.read_bytes() for p in d.iterdir() if p.name.startswith(stem)}


@pytest.mark.parametrize(
    "argv",
    [
        ["filter", "{prefix}", "--workers", "2"],
        ["filter", "{prefix}", "--shards", "2"],
        ["filter", "{prefix}", "--out-format", "bed"],
        ["filter", "{prefix}", "--provider", "native"],
        ["filter", "{prefix}", "--resume"],
        ["filter", "{prefix}", "--threads", "2"],
        ["import", "{prefix}.bed"],
        ["import", "{dir}/in.vcf", "--provider", "native"],
    ],
)
def test_cli_refuses_unserved_flags_naming_roadmap(tmp_path, capsys, argv):
    """Of the flags and inputs this test once refused, only pgen_tpu's host
    providers (--provider native|numpy) stay refused, with exit 2 naming
    ROADMAP. --workers, --shards, --out-format bed, --resume, --threads
    (ROADMAP §1 items 14, 15, 12 (e)) and import X.bed are served: each
    writes pgen_tpu's files (--workers in a subprocess, under a timeout)."""
    prefix = _fileset(tmp_path, 4, 4, seed=4)
    (tmp_path / "in.vcf").write_text("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts0\n")
    argv = [arg.format(prefix=prefix, dir=tmp_path) for arg in argv]
    if "native" in argv:
        with pytest.raises(SystemExit) as e:
            port_main([*argv, "--device", "cpu", "-o", str(tmp_path / "x.vcf")])
        assert e.value.code == 2
        assert "ROADMAP" in capsys.readouterr().err
        assert not list(tmp_path.glob("x.vcf*"))
        return
    if argv[0] == "import":
        assert tpu_main(["filter", prefix, "--out-format", "bed", "-o", prefix]) == 0
    port_argv = [*argv, "--device", "cpu", "-o", str(tmp_path / "port.vcf")]
    if "--workers" in argv:
        r = _port_cli_in_subprocess(port_argv, tmp_path)
        assert r.returncode == 0, r.stderr[-3000:]
    else:
        assert port_main(port_argv) == 0
    assert tpu_main([*argv, "-o", str(tmp_path / "tpu.vcf")]) == 0
    got, want = _outputs(tmp_path, "port.vcf"), _outputs(tmp_path, "tpu.vcf")
    assert got == want and got


@pytest.mark.parametrize("provider", ["auto", "device"])
def test_cli_profile_writes_a_trace(tmp_path, provider):
    """--profile DIR: a torch.profiler Chrome trace of the run, named by
    rank, beside the same output as without it."""
    prefix = _fileset(tmp_path, 9, 6, seed=9)
    argv = ["filter", prefix, "--samples", "s1,s4", "--provider", provider, "--device", "cpu"]
    assert port_main([*argv, "--profile", str(tmp_path / "prof"), "-o", str(tmp_path / "a.vcf")]) == 0
    assert port_main([*argv, "-o", str(tmp_path / "b.vcf")]) == 0
    assert _read(tmp_path / "a.vcf") == _read(tmp_path / "b.vcf")
    trace = json.loads((tmp_path / "prof" / "rank0.trace.json").read_text())
    assert any(e.get("cat") == "cpu_op" for e in trace["traceEvents"])


def test_cli_refuses_other_subcommands(tmp_path, capsys):
    """Every subcommand of pgen_tpu is served since ROADMAP §1 item 13
    landed (describe was the last one this test refused): a name the parser
    does not know exits 2 with argparse's own line, as pgen_tpu's does."""
    prefix = _fileset(tmp_path, 4, 4, seed=4)
    assert port_main(["describe", f"{prefix}.pgen"]) == 0
    assert "variants: 4\n" in capsys.readouterr().out
    out = []
    for main in (port_main, tpu_main):
        with pytest.raises(SystemExit) as e:
            main(["nosuch", f"{prefix}.pgen"])
        out.append((e.value.code, capsys.readouterr().err.rsplit(" error: ", 1)[1]))
    assert out[0] == out[1] and out[0][0] == 2 and "invalid choice: 'nosuch'" in out[0][1]


def test_cuda_without_a_card_raises(tmp_path, monkeypatch, capsys):
    prefix = _fileset(tmp_path, 4, 4, seed=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x.vcf"
    with pytest.raises(RuntimeError, match="is_available"):
        port_filter(prefix, out_file=out, device="cuda")
    # --device defaults to cuda; the CLI fails fast with one stderr line
    assert port_main(["filter", prefix, "-o", str(out)]) == 1
    err = capsys.readouterr().err
    assert err.startswith("pgen-tpu: error: ") and "is_available" in err and err.count("\n") == 1
    assert not out.exists()


def _closed_pipe_run(module: str, argv: list) -> tuple:
    """``python -m module argv`` with stdout a pipe whose read end is closed;
    (exit code, stderr)."""
    r, w = os.pipe()
    os.close(r)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    try:
        p = subprocess.run([sys.executable, "-m", module, *argv], stdout=w, env=env,
                           stderr=subprocess.PIPE, text=True, timeout=300)
    finally:
        os.close(w)
    return p.returncode, p.stderr


CLI_ERRORS = {
    "parse_error": ["filter", "{prefix}", "--include-var", "POS >", "-o", "{dir}/x.vcf"],
    "missing_fileset": ["filter", "{dir}/none", "-o", "{dir}/x.vcf"],
    "stdout_pgen": ["filter", "{prefix}", "--out-format", "pgen", "-o", "-"],
    "stdout_provider_device": ["filter", "{prefix}", "--provider", "device", "-o", "-"],
    "stdout_workers": ["filter", "{prefix}", "--workers", "2", "-o", "-"],
    "stdout_shards": ["filter", "{prefix}", "--shards", "2", "-o", "-"],
    "index_shard_index": ["filter", "{prefix}", "--index", "--shards", "2", "--shard-index", "0",
                          "-o", "{dir}/x.vcf.gz"],
    "index_without_gz": ["filter", "{prefix}", "--index", "-o", "{dir}/x.vcf"],
    "index_pgen": ["filter", "{prefix}", "--index", "--out-format", "pgen", "-o", "{dir}/x.vcf.gz"],
    "hwe_midp_without_hwe": ["filter", "{prefix}", "--hwe-midp", "-o", "{dir}/x.vcf"],
    "missing_keep_file": ["glm", "{prefix}", "--pheno-name", "QT", "--samples-file", "{dir}/none.txt"],
    "glm_stdout_two_phenotypes": ["glm", "{prefix}", "--pheno-name", "A,B", "-o", "-"],
    "closed_stdout_pipe": ["filter", "{prefix}", "-o", "-"],
}


@pytest.mark.parametrize("case", list(CLI_ERRORS))
def test_cli_exits_as_pgen_tpu(tmp_path, capsys, case):
    """The port's exit code and its stderr equal pgen_tpu.cli.main's: one
    ``pgen-tpu: error: ...`` line and 1 for an exception (a query that does
    not parse, a missing fileset, pgen_tpu's ValueError checks), its
    ``filter: error:`` / ``glm: error:`` lines and 2, and 141 with nothing on
    stderr when stdout is a closed pipe."""
    prefix = _fileset(tmp_path, 12, 6, seed=12)
    argv = [a.format(prefix=prefix, dir=tmp_path) for a in CLI_ERRORS[case]]
    if case == "closed_stdout_pipe":
        got = _closed_pipe_run("pgen_tpu_torch.cli", [*argv, "--device", "cpu"])
        assert got == _closed_pipe_run("pgen_tpu.cli", argv) == (141, "")
        return
    rc = port_main([*argv, "--device", "cpu"])
    err = capsys.readouterr().err
    assert tpu_main(argv) == rc
    assert capsys.readouterr().err == err
    assert rc == (2 if case in ("hwe_midp_without_hwe", "glm_stdout_two_phenotypes") else 1)
    assert err.count("\n") == 1 and "Traceback" not in err
    assert err.startswith("pgen-tpu: error: " if rc == 1 else f"{argv[0]}: error: ")
    assert not list(tmp_path.glob("x.vcf*"))


def test_port_never_loads_jax(tmp_path):
    """Importing the port and running a filter to VCF (GT_* sugar included),
    a filter to a pgen fileset, an import of the VCF, two filters with
    --provider device (--maf's K8 counts, a device-lowered predicate), a
    linear and a logistic glm and two scores keeps jax, and pgen_tpu, out of
    the process, though the repository root is on its path. A subprocess,
    since this test process has both."""
    prefix = _fileset(tmp_path, 12, 20, seed=12)
    rng = np.random.default_rng(12)
    (tmp_path / "ph.tsv").write_text("#IID\tQT\tCC\tC1\n" + "".join(
        f"s{i}\t{rng.normal():.5g}\t{1 + i % 2}\t{rng.normal():.5g}\n" for i in range(20)))
    (tmp_path / "w.tsv").write_text("".join(f"rs{i}\tA\t{rng.normal():.4g}\n" for i in range(8)))
    code = (
        "import sys\n"
        "def clean(what):\n"
        "    loaded = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'pgen_tpu'))\n"
        "    assert not loaded, f'{what} loaded {loaded[:5]}'\n"
        "import pgen_tpu_torch, pgen_tpu_torch.pipeline.filter, pgen_tpu_torch.cli\n"
        "import pgen_tpu_torch.pipeline.pgen_out, pgen_tpu_torch.pipeline.vcf_import\n"
        "import pgen_tpu_torch.ops.pack, pgen_tpu_torch.kernels, pgen_tpu_torch.device\n"
        "import pgen_tpu_torch.pipeline.mesh_filter, pgen_tpu_torch.ops.gt_stats\n"
        "clean('import')\n"
        "from pgen_tpu_torch.cli import main\n"
        "prefix, out = sys.argv[1:]\n"
        "assert main(['filter', prefix, '--device', 'cpu', '--maf', '0.1',\n"
        "             '--samples', 's1,s2', '-o', out + '.vcf']) == 0\n"
        "clean('filter')\n"
        "assert main(['filter', prefix, '--out-format', 'pgen', '--device', 'cpu',\n"
        "             '--samples', 's1,s2,s5', '-o', out + '.sub']) == 0\n"
        "clean('filter --out-format pgen')\n"
        "assert main(['import', out + '.vcf', '-o', out + '.imp', '--device', 'cpu']) == 0\n"
        "clean('import')\n"
        "assert main(['filter', prefix, '--provider', 'device', '--device', 'cpu', '--maf', '0.1',\n"
        "             '--include-var', 'ALT == \"G\"', '-o', out + '.dev.vcf']) == 0\n"
        "assert main(['filter', prefix, '--provider', 'device', '--device', 'cpu',\n"
        "             '--include-var', 'ALT != \"C\"', '-o', out + '.low.vcf']) == 0\n"
        "clean('filter --provider device')\n"
        "ph = prefix.rsplit('/', 1)[0] + '/ph.tsv'\n"
        "for pheno in ('QT', 'CC'):\n"
        "    assert main(['glm', prefix, '--pheno', ph, '--pheno-name', pheno, '--covar', ph,\n"
        "                 '--covar-name', 'C1', '--device', 'cpu', '-o', out + '.' + pheno]) == 0\n"
        "clean('glm')\n"
        "w = prefix.rsplit('/', 1)[0] + '/w.tsv'\n"
        "assert main(['score', prefix, '--score', w, '--device', 'cpu', '-o', out + '.ss']) == 0\n"
        "assert main(['score', prefix, '--score', w, '--no-mean-imputation', '--samples',\n"
        "             's1,s4,s7', '--device', 'cpu', '-o', out + '.nm']) == 0\n"
        "clean('score')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run(
        [sys.executable, "-c", code, prefix, str(tmp_path / "o")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    for name in ("o.vcf", "o.sub.pgen", "o.imp.pgen", "o.dev.vcf", "o.low.vcf", "o.QT", "o.CC",
                 "o.ss", "o.nm"):
        assert (tmp_path / name).stat().st_size > 12
