"""The port's variant shards (``pgen_tpu_torch.parallel.shard``: ``filter
--shards N [--shard-index I]``, ``--workers N [--resume]``) against
pgen_tpu's ``filter_to_vcf_sharded`` and ``filter_to_vcf_parallel``, byte
for byte, on filesets synthesized by test_torch_filter's ``_fileset``.

The port runs with device="cpu" (the kernels' plain PyTorch versions). Its
shards in one process run here in-process; every case that starts worker
processes runs the port's CLI in a subprocess under a timeout
(``_port_cli_in_subprocess``), so that a hung worker fails its test and
never holds the suite. pgen_tpu's parallel filter runs in-process, as its
own tests run it. Also here: ``plan_shards``, the start methods, the
no-fallback rule without a card, and the copied functions' source.
"""

import inspect
import json
from pathlib import Path

import pytest

from pgen_tpu.parallel import shard as tpu_shard
from pgen_tpu.pipeline.filter import filter_to_vcf as tpu_filter
from pgen_tpu_torch.parallel import shard as port_shard
from pgen_tpu_torch.pipeline.filter import filter_to_vcf as port_filter
from test_torch_filter import _fileset, _port_cli_in_subprocess, _read

QUERIES = {
    "keep_all": {},
    "sample_subset": {"sam_query": 'IID == "s4" || IID == "s1" || IID == "s2"'},
    "both_subsets": {"var_query": 'ALT != "C"', "sam_query": 'SEX == "F"'},
    "two_rows": {"var_query": 'ID == "rs3" || ID == "rs20"'},  # fewer rows than shards
    "no_rows": {"var_query": 'ID == "none"'},
}


@pytest.mark.parametrize("num_kept,num_shards", [(10, 3), (2, 4), (0, 2), (7, 7), (1, 5),
                                                 (1_103_547, 4)])
def test_plan_shards_matches_pgen_tpu(num_kept, num_shards):
    got = port_shard.plan_shards(num_kept, num_shards)
    assert got == tpu_shard.plan_shards(num_kept, num_shards)
    assert got[0][0] == 0 and got[-1][1] == num_kept
    assert max(h - lo for lo, h in got) - min(h - lo for lo, h in got) <= 1


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("case", list(QUERIES))
def test_sharded_matches_pgen_tpu_and_unsharded(tmp_path, case, num_shards):
    """All shards in one process: pgen_tpu's bytes, and the one-process
    filter's."""
    prefix = _fileset(tmp_path, 29, 7, seed=num_shards)
    kw = {**QUERIES[case], "block_variants": 4}
    tpu_shard.filter_to_vcf_sharded(prefix, out_file=tmp_path / "tpu.vcf", provider="numpy",
                                    num_shards=num_shards, **kw)
    got = port_shard.filter_to_vcf_sharded(prefix, out_file=tmp_path / "port.vcf", device="cpu",
                                           num_shards=num_shards, **kw)
    port_filter(prefix, out_file=tmp_path / "one.vcf", device="cpu", **kw)
    assert _read(tmp_path / "port.vcf") == _read(tmp_path / "tpu.vcf") == _read(tmp_path / "one.vcf")
    assert got.bytes_written == (tmp_path / "port.vcf").stat().st_size


@pytest.mark.parametrize("num_shards", [1, 3, 5])
def test_sharded_gz_with_index_matches_pgen_tpu(tmp_path, num_shards):
    prefix = _fileset(tmp_path, 29, 7, seed=7)
    kw = {"sam_query": 'SEX == "M"', "block_variants": 4, "num_shards": num_shards,
          "index": True}
    tpu_shard.filter_to_vcf_sharded(prefix, out_file=tmp_path / "tpu.vcf.gz", provider="numpy",
                                    **kw)
    port_shard.filter_to_vcf_sharded(prefix, out_file=tmp_path / "port.vcf.gz", device="cpu",
                                     **kw)
    for suf in ("", ".tbi"):
        assert _read(f"{tmp_path}/port.vcf.gz{suf}") == _read(f"{tmp_path}/tpu.vcf.gz{suf}")


@pytest.mark.parametrize("order", [(2, 0, 1), (1, 2, 0), (0, 1, 2, 1)])
def test_shard_indices_in_any_order_into_one_file(tmp_path, order):
    """Each --shard-index writes its rows at their offsets of one shared
    file: any order, and a shard run twice, gives the whole file."""
    prefix = _fileset(tmp_path, 29, 7, seed=11)
    kw = {**QUERIES["both_subsets"], "block_variants": 3}
    for si in order:
        port_shard.filter_to_vcf_sharded(prefix, out_file=tmp_path / "port.vcf", device="cpu",
                                         num_shards=3, shard_index=si, **kw)
    tpu_filter(prefix, out_file=tmp_path / "tpu.vcf", provider="numpy", **kw)
    assert _read(tmp_path / "port.vcf") == _read(tmp_path / "tpu.vcf")


@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
def test_standalone_parts_match_pgen_tpu(tmp_path, suffix):
    """standalone=True: each shard's own file from offset 0 (the header in
    shard 0's), pgen_tpu's part bytes; the parts concatenate to the file."""
    prefix = _fileset(tmp_path, 29, 7, seed=13)
    kw = {"sam_query": 'IID != "s2"', "block_variants": 4, "num_shards": 4,
          "standalone": True}
    for i in range(4):
        tpu_shard.filter_to_vcf_sharded(prefix, out_file=tmp_path / f"tpu{i}{suffix}",
                                        provider="numpy", shard_index=i, **kw)
        port_shard.filter_to_vcf_sharded(prefix, out_file=tmp_path / f"port{i}{suffix}",
                                         device="cpu", shard_index=i, **kw)
        assert _read(tmp_path / f"port{i}{suffix}") == _read(tmp_path / f"tpu{i}{suffix}")
    if suffix == ".vcf":
        port_filter(prefix, out_file=tmp_path / "one.vcf", device="cpu",
                    sam_query=kw["sam_query"])
        assert b"".join(_read(tmp_path / f"port{i}.vcf") for i in range(4)) == \
            _read(tmp_path / "one.vcf")


@pytest.mark.parametrize("kw", [
    {"out_file": "x.vcf.gz", "num_shards": 2, "shard_index": 0},
    {"out_file": "x.vcf", "num_shards": 2, "index": True},
    {"out_file": "x.vcf.gz", "num_shards": 2, "shard_index": 1, "standalone": True,
     "index": True},
    {"out_file": "x.vcf", "num_shards": 2, "standalone": True},
], ids=["gz_shared", "index_plain", "index_shard", "standalone_without_index"])
def test_sharded_errors_match_pgen_tpu(tmp_path, kw):
    prefix = _fileset(tmp_path, 9, 5, seed=3)
    kw = {**kw, "out_file": tmp_path / kw["out_file"]}
    errors = []
    for call, extra in ((tpu_shard.filter_to_vcf_sharded, {"provider": "numpy"}),
                        (port_shard.filter_to_vcf_sharded, {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            call(prefix, **kw, **extra)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# -- worker processes (each port run in a subprocess, under a timeout) -----------

def _workers_reference(tmp_path, prefix, name, num_workers, kw):
    """pgen_tpu's bytes of a --workers N run: its shards in one process (the
    same members, header and EOF as its parallel run's concatenated parts)."""
    out = tmp_path / name
    tpu_shard.filter_to_vcf_sharded(prefix, out_file=out, provider="numpy",
                                    num_shards=num_workers, index=str(out).endswith(".gz"),
                                    **kw)
    return out


@pytest.mark.parametrize("workers", [2, 3])
@pytest.mark.parametrize("method", ["fork", "spawn"])
def test_workers_under_each_start_method(tmp_path, method, workers):
    prefix = _fileset(tmp_path, 29, 7, seed=workers)
    argv = ["filter", prefix, "--samples", "s1,s5,s6", "--block-variants", "4",
            "--workers", str(workers), "--device", "cpu", "--stats", "-o", "port.vcf"]
    r = _port_cli_in_subprocess(argv, tmp_path, env={"PGEN_TPU_MP_CONTEXT": method})
    assert r.returncode == 0, r.stderr[-3000:]
    want = _workers_reference(tmp_path, prefix, "tpu.vcf", workers,
                              {"sam_query": 'IID == "s1" || IID == "s5" || IID == "s6"',
                               "block_variants": 4})
    assert _read(tmp_path / "port.vcf") == _read(want)
    lines = [ln for ln in r.stderr.splitlines() if ln.startswith("worker ")]
    assert [ln.split(" (")[0] for ln in lines] == [f"worker {i}" for i in range(workers)]
    assert all(f"({method})" in ln and "launches genotype_text 0" in ln for ln in lines)
    assert not (tmp_path / "port.vcf.manifest.json").exists()


def test_workers_gz_index_match_pgen_tpu_parallel(tmp_path):
    """--workers 3 to .vcf.gz --index: BGZF parts concatenated in shard
    order, then the merged index: pgen_tpu's filter_to_vcf_parallel's
    bytes, .tbi included, and no part or manifest left behind."""
    prefix = _fileset(tmp_path, 29, 7, seed=17)
    argv = ["filter", prefix, "--block-variants", "4", "--workers", "3", "--index",
            "--device", "cpu", "-o", "port.vcf.gz"]
    r = _port_cli_in_subprocess(argv, tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    res = tpu_shard.filter_to_vcf_parallel(prefix, out_file=str(tmp_path / "tpu.vcf.gz"),
                                           num_workers=3, block_variants=4, index=True)
    assert res.num_variants_kept == 29
    for suf in ("", ".tbi"):
        assert _read(f"{tmp_path}/port.vcf.gz{suf}") == _read(f"{tmp_path}/tpu.vcf.gz{suf}")
    assert sorted(p.name for p in tmp_path.glob("port*")) == ["port.vcf.gz", "port.vcf.gz.tbi"]


_FAIL_THEN_RESUME = """
import json, os, sys
sys.path.insert(0, {repo!r})
from pgen_tpu_torch.cli import main
argv = {argv!r}
os.environ["PGEN_TPU_TEST_FAIL_SHARD"] = "1"
rc = main(argv)
manifest = open(argv[argv.index("-o") + 1] + ".manifest.json").read()
del os.environ["PGEN_TPU_TEST_FAIL_SHARD"]
print(json.dumps([rc, manifest, main(argv + ["--resume"])]))
"""


@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
def test_worker_failure_then_resume_matches_pgen_tpu(tmp_path, capfd, monkeypatch, suffix):
    """PGEN_TPU_TEST_FAIL_SHARD=1: exit 1 with pgen_tpu's message, its
    manifest byte for byte (shard 1 failed, the others done); --resume then
    runs shard 1 alone and gives pgen_tpu's bytes."""
    import subprocess
    import sys

    prefix = _fileset(tmp_path, 29, 7, seed=19)
    base = ["filter", prefix, "--block-variants", "4", "--workers", "3"]
    argv = [*base, "--device", "cpu", "-o", str(tmp_path / f"port{suffix}")]
    code = _FAIL_THEN_RESUME.format(repo=str(Path(__file__).resolve().parent.parent),
                                    argv=argv)
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    rc, manifest, rc_resume = json.loads(r.stdout.splitlines()[-1])
    port_err = [ln for ln in r.stderr.splitlines() if ln.startswith("pgen-tpu: error:")]

    from pgen_tpu.cli import main as tpu_main

    tpu_argv = [*base, "-o", str(tmp_path / f"tpu{suffix}")]
    monkeypatch.setenv("PGEN_TPU_TEST_FAIL_SHARD", "1")
    assert tpu_main(tpu_argv) == rc == 1
    tpu_err = [ln for ln in capfd.readouterr().err.splitlines()
               if ln.startswith("pgen-tpu: error:")]
    assert [ln.replace("port.", "tpu.") for ln in port_err] == tpu_err and len(tpu_err) == 1
    assert manifest == (tmp_path / f"tpu{suffix}.manifest.json").read_text()
    assert [s["status"] for s in json.loads(manifest)["shards"]] == ["done", "failed", "done"]
    monkeypatch.delenv("PGEN_TPU_TEST_FAIL_SHARD")
    assert tpu_main([*tpu_argv, "--resume"]) == rc_resume == 0
    assert _read(tmp_path / f"port{suffix}") == _read(tmp_path / f"tpu{suffix}")
    assert not list(tmp_path.glob("*.manifest.json")) and not list(tmp_path.glob("*.part"))


def test_resume_with_changed_parameters_matches_pgen_tpu(tmp_path, capfd, monkeypatch):
    """A manifest written for other parameters: --resume exits 1 with
    pgen_tpu's message, and the manifest stays as it was."""
    prefix = _fileset(tmp_path, 29, 7, seed=23)
    from pgen_tpu.cli import main as tpu_main

    monkeypatch.setenv("PGEN_TPU_TEST_FAIL_SHARD", "0")
    assert tpu_main(["filter", prefix, "--workers", "2", "-o", str(tmp_path / "t.vcf")]) == 1
    monkeypatch.delenv("PGEN_TPU_TEST_FAIL_SHARD")
    capfd.readouterr()
    manifest = (tmp_path / "t.vcf.manifest.json").read_text()
    argv = ["filter", prefix, "--workers", "2", "--include-var", 'ALT == "G"', "--resume",
            "-o", str(tmp_path / "t.vcf")]
    r = _port_cli_in_subprocess([*argv, "--device", "cpu"], tmp_path)
    assert tpu_main(argv) == r.returncode == 1
    tpu_err = capfd.readouterr().err.splitlines()[-1]
    assert r.stderr.splitlines()[-1] == tpu_err and "different parameters" in tpu_err
    assert (tmp_path / "t.vcf.manifest.json").read_text() == manifest


def test_workers_on_cuda_without_a_card_fail_without_fallback(tmp_path):
    """--workers 2 with the default --device cuda on a machine without a
    card: every worker raises, the run exits 1, the manifest marks both
    shards failed, and no output file is written."""
    prefix = _fileset(tmp_path, 9, 5, seed=29)
    r = _port_cli_in_subprocess(["filter", prefix, "--workers", "2", "-o", "out.vcf"], tmp_path)
    assert r.returncode == 1 and "shard workers failed: [(0, 1), (1, 1)]" in r.stderr
    assert "is_available() is False" in r.stderr
    manifest = json.loads((tmp_path / "out.vcf.manifest.json").read_text())
    assert [s["status"] for s in manifest["shards"]] == ["failed", "failed"]
    assert not (tmp_path / "out.vcf").exists()


def test_workers_after_torch_work_in_the_same_process(tmp_path):
    """The parent has run torch's thread pool (a matmul, a reduction) before
    --workers: the default start method starts the workers clean, and the
    run neither hangs (the subprocess timeout) nor differs."""
    prefix = _fileset(tmp_path, 29, 7, seed=31)
    before = ("import torch\nx = torch.randn(1024, 1024)\n"
              "assert torch.get_num_threads() >= 1 and (x @ x).sum().isfinite()\n")
    argv = ["filter", prefix, "--block-variants", "4", "--workers", "2", "--device", "cpu",
            "--stats", "-o", "port.vcf"]
    r = _port_cli_in_subprocess(argv, tmp_path, before=before, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "(forkserver)" in r.stderr
    want = _workers_reference(tmp_path, prefix, "tpu.vcf", 2, {"block_variants": 4})
    assert _read(tmp_path / "port.vcf") == _read(want)


def test_forced_fork_after_cuda_init_is_refused(monkeypatch):
    import torch

    monkeypatch.setenv("PGEN_TPU_MP_CONTEXT", "fork")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="initialised CUDA"):
        port_shard._mp_context()
    monkeypatch.setenv("PGEN_TPU_MP_CONTEXT", "spawn")
    assert port_shard._mp_context().get_start_method() == "spawn"
    monkeypatch.delenv("PGEN_TPU_MP_CONTEXT")
    assert port_shard._mp_context().get_start_method() == "forkserver"


# -- the copies ------------------------------------------------------------------------

COPIED = ["plan_shards", "_shard_part_path", "_manifest_path", "_write_manifest",
          "_concat_gz_parts", "_index_merged_gz", "filter_to_vcf_parallel"]

# the port's changes to its copies, (port text, pgen_tpu text) by function.
# filter_to_vcf_parallel: the device handed to every worker and to
# _index_merged_gz, and the workers' reports kept and returned.
# _index_merged_gz: the device its layout counts GT_* on (provider="device").
CHANGES = {
    "filter_to_vcf_parallel": [
        ('    provider: str = "auto",\n    device: str = "cuda",\n',
         '    provider: str = "auto",\n'),
        ("            provider=provider,\n            device=device,\n",
         "            provider=provider,\n"),
        ("                    provider=provider,\n                    device=device,\n",
         "                    provider=provider,\n"),
        ("    results = {}\n    reports = {}\n", "    results = {}\n"),
        ("        idx, nv, ns, nbytes, report = item\n        reports[idx] = report\n",
         "        idx, nv, ns, nbytes = item\n"),
        ("    return ParallelFilterResult(\n", "    return FilterResult(\n"),
        ("        timer=StageTimer(),\n        worker_reports=reports,\n",
         "        timer=StageTimer(),\n"),
        ("provider, index_format,\n            device,\n        )",
         "provider, index_format\n        )"),
    ],
    "_index_merged_gz": [
        ('    index_format: str,\n    device: str = "cuda",\n) -> str:',
         "    index_format: str,\n) -> str:"),
        ("sam_query, provider, device=device)", "sam_query, provider)"),
    ],
}


@pytest.mark.parametrize("name", COPIED)
def test_copied_verbatim(name):
    want = inspect.getsource(getattr(tpu_shard, name))
    got = inspect.getsource(getattr(port_shard, name)).replace("pgen_tpu_torch.", "pgen_tpu.")
    got = got.replace("pipeline.filter_host import", "pipeline.filter import")
    for port_text, tpu_text in CHANGES.get(name, []):
        assert got.count(port_text) == 1, port_text
        got = got.replace(port_text, tpu_text)
    assert got == want


def test_worker_report_beside_pgen_tpu_tuple(monkeypatch):
    """_worker_entry is pgen_tpu's, its queue item pgen_tpu's tuple and
    then the report, the launches counted from 0 in the worker."""
    import queue

    from pgen_tpu_torch.ops.gt_text import genotype_text

    class Result:
        num_variants_kept, num_samples_kept, bytes_written = 3, 2, 100

    calls = []
    monkeypatch.setattr(port_shard, "filter_to_vcf_sharded",
                        lambda **kw: calls.append(kw) or Result())
    monkeypatch.setattr(genotype_text, "launches", 5)
    q = queue.Queue()
    port_shard._worker_entry(q, 1, {"x": 1})
    item = q.get_nowait()
    assert calls == [{"x": 1}] and item[:4] == (1, 3, 2, 100)
    assert all(item[4][name] == 0 for name in port_shard.REPORTED)
    assert set(item[4]) == {*port_shard.REPORTED, "entered", "seconds", "pinned",
                            "device_peak"}
    with pytest.raises(RuntimeError, match="injected failure for shard 2"):
        port_shard._worker_entry(q, 2, {}, inject_fail=True)


# -- --provider device: GT_* counted by the port's ops/gt_stats on every path ------

# a variant GT_* predicate (K8), a sample one (K9) and a variant one over a
# cohort (K14), each keeping some rows or samples of _fileset(29, 7, seed=38)
# and not all; with the wrapper its counts go through
A4 = {
    "variant_gt": ({"var_query": "GT_MAF >= 0.3"}, "gt_counts_device"),
    "sample_gt": ({"sam_query": "GT_MISSING_RATE < 0.25"}, "sample_counts_device"),
    "cohort": ({"var_query": "GT_AC >= 3",
                "sam_query": 'IID == "s1" || IID == "s3" || IID == "s4" || IID == "s6"'},
               "gt_counts_masked"),
}
_COUNT_WRAPPERS = ("gt_counts_device", "sample_counts_device", "gt_counts_masked")
_HOST_COUNTS = ("gt_counts_numpy", "sample_counts_numpy", "gt_counts_native", "gt_counts",
                "sample_counts", "gt_counts_subset")


def _a4_argv(case: str) -> list:
    query = A4[case][0]
    return [*(["--include-var", query["var_query"]] if "var_query" in query else []),
            *(["--include-sam", query["sam_query"]] if "sam_query" in query else [])]


@pytest.fixture
def count_spy(monkeypatch):
    """The names of ops/gt_stats's count wrappers in the order they are
    called (each still counts); any call of ops/gt_stats_host's counts fails
    the test."""
    from pgen_tpu_torch.ops import gt_stats, gt_stats_host

    calls = []
    for name in _COUNT_WRAPPERS:
        def spy(*args, _real=getattr(gt_stats, name), _name=name, **kwargs):
            calls.append(_name)
            return _real(*args, **kwargs)

        spy.launches = 0
        monkeypatch.setattr(gt_stats, name, spy)
    for name in _HOST_COUNTS:
        def refuse(*args, _name=name, **kwargs):
            raise AssertionError(f"gt_stats_host.{_name} counted on the host")

        monkeypatch.setattr(gt_stats_host, name, refuse)
    return calls


def _kept(vcf: bytes) -> tuple:
    """(body rows, samples) of a VCF."""
    lines = vcf.split(b"\n")
    head = next(ln for ln in lines if ln.startswith(b"#CHROM"))
    return sum(1 for ln in lines if ln and not ln.startswith(b"#")), len(head.split(b"\t")) - 9


def _nontrivial(case: str, vcf: bytes) -> None:
    rows, samples = _kept(vcf)
    assert (0 < samples < 7) if case == "sample_gt" else (0 < rows < 29), (case, rows, samples)


@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
@pytest.mark.parametrize("case", list(A4))
def test_device_provider_shards_count_on_the_device(tmp_path, capfd, count_spy, case, suffix):
    """--provider device --shards 2 (and .vcf.gz --index): the masks' counts
    go through the port's wrappers once, never the host's, and the files
    are pgen_tpu's CLI's with the same flags, byte for byte."""
    from pgen_tpu.cli import main as tpu_main
    from pgen_tpu_torch.cli import main as port_main

    prefix = _fileset(tmp_path, 29, 7, seed=38)
    argv = ["filter", prefix, *_a4_argv(case), "--provider", "device", "--shards", "2",
            "--block-variants", "4", *(["--index"] if suffix == ".vcf.gz" else [])]
    assert port_main([*argv, "--device", "cpu", "-o", str(tmp_path / f"port{suffix}")]) == 0
    assert count_spy == [A4[case][1]]
    assert tpu_main([*argv, "-o", str(tmp_path / f"tpu{suffix}")]) == 0
    for suf in ("", ".tbi") if suffix == ".vcf.gz" else ("",):
        assert _read(f"{tmp_path}/port{suffix}{suf}") == _read(f"{tmp_path}/tpu{suffix}{suf}")
    if suffix == ".vcf":
        _nontrivial(case, _read(tmp_path / "port.vcf"))


@pytest.mark.parametrize("mode", ["list", "error"])
@pytest.mark.parametrize("case", list(A4))
def test_device_provider_rm_dup_counts_on_the_device(tmp_path, capfd, count_spy, case, mode):
    """--rm-dup list|error with --provider device --shards 2: the report's
    masks and then the shards' are counted by the port's wrappers; the
    .rmdup.list, the VCF, or the exit code and message are pgen_tpu's."""
    from pgen_tpu.cli import main as tpu_main
    from pgen_tpu_torch.cli import main as port_main

    prefix = _fileset(tmp_path, 29, 7, seed=38)
    argv = ["filter", prefix, *_a4_argv(case), "--provider", "device", "--shards", "2",
            "--rm-dup", mode]
    rc = port_main([*argv, "--device", "cpu", "-o", str(tmp_path / "port.vcf")])
    port_err = capfd.readouterr().err.splitlines()
    assert tpu_main([*argv, "-o", str(tmp_path / "tpu.vcf")]) == rc
    tpu_err = capfd.readouterr().err.splitlines()
    if mode == "error":
        assert rc == 2 and port_err == tpu_err and "duplicated variant ID" in port_err[-1]
        assert count_spy == [A4[case][1]]
        return
    assert rc == 0 and count_spy == [A4[case][1]] * 2
    listed = _read(tmp_path / "port.vcf.rmdup.list")
    assert listed == _read(tmp_path / "tpu.vcf.rmdup.list") and listed
    assert _read(tmp_path / "port.vcf") == _read(tmp_path / "tpu.vcf")
    assert [ln.replace("port.", "tpu.") for ln in port_err if "--rm-dup" in ln] == \
        [ln for ln in tpu_err if "--rm-dup" in ln]


@pytest.mark.parametrize("case", list(A4))
def test_device_provider_merged_gz_index_counts_on_the_device(tmp_path, count_spy, case):
    """_index_merged_gz (the parent's index of a --workers .vcf.gz)
    re-derives the layout with the counts on the device: pgen_tpu's .tbi."""
    from pgen_tpu.cli import main as tpu_main

    prefix = _fileset(tmp_path, 29, 7, seed=38)
    query = A4[case][0]
    gz = str(tmp_path / "port.vcf.gz")
    port_shard.filter_to_vcf_sharded(prefix, out_file=gz, provider="device", num_shards=2,
                                     block_variants=4, device="cpu", **query)
    count_spy.clear()
    port_shard._index_merged_gz(gz, prefix, query.get("var_query"), query.get("sam_query"),
                                "device", "auto", device="cpu")
    assert count_spy == [A4[case][1]]
    assert tpu_main(["filter", prefix, *_a4_argv(case), "--provider", "device", "--shards", "2",
                     "--block-variants", "4", "--index", "-o", str(tmp_path / "tpu.vcf.gz")]) == 0
    for suf in ("", ".tbi"):
        assert _read(f"{gz}{suf}") == _read(f"{tmp_path}/tpu.vcf.gz{suf}")


_SPIED_RESUME = """
import json, os, sys
sys.path.insert(0, {repo!r})
os.environ["PGEN_TPU_MP_CONTEXT"] = "fork"  # the workers inherit the spies
from pgen_tpu_torch.ops import gt_stats, gt_stats_host
log = {log!r}

def spy(name, real):
    def call(*args, **kwargs):
        with open(log, "a") as f:
            f.write(f"{{os.getpid()}} {{name}}\\n")
        return real(*args, **kwargs)
    call.launches = 0
    return call

def refuse(name):
    def call(*args, **kwargs):
        raise AssertionError(f"gt_stats_host.{{name}} counted on the host")
    return call

for name in {wrappers!r}:
    setattr(gt_stats, name, spy(name, getattr(gt_stats, name)))
for name in {host!r}:
    setattr(gt_stats_host, name, refuse(name))
from pgen_tpu_torch.cli import main
argv = {argv!r}
os.environ["PGEN_TPU_TEST_FAIL_SHARD"] = "1"
rc = main(argv)
del os.environ["PGEN_TPU_TEST_FAIL_SHARD"]
with open(log, "a") as f:
    f.write("resume\\n")
print(json.dumps([rc, main(argv + ["--resume"])]))
"""


@pytest.mark.parametrize("case", list(A4))
def test_device_provider_resume_counts_on_the_device(tmp_path, case):
    """--workers 3 --provider device with shard 1 failing, then --resume:
    each worker that ran counted through the port's wrappers, in its own
    process (forked, so that it carries the spies), and never on the host;
    the file is pgen_tpu's --shards 3 with the same flags."""
    import subprocess
    import sys

    from pgen_tpu.cli import main as tpu_main

    prefix = _fileset(tmp_path, 29, 7, seed=38)
    base = ["filter", prefix, *_a4_argv(case), "--provider", "device", "--block-variants", "4"]
    log = tmp_path / "calls.log"
    code = _SPIED_RESUME.format(
        repo=str(Path(__file__).resolve().parent.parent), log=str(log),
        wrappers=_COUNT_WRAPPERS, host=_HOST_COUNTS,
        argv=[*base, "--workers", "3", "--device", "cpu", "-o", str(tmp_path / "port.vcf")])
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.splitlines()[-1]) == [1, 0]
    first, resumed = log.read_text().split("resume\n")
    calls = [[ln.split() for ln in part.splitlines()] for part in (first, resumed)]
    # shards 0 and 2, then shard 1 alone: one count a worker, each its own process
    assert [len(c) for c in calls] == [2, 1]
    assert {name for c in calls for _, name in c} == {A4[case][1]}
    assert len({pid for c in calls for pid, _ in c}) == 3
    assert tpu_main([*base, "--shards", "3", "-o", str(tmp_path / "tpu.vcf")]) == 0
    assert _read(tmp_path / "port.vcf") == _read(tmp_path / "tpu.vcf")
    _nontrivial(case, _read(tmp_path / "port.vcf"))


def test_device_provider_workers_match_pgen_tpu(tmp_path):
    """--workers 2 --provider device under the default start method: the
    bytes of pgen_tpu's CLI with --shards 2 (a spy cannot reach a
    forkserver's worker; the resume test above holds the route)."""
    from pgen_tpu.cli import main as tpu_main

    prefix = _fileset(tmp_path, 29, 7, seed=38)
    base = ["filter", prefix, *_a4_argv("cohort"), "--provider", "device", "--block-variants", "4"]
    r = _port_cli_in_subprocess([*base, "--workers", "2", "--device", "cpu", "--stats",
                                 "-o", "port.vcf"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "gt_counts_masked 0" in r.stderr  # the CPU launches no kernel
    assert tpu_main([*base, "--shards", "2", "-o", str(tmp_path / "tpu.vcf")]) == 0
    assert _read(tmp_path / "port.vcf") == _read(tmp_path / "tpu.vcf")


@pytest.mark.parametrize("case", list(A4))
def test_filter_to_vcf_device_provider_counts_on_the_device(tmp_path, count_spy, case):
    """The library's filter_to_vcf(provider="device"), called as pgen_tpu's
    is (provider fifth, by position): the port's wrappers count, and the
    bytes are pgen_tpu's filter_to_vcf(provider="device")'s."""
    query = A4[case][0]
    args = (query.get("var_query"), query.get("sam_query"))
    prefix = _fileset(tmp_path, 29, 7, seed=38)
    port_filter(prefix, *args, tmp_path / "port.vcf", "device", 4, device="cpu")
    assert count_spy == [A4[case][1]]
    tpu_filter(prefix, *args, tmp_path / "tpu.vcf", "device", 4)
    assert _read(tmp_path / "port.vcf") == _read(tmp_path / "tpu.vcf")


# the device variants of filter_host's two functions (pipeline/filter.py), as
# (port text, copy text): a device argument, a docstring paragraph and the
# dispatch of any other provider to the copy, and the device in the mask call
DEVICE_VARIANTS = {
    "derive_row_layout": [
        ('    timer: StageTimer | None = None,\n    device: str | torch.device = "cuda",\n',
         "    timer: StageTimer | None = None,\n"),
        ('    merged-.gz indexer).\n\n    The device provider\'s layout: '
         "``filter_host.derive_row_layout`` with the\n    masks of the port's "
         "``compute_masks``, whose genotype counts run on\n    ``device`` (K8, K9, K14). "
         "Any other provider is the copy's, called as\n    it stands.\"\"\"\n"
         '    if provider != "device":\n        return filter_host.derive_row_layout(\n'
         "            pfile_prefix, var_query, sam_query, provider, source_tag, timer\n"
         "        )\n",
         '    merged-.gz indexer)."""\n'),
        ("header, records, device\n", "header, records, provider\n"),
    ],
    "duplicated_ids": [
        ('    provider: str = "auto",\n    device: str | torch.device = "cuda",\n',
         '    provider: str = "auto",\n'),
        ("    matching plink2's filter order).\n\n    The device provider's report: "
         "``filter_host.duplicated_ids`` with the\n    masks of the port's ``compute_masks`` "
         "on ``device``. Any other provider\n    is the copy's, called as it stands.\"\"\"\n"
         '    if provider != "device":\n        return filter_host.duplicated_ids('
         "pfile_prefix, var_query, sam_query, provider)\n",
         "    matching plink2's filter order).\"\"\"\n"),
        ("header, records, device\n", "header, records, provider\n"),
    ],
}


@pytest.mark.parametrize("name", list(DEVICE_VARIANTS))
def test_device_variant_differs_from_the_copy_in_the_mask_call(name):
    """pipeline/filter.py's derive_row_layout and duplicated_ids are
    filter_host's, line for line, but for the changes listed."""
    from pgen_tpu_torch.pipeline import filter as port_filter_mod
    from pgen_tpu_torch.pipeline import filter_host

    got = inspect.getsource(getattr(port_filter_mod, name))
    want = inspect.getsource(getattr(filter_host, name))
    for port_text, copy_text in DEVICE_VARIANTS[name]:
        assert got.count(port_text) == 1, port_text
        got = got.replace(port_text, copy_text)
    assert got == want
