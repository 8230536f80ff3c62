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

# the port's changes to filter_to_vcf_parallel, (port text, pgen_tpu text):
# the device handed to every worker, and the workers' reports kept and
# returned
CHANGES = [
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
]


@pytest.mark.parametrize("name", COPIED)
def test_copied_verbatim(name):
    want = inspect.getsource(getattr(tpu_shard, name))
    got = inspect.getsource(getattr(port_shard, name)).replace("pgen_tpu_torch.", "pgen_tpu.")
    got = got.replace("pipeline.filter_host import", "pipeline.filter import")
    if name == "filter_to_vcf_parallel":
        for port_text, tpu_text in CHANGES:
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
    assert item[4]["genotype_text"] == 0 and item[4]["subset_text_from_packed"] == 0
    assert set(item[4]) == {"genotype_text", "subset_text_from_packed", "entered", "seconds",
                            "pinned", "device_peak"}
    with pytest.raises(RuntimeError, match="injected failure for shard 2"):
        port_shard._worker_entry(q, 2, {}, inject_fail=True)
