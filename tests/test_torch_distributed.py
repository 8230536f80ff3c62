"""The port's ``run_distributed_filter`` (``pgen_tpu_torch.parallel.distributed``):
one process a variant shard of the host filter, in a gloo group, against
pgen_tpu's ``filter_to_vcf_sharded`` and the port's lone ``filter_to_vcf``,
byte for byte.

Each launch spawns W processes (W = 2 and 3, 3 giving uneven shards) that
run every job of the launch in turn with ``device="cpu"``: each job joins
its own group (pgen_tpu's keyword arguments ``coordinator_address``,
``num_processes`` and ``process_id``, a free port a job), filters its shard
and destroys the group; the last job runs inside a group the process made
itself, which the call must use and leave alone. pgen_tpu's bytes of a
shard are its ``filter_to_vcf_sharded`` with the same shard index and
``standalone``, run here in-process with the numpy provider (its device
provider writes the same bytes). Also here: pgen_tpu's own worker script
run against the port, the group's arguments and the lone process.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from pgen_tpu.parallel import shard as tpu_shard
from pgen_tpu_torch.parallel import distributed as port_dist
from pgen_tpu_torch.pipeline.filter import filter_to_vcf as port_filter
from test_torch_filter import _fileset, _read

REPO = Path(__file__).resolve().parent.parent

# job -> (filter arguments, provider): host predicates, and a GT_* predicate
# counted on the device
JOBS = {
    "host": ({"var_query": 'ALT != "C"', "sam_query": 'SEX == "F"'}, "auto"),
    "device": ({"var_query": "GT_MAF >= 0.3", "sam_query": 'IID != "s2"'}, "device"),
}

_WORKER = r"""
import json, sys
sys.path.insert(0, {repo!r})
import torch.distributed as dist
from pgen_tpu_torch.parallel.distributed import run_distributed_filter

spec = json.load(open(sys.argv[1]))
rank, world = int(sys.argv[2]), spec["world"]
done = {{}}
for job in spec["jobs"]:
    res = run_distributed_filter(
        spec["prefix"], **job["query"], out_file=job["out"], provider=job["provider"],
        block_variants=4, shared_fs=job["shared_fs"], device="cpu",
        coordinator_address=f"localhost:{{job['port']}}", num_processes=world,
        process_id=rank,
    )
    assert not dist.is_initialized(), "the call left its group behind"
    done[job["name"]] = [res.num_variants_kept, res.bytes_written, list(res.timer.stages)]
# a group of the caller's: used, and left as it was
job = spec["caller"]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{{job['port']}}", rank=rank,
                        world_size=world)
res = run_distributed_filter(spec["prefix"], **job["query"], out_file=job["out"],
                             block_variants=4, device="cpu")
assert dist.is_initialized() and dist.get_world_size() == world, "the caller's group is gone"
dist.barrier()
dist.destroy_process_group()
done["caller"] = [res.num_variants_kept, res.bytes_written, list(res.timer.stages)]
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pgen_tpu"))
assert not loaded, f"a process loaded {{loaded[:5]}}"
json.dump(done, open(f"{{sys.argv[1]}}.rank{{rank}}", "w"))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _clean_env() -> dict:
    """This environment without a launcher's or pgen_tpu's group variables."""
    return {k: v for k, v in os.environ.items()
            if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                         "MASTER_PORT") and not k.startswith("PGEN_TPU_")}


def _spawn(cmds: list, cwd: Path) -> list:
    """Run ``cmds`` at once; each must exit 0 within 120 s. Returns their
    stdout."""
    procs, outs = [], []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, env=_clean_env(), cwd=str(cwd),
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err.decode()[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


@pytest.fixture(scope="module")
def fileset(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    return d, _fileset(d, 31, 7, seed=41)


@pytest.fixture(scope="module", params=[2, 3], ids=["2procs", "3procs"])
def dist_run(request, fileset):
    """Every job run once by one launch of W processes. Returns (world,
    output dir, each process's results by job)."""
    world = request.param
    d, prefix = fileset
    out = d / f"w{world}"
    out.mkdir()
    jobs = [{"name": f"{name}-{'shared' if shared else 'parts'}", "query": query,
             "provider": provider, "shared_fs": shared, "port": _free_port(),
             "out": str(out / f"{name}-{'shared' if shared else 'parts'}.vcf")}
            for name, (query, provider) in JOBS.items() for shared in (True, False)]
    caller = {"query": JOBS["host"][0], "port": _free_port(), "out": str(out / "caller.vcf")}
    spec = out / "spec.json"
    spec.write_text(json.dumps({"prefix": prefix, "world": world, "jobs": jobs,
                                "caller": caller}))
    code = _WORKER.format(repo=str(REPO))
    _spawn([[sys.executable, "-c", code, str(spec), str(r)] for r in range(world)], out)
    return world, out, [json.loads(Path(f"{spec}.rank{r}").read_text()) for r in range(world)]


def _lone(d: Path, prefix: str, query: dict) -> bytes:
    """The port's one-process filter of the same query."""
    out = d / "lone.vcf"
    port_filter(prefix, **query, out_file=out, block_variants=4, device="cpu")
    return _read(out)


@pytest.mark.parametrize("job", list(JOBS))
@pytest.mark.parametrize("shared_fs", [True, False], ids=["shared", "parts"])
def test_processes_match_pgen_tpu_shards(dist_run, fileset, shared_fs, job):
    """W processes, shared file or one part a process: pgen_tpu's shard
    bytes for each shard index, and together the lone filter's file."""
    world, out, done = dist_run
    d, prefix = fileset
    query, _ = JOBS[job]
    name = f"{job}-{'shared' if shared_fs else 'parts'}"
    target = out / f"{name}.vcf"
    want = out / f"tpu-{name}.vcf"
    for r in range(world):
        tpu_shard.filter_to_vcf_sharded(
            prefix, **query, out_file=want if shared_fs else f"{want}.shard{r}",
            provider="numpy", num_shards=world, shard_index=r, block_variants=4,
            standalone=not shared_fs)
    if shared_fs:
        got = _read(target)
        assert got == _read(want)
        assert not list(out.glob(f"{name}.vcf.shard*"))
    else:
        parts = [_read(f"{target}.shard{r}") for r in range(world)]
        assert parts == [_read(f"{want}.shard{r}") for r in range(world)]
        assert not target.exists()
        got = b"".join(parts)
    assert got == _lone(d, prefix, query)
    kept = {tuple(p[name][:1]) for p in done}
    assert len(kept) == 1  # every process derives the same kept rows
    assert all(p[name][2][:1] == ["process_group"] and "barrier" in p[name][2] for p in done)


def test_callers_group_is_used_and_left(dist_run, fileset):
    """A group the caller made: the call filters its rank's shard in it, and
    the group is still there afterwards (the worker asserts it)."""
    world, out, done = dist_run
    d, prefix = fileset
    assert _read(out / "caller.vcf") == _lone(d, prefix, JOBS["host"][0])
    assert sum(p["caller"][1] for p in done) == (out / "caller.vcf").stat().st_size


@pytest.fixture(scope="module")
def tpu_script_run(tmp_path_factory):
    """pgen_tpu's own two-process worker script (tests/test_distributed.py)
    with its import line alone changed: it takes the port's
    run_distributed_filter, bound to device="cpu" (the port's default is
    the card; these tests run on the CPU). Both of pgen_tpu's cases, a shared
    file and one part a process, run at once (four processes). Returns
    {shared_fs: (fileset prefix, output path)}."""
    from conftest import build_fileset
    from test_distributed import _WORKER as TPU_WORKER

    tpu_import = "from pgen_tpu.parallel.distributed import run_distributed_filter\n"
    port_import = ("import functools, pgen_tpu_torch.parallel.distributed as port; "
                   "run_distributed_filter = functools.partial("
                   "port.run_distributed_filter, device='cpu')\n")
    assert TPU_WORKER.count(tpu_import) == 1
    d = tmp_path_factory.mktemp("tpu_script")
    prefix = _tiny_fileset(d, build_fileset)
    runs, cmds = {}, []
    for shared_fs in (True, False):
        out = d / f"dist-{shared_fs}.vcf"
        script = TPU_WORKER.replace(tpu_import, port_import).format(
            repo=str(REPO), prefix=prefix, var_query='REF == "A"' if shared_fs else None,
            out=str(out), port=_free_port(), n=2, shared_fs=shared_fs)
        cmds += [[sys.executable, "-c", script, str(i)] for i in range(2)]
        runs[shared_fs] = (prefix, out)
    _spawn(cmds, REPO)
    return runs


def _tiny_fileset(d: Path, build_fileset) -> str:
    """conftest.py's tiny_fileset (5 variants x 6 samples, every code)."""
    import numpy as np

    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=(5, 6), dtype=np.uint8)
    codes[0, :4] = [0, 1, 2, 3]
    pvar_rows = [f"1\t{100+i}\trs{i}\tA\tG\t100\tPASS\tAF=0.{i}" for i in range(5)]
    psam_rows = [f"s{i}\t{'F' if i % 2 else 'M'}" for i in range(6)]
    return build_fileset(d, "tiny", codes, pvar_rows, psam_rows)


@pytest.mark.parametrize("shared_fs", [True, False], ids=["shared", "parts"])
def test_pgen_tpu_worker_script_runs_against_the_port(tpu_script_run, shared_fs):
    """pgen_tpu's script against the port (``tpu_script_run``): the keyword
    surface it calls is pgen_tpu's, and the output is pgen_tpu's tests'
    scalar oracle's, the shared file or the parts concatenated."""
    from oracle import scalar_filter_vcf

    prefix, out = tpu_script_run[shared_fs]
    if shared_fs:
        assert out.read_bytes() == scalar_filter_vcf(prefix, lambda v: v["REF"] == "A", None)
    else:
        got = b"".join(Path(f"{out}.shard{i}").read_bytes() for i in range(2))
        assert got == scalar_filter_vcf(prefix, None, None)


def test_lone_process_is_one_shard_without_a_group(fileset, tmp_path, monkeypatch):
    """Neither arguments nor environment name a group: one shard of one,
    the lone filter's bytes, and no group made."""
    import torch.distributed as dist

    for k in ("RANK", "WORLD_SIZE", "PGEN_TPU_COORDINATOR", "PGEN_TPU_NUM_PROCS",
              "PGEN_TPU_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    d, prefix = fileset
    query = JOBS["device"][0]
    res = port_dist.run_distributed_filter(prefix, **query, out_file=tmp_path / "one.vcf",
                                           provider="device", block_variants=4, device="cpu")
    assert not dist.is_initialized()
    assert _read(tmp_path / "one.vcf") == _lone(d, prefix, query)
    assert res.bytes_written == (tmp_path / "one.vcf").stat().st_size


@pytest.mark.parametrize("env,args,want", [
    ({}, {}, None),
    ({"PGEN_TPU_COORDINATOR": "h:1", "PGEN_TPU_NUM_PROCS": "4", "PGEN_TPU_PROC_ID": "2"}, {},
     (2, 4, "tcp://h:1")),
    ({"RANK": "1", "WORLD_SIZE": "3"}, {}, (1, 3, "env://")),
    ({"RANK": "1", "WORLD_SIZE": "3", "PGEN_TPU_COORDINATOR": "h:1", "PGEN_TPU_NUM_PROCS": "4",
      "PGEN_TPU_PROC_ID": "2"}, {}, (2, 4, "tcp://h:1")),
    ({"PGEN_TPU_COORDINATOR": "h:1", "PGEN_TPU_NUM_PROCS": "4", "PGEN_TPU_PROC_ID": "2"},
     {"coordinator_address": "g:2", "num_processes": 2, "process_id": 0}, (0, 2, "tcp://g:2")),
    ({"RANK": "1", "WORLD_SIZE": "3"}, {"process_id": 2}, (2, 3, "env://")),
], ids=["none", "pgen_tpu_env", "torchrun_env", "pgen_tpu_before_torchrun", "arguments_first",
        "argument_and_env"])
def test_group_from_arguments_then_pgen_tpu_then_torchrun(monkeypatch, env, args, want):
    for k in ("RANK", "WORLD_SIZE", "PGEN_TPU_COORDINATOR", "PGEN_TPU_NUM_PROCS",
              "PGEN_TPU_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert port_dist._group_spec(**args) == want


def test_coordinator_without_ranks_is_an_error(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "PGEN_TPU_NUM_PROCS", "PGEN_TPU_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="without a process count"):
        port_dist._group_spec(coordinator_address="localhost:1")
