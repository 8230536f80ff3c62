"""The port's device provider (pgen_tpu_torch.pipeline.mesh_filter,
``filter --provider device``) against pgen_tpu's, byte for byte.

The port runs with device="cpu", its kernels' plain PyTorch versions
making the text: in this process alone (no process group; also inside an
explicit one-rank gloo group), and over gloo as 2 and
3 ranks spawned as torchrun-style subprocesses (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT), and 3 ranks named by pgen_tpu's
variables (PGEN_TPU_COORDINATOR, ...), started in reverse with LOCAL_RANK
reversed. pgen_tpu runs its mesh filter on the
8-virtual-device CPU mesh (and on as many devices as the port has ranks for
.gz, whose BGZF members follow the (block, shard) chunks) and its numpy
provider. Filesets are made from a seed with numpy.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import build_fileset
from oracle import scalar_filter_vcf
from pgen_tpu.cli import main as tpu_main
from pgen_tpu.formats.writer import write_pgen_packed
from pgen_tpu.native import HAVE_NATIVE
from pgen_tpu.ops.gt_text import genotype_text_reference
from pgen_tpu.ops.unpack_host import unpack_codes_reference
from pgen_tpu.parallel.mesh import make_mesh
from pgen_tpu.pipeline.filter import filter_to_vcf as tpu_filter
from pgen_tpu.pipeline.mesh_filter import filter_to_vcf_mesh as tpu_mesh
from pgen_tpu.query import ExprError
from pgen_tpu_torch.cli import main as port_main
from pgen_tpu_torch.parallel.mesh import (
    build_sharded_filter_step,
    build_sharded_predicate_and_filter_step,
    pad_to_multiple,
)
from pgen_tpu_torch.pipeline.mesh_filter import (
    ROUTE_DEVICE,
    ROUTE_FALLBACK,
    ROUTE_HOST,
    filter_to_vcf_mesh,
)
from pgen_tpu_torch.query import ExprError as PortExprError
from pgen_tpu_torch.query import parse

REPO = Path(__file__).resolve().parent.parent

# test_mesh_filter.py's CONFIGS, then GT_* queries (--geno, --mind) and a
# region flag (num(POS), a builtin)
CONFIGS = [
    (None, None),
    ('ALT == "G"', None),
    ('ALT == "G"', 'IID != "s3"'),
    ('POS == "9999"', None),
    ("len(ID) == 2", None),
    ('ALT == "G" || POS == "7"', None),
    ("GT_MISSING < 10", 'SEX == "M"'),
    ('ALT != "C"', "GT_MISSING_RATE <= 0.25"),
    ("num(POS) >= 100 && num(POS) <= 300", None),
]
GZ_CONFIGS = [CONFIGS[0], CONFIGS[2], CONFIGS[3]]
BLOCK = 128


def _read(p):
    with open(p, "rb") as f:
        return f.read()


def _make_filesets(d: Path) -> dict:
    """m: 531 x 37 (test_mesh_filter.py's shape, non-multiples of every
    world size and of 4); prime: 1031 x 17 random record bytes, pad bits
    included; zero: 5 variants x 0 samples."""
    rng = np.random.default_rng(3)
    nvar, nsamp = 531, 37
    m = build_fileset(
        d, "m", rng.integers(0, 4, size=(nvar, nsamp), dtype=np.uint8),
        [f"1\t{i}\tr{i}\tA\t{rng.choice(['C', 'G'])}\t.\t.\t." for i in range(nvar)],
        [f"s{i}\t{'MF'[i % 2]}" for i in range(nsamp)],
    )
    alts = rng.choice(["G", "T"], 1031)
    prime = build_fileset(
        d, "prime", np.zeros((1031, 17), dtype=np.uint8),
        [f"1\t{i}\tv{i}\tA\t{alts[i]}\t.\t.\t." for i in range(1031)],
        [f"s{i}\tM" for i in range(17)],
    )
    write_pgen_packed(f"{prime}.pgen", rng.integers(0, 256, (1031, 5), dtype=np.uint8), 17)
    zero = build_fileset(
        d, "zero", np.zeros((5, 0), dtype=np.uint8),
        [f"1\t{i + 1}\tv{i}\tA\tC\t.\t.\t." for i in range(5)], [],
    )
    return {"m": m, "prime": prime, "zero": zero}


@pytest.fixture(scope="module")
def filesets(tmp_path_factory):
    return _make_filesets(tmp_path_factory.mktemp("meshfs"))


@pytest.fixture(scope="module")
def host_outputs(filesets, tmp_path_factory):
    """pgen_tpu's numpy-provider VCF of every CONFIGS case, and of the prime
    and zero-sample cases."""
    d = tmp_path_factory.mktemp("host")
    out = {}
    for i, (vq, sq) in enumerate(CONFIGS):
        tpu_filter(filesets["m"], var_query=vq, sam_query=sq, out_file=d / f"{i}.vcf", provider="numpy")
        out[i] = _read(d / f"{i}.vcf")
    tpu_filter(filesets["prime"], var_query='ALT == "G"', sam_query='IID != "s3"',
               out_file=d / "prime.vcf", provider="numpy")
    out["prime"] = _read(d / "prime.vcf")
    out["zero"] = scalar_filter_vcf(filesets["zero"], None, None)
    return out


# -- one rank, in this process --------------------------------------------


@pytest.mark.parametrize("case", range(len(CONFIGS)))
def test_one_rank_matches_pgen_tpu(filesets, host_outputs, tmp_path, case):
    vq, sq = CONFIGS[case]
    tpu_mesh(filesets["m"], var_query=vq, sam_query=sq, out_file=str(tmp_path / "mesh.vcf"),
             block_variants=BLOCK)
    res = filter_to_vcf_mesh(filesets["m"], var_query=vq, sam_query=sq,
                             out_file=tmp_path / "port.vcf", device="cpu", block_variants=BLOCK)
    got = _read(tmp_path / "port.vcf")
    assert got == _read(tmp_path / "mesh.vcf") == host_outputs[case]
    assert res.bytes_written == len(got)
    assert not dist.is_initialized()  # a lone call makes no group


ROUTES = [
    ('ALT == "G"', ROUTE_DEVICE),
    ('ALT == "G" || POS == "7"', ROUTE_DEVICE),
    ('!(ALT == "G") && ID <= "r3"', ROUTE_DEVICE),
    ("ALT == REF", ROUTE_DEVICE),
    ('POS == 7', ROUTE_DEVICE),
    (None, ROUTE_HOST),
    ("GT_MAF >= 0.4", ROUTE_HOST),  # GT_* statistic: not a .pvar column
    ('INFO == "."', ROUTE_DEVICE),
    ("len(ID) == 2", ROUTE_FALLBACK),  # builtin
    ("num(POS) >= 100", ROUTE_FALLBACK),  # -r region
    ('CHROM + POS == "17"', ROUTE_FALLBACK),
    ('false && ALT', ROUTE_FALLBACK),  # the host short-circuits the type check
]


@pytest.mark.parametrize("vq,route", ROUTES)
def test_route_is_decided_by_the_expression(filesets, tmp_path, vq, route):
    res = filter_to_vcf_mesh(filesets["m"], var_query=vq, out_file=tmp_path / "p.vcf",
                             device="cpu", block_variants=BLOCK)
    assert res.route == route
    tpu_filter(filesets["m"], var_query=vq, out_file=tmp_path / "h.vcf", provider="numpy")
    assert _read(tmp_path / "p.vcf") == _read(tmp_path / "h.vcf")


def test_gt_sample_query_takes_the_host_route(filesets, tmp_path):
    res = filter_to_vcf_mesh(filesets["m"], var_query='ALT == "G"',
                             sam_query="GT_MISSING_RATE <= 0.25",
                             out_file=tmp_path / "p.vcf", device="cpu")
    assert res.route == ROUTE_HOST


@pytest.mark.parametrize("vq", ["POS < 50", "ALT", '"x"'])
def test_type_errors_raise_as_on_the_host(filesets, tmp_path, vq):
    with pytest.raises(ExprError):
        tpu_mesh(filesets["m"], var_query=vq, out_file=str(tmp_path / "j.vcf"))
    with pytest.raises(PortExprError):
        filter_to_vcf_mesh(filesets["m"], var_query=vq, out_file=tmp_path / "p.vcf", device="cpu")
    assert not dist.is_initialized()


@pytest.mark.skipif(not HAVE_NATIVE, reason="BGZF output needs the C++ runtime")
@pytest.mark.parametrize("case", range(len(GZ_CONFIGS)))
def test_one_rank_gz_and_index_match_pgen_tpu(filesets, tmp_path, case):
    vq, sq = GZ_CONFIGS[case]
    tpu_mesh(filesets["m"], var_query=vq, sam_query=sq, out_file=str(tmp_path / "j.vcf.gz"),
             mesh=make_mesh(jax.devices()[:1]), block_variants=BLOCK, index=True)
    res = filter_to_vcf_mesh(filesets["m"], var_query=vq, sam_query=sq,
                             out_file=tmp_path / "p.vcf.gz", device="cpu",
                             block_variants=BLOCK, index=True)
    assert _read(tmp_path / "p.vcf.gz") == _read(tmp_path / "j.vcf.gz")
    assert _read(tmp_path / "p.vcf.gz.tbi") == _read(tmp_path / "j.vcf.gz.tbi")
    assert res.bytes_written == len(_read(tmp_path / "p.vcf.gz"))


def test_one_rank_edge_filesets(filesets, host_outputs, tmp_path):
    filter_to_vcf_mesh(filesets["prime"], var_query='ALT == "G"', sam_query='IID != "s3"',
                       out_file=tmp_path / "p.vcf", device="cpu", block_variants=89)
    assert _read(tmp_path / "p.vcf") == host_outputs["prime"]
    filter_to_vcf_mesh(filesets["zero"], out_file=tmp_path / "z.vcf", device="cpu")
    assert _read(tmp_path / "z.vcf") == host_outputs["zero"]


_RANK_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
              "PGEN_TPU_COORDINATOR", "PGEN_TPU_NUM_PROCS", "PGEN_TPU_PROC_ID")


@pytest.mark.parametrize("case", [0, 2, 6, 8], ids=["all", "device_subset", "host_gt", "fallback"])
def test_lone_process_makes_no_process_group(filesets, tmp_path, monkeypatch, case):
    """A lone ``--provider device`` call (no rank variables) never
    initialises torch.distributed, as pgen_tpu's one-process mesh filter
    sets up no distributed runtime; the bytes are pgen_tpu's."""
    def refuse(*args, **kwargs):
        raise AssertionError("a lone process initialised a process group")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    for name in _RANK_VARS:
        monkeypatch.delenv(name, raising=False)
    vq, sq = CONFIGS[case]
    argv = (["--include-var", vq] if vq else []) + (["--include-sam", sq] if sq else [])
    argv += ["--provider", "device", "--block-variants", str(BLOCK)]
    a, b = tmp_path / "port.vcf", tmp_path / "tpu.vcf"
    assert port_main(["filter", filesets["m"], *argv, "--device", "cpu", "-o", str(a)]) == 0
    assert not dist.is_initialized()
    assert tpu_main(["filter", filesets["m"], *argv, "-o", str(b)]) == 0
    assert _read(a) == _read(b)


def test_lone_process_stage_timer_keeps_process_group(filesets, tmp_path, monkeypatch):
    for name in _RANK_VARS:
        monkeypatch.delenv(name, raising=False)
    res = filter_to_vcf_mesh(filesets["m"], out_file=tmp_path / "p.vcf", device="cpu")
    assert "process_group" in res.timer.report()


@pytest.mark.parametrize("how", ["callers_group", "world_size_1_env"])
def test_explicit_one_rank_group_still_works(filesets, host_outputs, tmp_path, monkeypatch, how):
    """A caller's one-rank gloo group is used and left alone; RANK=0 and
    WORLD_SIZE=1 (a one-process launcher) make a group for the call."""
    made = []
    real = dist.init_process_group

    def counted(*args, **kwargs):
        made.append(kwargs.get("world_size"))
        return real(*args, **kwargs)

    for name in _RANK_VARS:
        monkeypatch.delenv(name, raising=False)
    if how == "callers_group":
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    else:
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", "1")
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setattr(dist, "init_process_group", counted)
    try:
        vq, sq = CONFIGS[2]
        filter_to_vcf_mesh(filesets["m"], var_query=vq, sam_query=sq,
                           out_file=tmp_path / "p.vcf", device="cpu", block_variants=BLOCK)
        assert _read(tmp_path / "p.vcf") == host_outputs[2]
        if how == "callers_group":
            assert dist.is_initialized() and made == []
        else:
            assert not dist.is_initialized() and made == [1]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_stale_longer_output_is_trimmed(filesets, host_outputs, tmp_path):
    """The output is opened without O_TRUNC (ranks share it); ftruncate
    trims what a longer earlier file left."""
    out = tmp_path / "p.vcf"
    out.write_bytes(b"x" * (len(host_outputs[1]) + 999))
    filter_to_vcf_mesh(filesets["m"], var_query='ALT == "G"', out_file=out, device="cpu")
    assert _read(out) == host_outputs[1]


def _step_inputs(world: int) -> dict:
    """test_sharding.py's step inputs for ``world`` shards of 16 and 8 rows."""
    rng = np.random.default_rng(0)
    packed = rng.integers(0, 256, size=(16 * world, 3), dtype=np.uint8)
    mask = rng.random(16 * world) < 0.4
    alts = rng.choice([b"G", b"TT", b"A"], 16 * world)
    mat = np.zeros((16 * world, 2), dtype=np.uint8)
    for i, a in enumerate(alts):
        mat[i, : len(a)] = np.frombuffer(a, np.uint8)
    lens = np.array([len(a) for a in alts], np.int32)
    return {"packed": packed, "mask": mask, "mat": mat, "lens": lens, "alt_g": alts == b"G"}


def _run_steps(inputs, rank: int, world: int) -> dict:
    """build_sharded_filter_step and build_sharded_predicate_and_filter_step
    on this rank's shard (the spawned ranks run the same lines)."""
    per = len(inputs["mask"]) // world
    sl = slice(rank * per, (rank + 1) * per)
    packed = torch.from_numpy(inputs["packed"][sl])
    text, counts, offsets = build_sharded_filter_step()(packed, torch.from_numpy(inputs["mask"][sl]))
    step = build_sharded_predicate_and_filter_step(parse('ALT == "G"'), ["ALT"])
    cols = {"ALT": (torch.from_numpy(inputs["mat"][sl]), torch.from_numpy(inputs["lens"][sl]))}
    _, pcounts, _ = step(packed, cols)
    return {"text": text.numpy(), "counts": counts, "offsets": offsets, "pcounts": pcounts}


def _check_steps(out: dict, inputs: dict, rank: int, world: int) -> None:
    """test_sharding.py's expectations: per-shard kept counts, their
    exclusive cumsum, and this shard's kept rows' text in order."""
    mask, packed = inputs["mask"], inputs["packed"]
    per = len(mask) // world
    exp_counts = [int(mask[i * per : (i + 1) * per].sum()) for i in range(world)]
    assert out["counts"].tolist() == exp_counts
    assert out["offsets"].tolist() == np.concatenate([[0], np.cumsum(exp_counts)[:-1]]).tolist()
    local = slice(rank * per, (rank + 1) * per)
    kept = np.flatnonzero(mask[local])
    want = genotype_text_reference(unpack_codes_reference(packed[local][kept], 4 * packed.shape[1]))
    assert out["text"].tolist() == want.tolist()
    alt_g = inputs["alt_g"]
    assert out["pcounts"].tolist() == [int(alt_g[i * per : (i + 1) * per].sum()) for i in range(world)]


def test_sharded_steps_one_rank():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        _check_steps(_run_steps(_step_inputs(1), 0, 1), _step_inputs(1), 0, 1)
    finally:
        dist.destroy_process_group()


def test_pad_to_multiple():
    a = np.arange(10).reshape(5, 2)
    assert pad_to_multiple(a, 5) is a
    p = pad_to_multiple(a, 4)
    assert p.shape == (8, 2) and (p[5:] == 0).all() and (p[:5] == a).all()
    assert pad_to_multiple(a, 3, axis=1).shape == (5, 3)


# -- several ranks, spawned ------------------------------------------------

_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from pgen_tpu_torch.query import parse
from pgen_tpu_torch.parallel.distributed import initialize_from_env
from pgen_tpu_torch.parallel.mesh import (
    build_sharded_filter_step,
    build_sharded_predicate_and_filter_step,
)
from pgen_tpu_torch.pipeline.mesh_filter import filter_to_vcf_mesh

spec_path = sys.argv[1]
spec = json.load(open(spec_path))
rank, world, dev = initialize_from_env(device="cpu")
results = {}
for job in spec["jobs"]:
    res = filter_to_vcf_mesh(job["prefix"], job["vq"], job["sq"], job["out"], device="cpu",
                             block_variants=job["block"], index=job["index"])
    results[job["out"]] = [res.num_variants_kept, res.bytes_written, res.route]
json.dump(results, open(f"{spec_path}.rank{rank}", "w"))

# test_torch_mesh_filter._run_steps
inputs = dict(np.load(spec["steps"]))
per = len(inputs["mask"]) // world
sl = slice(rank * per, (rank + 1) * per)
packed = torch.from_numpy(inputs["packed"][sl])
text, counts, offsets = build_sharded_filter_step()(packed, torch.from_numpy(inputs["mask"][sl]))
step = build_sharded_predicate_and_filter_step(parse('ALT == "G"'), ["ALT"])
cols = {"ALT": (torch.from_numpy(inputs["mat"][sl]), torch.from_numpy(inputs["lens"][sl]))}
_, pcounts, _ = step(packed, cols)
np.savez(f"{spec_path}.rank{rank}.npz", text=text.numpy(), counts=counts, offsets=offsets,
         pcounts=pcounts)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pgen_tpu"))
assert not loaded, f"a rank loaded {loaded[:5]}"
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world: int, spec_path: Path, reverse: bool) -> None:
    """Run _WORKER as ranks 0..world-1 of a gloo group, named by torchrun's
    variables; with ``reverse``, by pgen_tpu's (PGEN_TPU_COORDINATOR,
    PGEN_TPU_NUM_PROCS, PGEN_TPU_PROC_ID), the last rank started first and
    LOCAL_RANK running backwards."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "LOCAL_RANK") and not k.startswith("PGEN_TPU_")}
    env["PYTHONPATH"] = str(REPO)
    if reverse:
        env.update(PGEN_TPU_COORDINATOR=f"127.0.0.1:{port}", PGEN_TPU_NUM_PROCS=str(world))
    else:
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world))
    procs = []
    try:
        for r in (range(world - 1, -1, -1) if reverse else range(world)):
            rank_env = ({"PGEN_TPU_PROC_ID": str(r), "LOCAL_RANK": str(world - 1 - r)} if reverse
                        else {"RANK": str(r), "LOCAL_RANK": str(r)})
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(spec_path)], env={**env, **rank_env},
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=str(spec_path.parent),
            ))
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module", params=[(2, False), (3, False), (3, True)],
                ids=["2ranks", "3ranks", "3ranks_reversed"])
def ranks_run(request, filesets, tmp_path_factory):
    """Every case of this file, run once by one group of spawned ranks.
    Returns (world, output dir, rank 0's results)."""
    world, reverse = request.param
    d = tmp_path_factory.mktemp(f"w{world}{'r' if reverse else ''}")
    spec = [
        {"prefix": filesets["m"], "vq": vq, "sq": sq, "out": str(d / f"{i}.vcf"),
         "block": BLOCK, "index": False}
        for i, (vq, sq) in enumerate(CONFIGS)
    ]
    if HAVE_NATIVE:
        spec += [
            {"prefix": filesets["m"], "vq": vq, "sq": sq, "out": str(d / f"gz{i}.vcf.gz"),
             "block": BLOCK, "index": True}
            for i, (vq, sq) in enumerate(GZ_CONFIGS)
        ]
    spec += [
        {"prefix": filesets["prime"], "vq": 'ALT == "G"', "sq": 'IID != "s3"',
         "out": str(d / "prime.vcf"), "block": 89, "index": False},
        {"prefix": filesets["zero"], "vq": None, "sq": None, "out": str(d / "zero.vcf"),
         "block": BLOCK, "index": False},
    ]
    spec_path = d / "spec.json"
    np.savez(d / "steps.npz", **_step_inputs(world))
    spec_path.write_text(json.dumps({"jobs": spec, "steps": str(d / "steps.npz")}))
    _spawn(world, spec_path, reverse)
    results = [json.loads(Path(f"{spec_path}.rank{r}").read_text()) for r in range(world)]
    return world, d, results


@pytest.mark.parametrize("case", range(len(CONFIGS)))
def test_ranks_match_pgen_tpu(ranks_run, host_outputs, case):
    world, d, results = ranks_run
    got = _read(d / f"{case}.vcf")
    assert got == host_outputs[case]
    out = str(d / f"{case}.vcf")
    # every rank counts every kept row and the same final size
    assert all(r[out][:2] == [results[0][out][0], len(got)] for r in results)


@pytest.mark.skipif(not HAVE_NATIVE, reason="BGZF output needs the C++ runtime")
@pytest.mark.parametrize("case", range(len(GZ_CONFIGS)))
def test_ranks_gz_and_index_match_pgen_tpu_mesh(ranks_run, filesets, tmp_path, case):
    """.gz at N ranks: the bytes of pgen_tpu's mesh over N devices (one BGZF
    member set per block and shard), and the same .tbi."""
    world, d, results = ranks_run
    vq, sq = GZ_CONFIGS[case]
    tpu_mesh(filesets["m"], var_query=vq, sam_query=sq, out_file=str(tmp_path / "j.vcf.gz"),
             mesh=make_mesh(jax.devices()[:world]), block_variants=BLOCK, index=True)
    assert _read(d / f"gz{case}.vcf.gz") == _read(tmp_path / "j.vcf.gz")
    assert _read(d / f"gz{case}.vcf.gz.tbi") == _read(tmp_path / "j.vcf.gz.tbi")
    assert results[0][str(d / f"gz{case}.vcf.gz")][1] == len(_read(d / f"gz{case}.vcf.gz"))
    assert not list(d.glob(f"gz{case}.vcf.gz.mesh.*"))  # part files merged and removed


def test_ranks_sharded_steps(ranks_run):
    world, d, _ = ranks_run
    for rank in range(world):
        out = dict(np.load(d / f"spec.json.rank{rank}.npz"))
        _check_steps(out, _step_inputs(world), rank, world)


@pytest.mark.parametrize("name", ["prime", "zero"])
def test_ranks_edge_filesets(ranks_run, host_outputs, name):
    _, d, _ = ranks_run
    assert _read(d / f"{name}.vcf") == host_outputs[name]


# -- the CLI ---------------------------------------------------------------


@pytest.mark.parametrize(
    "argv",
    [
        ["--include-var", 'ALT == "G"'],
        ["--include-var", 'ALT == "G"', "--samples", "s5,s1"],
        ["-r", "1:150-300", "--samples", "s0,s2"],
        ["--maf", "0.45", "--samples", "^s0"],
        ["--geno", "0.3"],
        ["--mind", "0.25", "--hwe", "0.2"],
        ["--keep", "{dir}/keep.txt", "--exclude-var", 'ALT == "C"'],
    ],
    ids=["device_predicate", "subset", "region", "maf_subset", "geno", "mind_hwe", "keep_exclude"],
)
def test_cli_provider_device_matches_pgen_tpu(filesets, tmp_path, capsys, argv):
    (tmp_path / "keep.txt").write_text("s4\ns1\ns30\n")
    argv = [a.format(dir=tmp_path) for a in argv]
    a, b = tmp_path / "port.vcf", tmp_path / "tpu.vcf"
    assert port_main(["filter", filesets["m"], *argv, "--provider", "device",
                      "--device", "cpu", "--stats", "-o", str(a)]) == 0
    assert "predicate route: " in capsys.readouterr().err
    assert tpu_main(["filter", filesets["m"], *argv, "--provider", "device", "-o", str(b)]) == 0
    assert _read(a) == _read(b)


def test_cli_provider_device_pgen_output_matches_pgen_tpu(filesets, tmp_path):
    argv = ["--maf", "0.45", "--mind", "0.3", "--out-format", "pgen", "--provider", "device"]
    assert port_main(["filter", filesets["m"], *argv, "--device", "cpu",
                      "-o", str(tmp_path / "p")]) == 0
    assert tpu_main(["filter", filesets["m"], *argv, "-o", str(tmp_path / "t")]) == 0
    for suf in (".pgen", ".pvar", ".psam"):
        assert _read(f"{tmp_path / 'p'}{suf}") == _read(f"{tmp_path / 't'}{suf}")


def test_cli_provider_device_refuses_stdout(filesets, capsys):
    argv = ["filter", filesets["m"], "--provider", "device", "-o", "-"]
    assert port_main([*argv, "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert tpu_main(argv) == 1
    assert err == capsys.readouterr().err
    assert err.startswith("pgen-tpu: error: ") and "--provider device" in err


def test_cli_provider_device_without_a_card_raises(filesets, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_main(["filter", filesets["m"], "--provider", "device",
                      "-o", str(tmp_path / "x.vcf")]) == 1
    err = capsys.readouterr().err
    assert err.startswith("pgen-tpu: error: ") and "is_available" in err and err.count("\n") == 1
    assert not dist.is_initialized()
    assert not (tmp_path / "x.vcf").exists()


@pytest.mark.skipif(not HAVE_NATIVE, reason="BGZF output needs the C++ runtime")
@pytest.mark.parametrize("threads", [2, 8])
def test_sliced_bgzf_equals_one_call(threads):
    """The device provider compresses a (block, rank) chunk in slices across
    threads; the members are those of pgen_tpu's one bgzf_compress call."""
    from concurrent.futures import ThreadPoolExecutor

    from pgen_tpu.native import native
    from pgen_tpu_torch.pipeline.filter import _bgzf

    rng = np.random.default_rng(threads)
    rows = [b"22\t%d\tsnp\tA\tG\t.\tPASS\t.\tGT" % i + b"\t0/1" * int(n) + b"\n"
            for i, n in enumerate(rng.integers(1, 60, 90_000))]
    data = np.frombuffer(b"".join(rows), dtype=np.uint8)
    with ThreadPoolExecutor(threads) as pool:
        parts = _bgzf(pool, threads, data)
    assert len(parts) == min(threads, data.nbytes // (4 << 20)) > 1
    assert b"".join(p.tobytes() for p in parts) == native.bgzf_compress(data).tobytes()
