"""glm, score, king, genome and pca of the port over variant shards: one
process per rank in a gloo group, against the port run alone and against
pgen_tpu's mesh steps.

Each launch spawns W ranks as torchrun-style subprocesses (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT; LOCAL_RANK reversed), which make one
gloo group with a 60 s timeout and run every case inside it with
``--device cpu``: each CLI command of ``CASES`` (rank 0 writes), then the
ops' mesh functions on the rank's shard of the records (``shard_range``).
W = 2 and 3 (3 gives uneven shards); the ``*_tiny`` cases keep 2 variants,
so at W = 3 one rank holds none. The port alone runs each command in this
process (no group); pgen_tpu runs its CLI with ``--provider device`` and
its mesh functions on the 8 virtual CPU devices of conftest.py, which is
its mesh path.

Tolerances: king's and genome's files byte for byte and the king and ibd
Grams exact; glm tables at pgen_tpu's device-vs-numpy bounds (BETA/SE rtol
1e-3 atol 1e-5, T/P rtol 1e-2 atol 1e-3; tests/test_glm.py:94-95) with
TEST, OBS_CT and the NA cells exact; .sscore sums, averages and dosage sums
at 2e-5 with ALLELE_CT exact; pca eigenvectors at atol 5e-5 and eigenvalues
at rtol 1e-3 (--approx) or atol 5e-5 (tests/test_pca.py:176, :265), the
.rel.bin within 1e-6 of its largest entry against the port alone and at
2e-5 against pgen_tpu's f32 GRM, m_used exact; f32 moments, GRM sums and
score sums of the mesh functions at pgen_tpu's 2e-5.
"""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from conftest import build_fileset
from pgen_tpu.cli import main as tpu_main
from pgen_tpu.ops import glm as tpu_glm
from pgen_tpu.ops import ibd as tpu_ibd
from pgen_tpu.ops import king as tpu_king
from pgen_tpu.ops import pca as tpu_pca
from pgen_tpu.ops import score as tpu_score
from pgen_tpu_torch.cli import main as port_main
from test_torch_relatedness import _planted_codes

REPO = Path(__file__).resolve().parent.parent
N_VAR, N_SAMPLES = 203, 29
COHORT = [0, 1, 2, 3, 5, 8, 11, 12, 17, 20, 21, 26, 28]
TINY = ["-r", "1:100-110"]  # the first two variants

# name -> (argv after the subcommand's input, how the outputs compare)
CASES = {
    "king": (["king"], "bytes"),
    "king_cutoff": (["king", "--samples-file", "{d}/cohort.txt", "--cutoff", "0.1"], "bytes"),
    "genome": (["genome"], "bytes"),
    "genome_cohort": (["genome", "--samples-file", "{d}/cohort.txt", "--min-pi-hat", "0.05"],
                      "bytes"),
    "pca": (["pca", "-k", "3", "--make-rel", "bin"], "pca"),
    "pca_approx": (["pca", "-k", "2", "--approx", "--approx-iters", "12", "--seed", "5"], "pca"),
    "glm": (["glm", "--pheno-name", "QT", "--covar-name", "C1,C2"], "glm"),
    "glm_genotypic": (["glm", "--pheno-name", "QT0", "--covar-name", "C1", "--modifier",
                       "genotypic", "--samples-file", "{d}/cohort.txt"], "glm"),
    "score": (["score", "--score", "{d}/w.tsv", "--score-col-nums", "3-4", "--score-sums"],
              "score"),
    "score_no_mean": (["score", "--score", "{d}/w.tsv", "--score-col-nums", "3-4",
                       "--score-sums", "--no-mean-imputation"], "score"),
    "score_cohort_center": (["score", "--score", "{d}/w.tsv", "--score-col-nums", "3-4",
                             "--samples-file", "{d}/cohort.txt", "--center"], "score"),
    "score_q_range": (["score", "--score", "{d}/w.tsv", "--score-col-nums", "3-4", "--center",
                       "--q-score-range", "{d}/ranges.txt", "{d}/pvals.txt"], "score"),
    "king_tiny": (["king", *TINY], "bytes"),
    "genome_tiny": (["genome", *TINY], "bytes"),
    "pca_tiny": (["pca", "-k", "2", "--make-rel", "bin", *TINY], "pca"),
    "glm_tiny": (["glm", "--pheno-name", "QT", "--covar-name", "C1", *TINY], "glm"),
    "score_tiny": (["score", "--score", "{d}/w.tsv", "--score-sums", *TINY], "score"),
}
OUTPUTS = {"bytes": ("", ".king.cutoff.in.id", ".king.cutoff.out.id"),
           "pca": (".eigenvec", ".eigenval", ".rel.bin", ".rel.id"), "glm": ("",),
           "score": ("", ".low.sscore", ".high.sscore")}


@pytest.fixture(scope="module")
def fileset(tmp_path_factory):
    """Planted relatedness codes (tests/test_torch_relatedness.py) with QT
    (2 NA), QT0, CC (1/2, a logistic phenotype) and covariates C1, C2 in the
    .psam; a two-column weight table over every other variant, half the
    effect alleles REF; a 13-sample cohort; --q-score-range tables."""
    d = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(29)
    codes = _planted_codes(N_VAR, N_SAMPLES, 29)
    qt = [f"{v:.6g}" for v in rng.normal(size=N_SAMPLES)]
    qt[3] = qt[17] = "NA"
    psam = [f"s{i}\t{'MF'[i % 2]}\t{qt[i]}\t{rng.normal():.6g}\t{1 + i % 2}\t"
            f"{rng.normal():.6g}\t{rng.normal(50.0, 8.0):.6g}" for i in range(N_SAMPLES)]
    pvar = [f"1\t{100 + 10 * i}\trs{i}\tA\tG\t.\tPASS\t." for i in range(N_VAR)]
    prefix = build_fileset(d, "m", codes, pvar, psam,
                           psam_columns="#IID\tSEX\tQT\tQT0\tCC\tC1\tC2")
    (d / "w.tsv").write_text("ID\tA1\tW1\tW2\n" + "".join(
        f"rs{i}\t{'AG'[i % 4 == 0]}\t{rng.normal():.5g}\t{rng.normal():.5g}\n"
        for i in range(0, N_VAR, 2)))
    (d / "cohort.txt").write_text("".join(f"s{i}\n" for i in COHORT))
    # --q-score-range: a low and a high range of a P column, and an empty one
    (d / "ranges.txt").write_text("low 0 0.3\nhigh 0.3 1\nnone 5 6\n")
    (d / "pvals.txt").write_text("ID\tP\n" + "".join(f"rs{i}\t{rng.random():.4f}\n"
                                                    for i in range(N_VAR)))
    return d, prefix


def _argv(name, d, prefix, out):
    argv, _ = CASES[name]
    return [argv[0], prefix, *(a.format(d=d) for a in argv[1:]), "-o", str(out)]


def _records(prefix):
    rec = (2 * N_SAMPLES + 7) // 8
    return np.fromfile(f"{prefix}.pgen", dtype=np.uint8, offset=12).reshape(N_VAR, rec)


def _glm_inputs(prefix):
    """QT's cohort (its called samples), QT and C1, C2 over it."""
    rows = [ln.split("\t") for ln in open(f"{prefix}.psam").read().splitlines()[1:]]
    cohort = np.array([i for i, r in enumerate(rows) if r[2] != "NA"], dtype=np.int32)
    y = np.array([float(rows[i][2]) for i in cohort])
    covars = np.array([[float(rows[i][5]), float(rows[i][6])] for i in cohort])
    return cohort, y, covars


def _ops_inputs(d, prefix):
    rng = np.random.default_rng(31)
    cohort, y, covars = _glm_inputs(prefix)
    inputs = dict(packed=_records(prefix), num_samples=N_SAMPLES,
                  cohort=np.array(COHORT, dtype=np.int32), glm_cohort=cohort, y=y, covars=covars,
                  weights=rng.normal(size=(N_VAR, 2)).astype(np.float32),
                  flip=rng.random(N_VAR) < 0.5)
    np.savez(d / "ops.npz", **inputs)
    return inputs


_WORKER = r"""
import contextlib, datetime, io, json, os, sys
import numpy as np
import torch.distributed as dist

spec_path = sys.argv[1]
spec = json.load(open(spec_path))
dist.init_process_group("gloo", init_method="env://", rank=int(os.environ["RANK"]),
                        world_size=int(os.environ["WORLD_SIZE"]),
                        timeout=datetime.timedelta(seconds=60))
rank, world = dist.get_rank(), dist.get_world_size()
from pgen_tpu_torch.cli import main
from pgen_tpu_torch.ops import glm, ibd, king, pca, score
from pgen_tpu_torch.parallel.mesh import shard_range

printed = {}
for name, argv in spec["cli"].items():
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    printed[name] = [rc, out.getvalue(), err.getvalue()]

inp = np.load(spec["ops"])
packed, n = inp["packed"], int(inp["num_samples"])
res = {}
for tag, rows in (("tiny_", 2), ("", len(packed))):
    lo, hi = shard_range(rows, rank, world)
    mine = packed[lo:hi]
    res[tag + "king"] = king.king_counts_mesh(mine, n, "cpu", block_variants=64,
                                              sample_idx=inp["cohort"])
    res[tag + "ibd"] = ibd.ibd_counts_mesh(mine, n, "cpu", block_variants=64)
res["grm"] = pca.grm_mesh(mine, n, "cpu", block_variants=48)
res["score"] = score.score_mesh(mine, n, inp["weights"][lo:hi], inp["flip"][lo:hi], "cpu",
                                block_variants=48, sample_idx=inp["cohort"])
res["score_no_mean"] = score.score_mesh(mine, n, inp["weights"][lo:hi], inp["flip"][lo:hi],
                                        "cpu", mean_impute=False, block_variants=48)
res["glm"] = glm.glm_moments_mesh(mine, n, inp["y"], inp["covars"], "cpu", block_variants=48,
                                  sample_idx=inp["glm_cohort"])
res["glm_geno"] = glm.glm_geno_moments_mesh(mine, n, inp["y"], inp["covars"], "cpu",
                                            block_variants=48, sample_idx=inp["glm_cohort"])
approx = pca.pca_approx(mine, n, 2, "cpu", block_variants=48, iters=8, seed=3)
res["approx"] = approx
flat = {f"{k}.{i}": np.asarray(v) for k, t in res.items() for i, v in enumerate(t)}
np.savez(f"{spec_path}.rank{rank}.npz", **flat)
json.dump(printed, open(f"{spec_path}.rank{rank}.json", "w"))
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pgen_tpu"))
assert not loaded, f"a rank loaded {loaded[:5]}"
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world: int, spec_path: Path) -> None:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "LOCAL_RANK")
           and not k.startswith("PGEN_TPU_")}
    env.update(PYTHONPATH=str(REPO), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world))
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(spec_path)],
                env={**env, "RANK": str(r), "LOCAL_RANK": str(world - 1 - r)},
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=str(spec_path.parent)))
        for p in procs:
            _, err = p.communicate(timeout=180)
            assert p.returncode == 0, err.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module", params=[2, 3], ids=["2ranks", "3ranks"])
def ranks_run(request, fileset):
    """Every case run once by one launch of W ranks. Returns (world, output
    dir, each rank's printed [rc, stdout, stderr] by case, each rank's mesh
    results)."""
    world = request.param
    d, prefix = fileset
    out = d / f"w{world}"
    out.mkdir()
    _ops_inputs(d, prefix)
    cli = {name: _argv(name, d, prefix, out / name) + ["--device", "cpu", "--stats"]
           for name in CASES}
    cli["glm_logistic"] = ["glm", prefix, "--pheno-name", "CC", "--device", "cpu",
                           "-o", str(out / "glm_logistic")]
    spec = out / "spec.json"
    spec.write_text(json.dumps({"cli": cli, "ops": str(d / "ops.npz")}))
    _spawn(world, spec)
    printed = [json.loads(Path(f"{spec}.rank{r}.json").read_text()) for r in range(world)]
    mesh = [dict(np.load(f"{spec}.rank{r}.npz")) for r in range(world)]
    return world, out, printed, mesh


@pytest.fixture(scope="module")
def references(fileset):
    """Each case's outputs from the port alone (no process group) and from
    pgen_tpu's CLI with --provider device (its mesh path), and the m_used
    of the port's pca runs."""
    d, prefix = fileset
    for name in ("RANK", "WORLD_SIZE", "PGEN_TPU_NUM_PROCS"):
        assert name not in os.environ
    alone, tpu = d / "alone", d / "tpu"
    alone.mkdir()
    tpu.mkdir()
    m_used = {}
    for name in CASES:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert port_main(_argv(name, d, prefix, alone / name) + ["--device", "cpu"]) == 0
        m_used[name] = err.getvalue()
        assert tpu_main(_argv(name, d, prefix, tpu / name) + ["--provider", "device"]) == 0
    return alone, tpu, m_used


def _files(out_dir, name):
    return [(suffix, out_dir / f"{name}{suffix}") for suffix in OUTPUTS[CASES[name][1]]
            if (out_dir.parent / "alone" / f"{name}{suffix}").exists()]


def _rows(path):
    return [ln.split("\t") for ln in path.read_text().splitlines()]


def _assert_glm(a, b):
    ra, rb = _rows(a), _rows(b)
    assert ra[0] == rb[0] and len(ra) == len(rb) > 1
    for x, y in zip(ra[1:], rb[1:]):
        assert x[:8] == y[:8] and [c == "NA" for c in x] == [c == "NA" for c in y]
        for col, (u, w) in enumerate(zip(x[8:], y[8:])):
            if u != "NA":
                tol = dict(rtol=1e-3, atol=1e-5) if col < 2 else dict(rtol=1e-2, atol=1e-3)
                np.testing.assert_allclose(float(u), float(w), **tol)


def _assert_score(a, b):
    ra, rb = _rows(a), _rows(b)
    assert ra[0] == rb[0] and len(ra) == len(rb) > 1
    for x, y in zip(ra[1:], rb[1:]):
        assert x[:2] == y[:2]  # IID and ALLELE_CT
        np.testing.assert_allclose(np.float64(x[2:]), np.float64(y[2:]), rtol=2e-5, atol=2e-5)


def _m_used(stderr: str) -> int:
    line = next(ln for ln in stderr.splitlines() if ln.startswith("pca: "))
    return int(line.split(" x ")[1].split()[0])


def _assert_pca(name, got, want, against_port):
    suffix = got.name[len(name):]
    if suffix == ".rel.id":
        assert got.read_text() == want.read_text()
    elif suffix == ".rel.bin":
        g, w = np.fromfile(got, "<f8"), np.fromfile(want, "<f8")
        if against_port:
            assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()
        else:
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5)
    elif suffix == ".eigenval":
        g, w = np.loadtxt(got, ndmin=1), np.loadtxt(want, ndmin=1)
        np.testing.assert_allclose(g, w, **(dict(rtol=1e-3) if "approx" in name
                                             else dict(atol=5e-5)))
    else:
        (hg, *rg), (hw, *rw) = _rows(got), _rows(want)
        assert hg == hw and [r[0] for r in rg] == [r[0] for r in rw]
        np.testing.assert_allclose(np.float64([r[1:] for r in rg]),
                                   np.float64([r[1:] for r in rw]), atol=5e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_match_the_port_alone_and_pgen_tpu(ranks_run, references, name):
    """Every output of the case against the port alone and against
    pgen_tpu's --provider device: king and genome byte for byte, the others
    at the module's tolerances."""
    world, out, printed, _ = ranks_run
    alone, tpu, stderr_alone = references
    kind = CASES[name][1]
    files = _files(out, name)
    assert files
    for suffix, got in files:
        for ref in (alone, tpu):
            want = ref / f"{name}{suffix}"
            if kind == "bytes":
                assert got.read_bytes() == want.read_bytes(), (suffix, ref.name)
            elif kind == "glm":
                _assert_glm(got, want)
            elif kind == "score":
                _assert_score(got, want)
            else:
                _assert_pca(name, got, want, against_port=ref is alone)
    if kind == "pca":
        assert _m_used(printed[0][name][2]) == _m_used(stderr_alone[name])


@pytest.mark.parametrize("name", list(CASES))
def test_rank0_alone_prints(ranks_run, name):
    """Rank 0 prints the --stats report (the group's set-up, the collective,
    one line a rank naming its device and rows) and the summary line; every
    other rank prints nothing; every rank exits 0."""
    world, _, printed, _ = ranks_run
    rc, stdout, stderr = printed[0][name]
    assert rc == 0 and stdout == ""
    assert "process_group:" in stderr
    collective = "all_gather:" if name.startswith("glm") else "all_reduce:"
    assert collective in stderr
    for r in range(world):
        assert f"rank {r} on cpu (host), rows [" in stderr
    assert stderr.strip().splitlines()[-1].startswith(f"{CASES[name][0][0]}: ")
    for other in printed[1:]:
        assert other[name] == [0, "", ""]


def test_logistic_glm_refused_under_ranks(ranks_run):
    """A case/control phenotype makes glm logistic, which has no mesh step:
    every rank exits 2 naming ROADMAP §1 item 17, and nothing is written."""
    world, out, printed, _ = ranks_run
    assert [p["glm_logistic"][0] for p in printed] == [2] * world
    assert "logistic glm under" in printed[0]["glm_logistic"][2]
    assert "ROADMAP §1 item 17" in printed[0]["glm_logistic"][2]
    assert not list(out.glob("glm_logistic*"))


@pytest.fixture(scope="module")
def tpu_mesh(fileset):
    """pgen_tpu's mesh functions over the 8 virtual CPU devices on the same
    inputs as the ranks' (``_ops_inputs``)."""
    import jax

    assert len(jax.devices()) == 8
    d, prefix = fileset
    inp = _ops_inputs(d, prefix)
    p, n = inp["packed"], N_SAMPLES
    return {
        "king": tpu_king.king_counts_mesh(p, n, block_variants=128, sample_idx=inp["cohort"]),
        "ibd": tpu_ibd.ibd_counts_mesh(p, n, block_variants=128),
        "tiny_king": tpu_king.king_counts_mesh(p[:2], n, sample_idx=inp["cohort"]),
        "tiny_ibd": tpu_ibd.ibd_counts_mesh(p[:2], n),
        "grm": tpu_pca.grm_mesh(p, n, block_variants=64),
        "score": tpu_score.score_mesh(p, n, inp["weights"], inp["flip"], block_variants=64,
                                      sample_idx=inp["cohort"]),
        "score_no_mean": tpu_score.score_mesh(p, n, inp["weights"], inp["flip"],
                                              mean_impute=False, block_variants=64),
        "glm": tpu_glm.glm_moments_mesh(p, n, inp["y"], inp["covars"], block_variants=64,
                                        sample_idx=inp["glm_cohort"]),
        "glm_geno": tpu_glm.glm_geno_moments_mesh(p, n, inp["y"], inp["covars"],
                                                  block_variants=64,
                                                  sample_idx=inp["glm_cohort"]),
        "approx": tpu_pca.pca_approx(p, n, 2, provider="device", block_variants=64, iters=8,
                                     seed=3),
    }


EXACT = {"king", "ibd", "tiny_king", "tiny_ibd"}


@pytest.mark.parametrize("name", ["king", "ibd", "tiny_king", "tiny_ibd", "grm", "score",
                                  "score_no_mean", "glm", "glm_geno", "approx"])
def test_mesh_functions_match_pgen_tpu(ranks_run, tpu_mesh, name):
    """Every rank's result of the port's mesh function equals rank 0's bit
    for bit (the --approx eigenvectors included: every pass starts from
    rank 0's q), and rank 0's is pgen_tpu's: exact for the count Grams,
    2e-5 for the f32 sums, eigenvalues at rtol 1e-3 for --approx."""
    world, _, _, mesh = ranks_run
    want = tpu_mesh[name]
    fields = sorted((k for k in mesh[0] if k.split(".")[0] == name),
                    key=lambda k: int(k.split(".")[1]))
    assert len(fields) == len(want)
    for r in range(1, world):
        for k in fields:
            np.testing.assert_array_equal(mesh[r][k], mesh[0][k])
    for k, w in zip(fields, want):
        got, w = mesh[0][k], np.asarray(w)
        if name == "approx":
            if k.endswith(".0"):
                np.testing.assert_allclose(got, w, rtol=1e-3)
            elif k.endswith(".1"):
                assert all(abs(float(got[:, c] @ w[:, c])) > 1 - 1e-4 for c in range(2))
            else:
                assert int(got) == int(w)
        elif name in EXACT or got.dtype.kind in "iu" or w.ndim == 0:
            np.testing.assert_array_equal(got, w)
        else:
            np.testing.assert_allclose(got, w, rtol=2e-5, atol=2e-5)
