"""One run of one cell: set-up, the measured window, the check, the result.

A cell names a configuration (``configs/<config>.json``: the fileset's
shape and the cards it runs on) and a traffic mix
(``traffic/<traffic>.json``: the job kind, its parameters and the limits of
its check). The job kind's driver is ``jobs/<job>.py``, its plain reference
``reference/<job>.py`` and its least device time ``roofline/<job>.py``;
each metric is read by ``metrics/<name>.py``. All of them are found by the
names in ``BENCHMARK.json``, so a cell, a traffic mix or a metric is added
by adding files and entries.

A run, on each of the cell's cards (rank 0 is this process, ranks 1..n-1
processes it starts, one a card, in one NCCL group made once):

1. set-up: imports, the kernels' library (built into the checkout's
   ``build/`` on a first run), the fileset drawn from the seed into a fresh
   directory under ``TMPDIR``, and one warm-up job at the cell's shapes;
2. the window: jobs one after another, closed loop, until ``seconds`` have
   passed; the job running then is finished and counted. With ``--trace
   1`` the profiler runs over the window (``trace.py``);
3. the peak device memory is read, every rank's readings are gathered to
   rank 0, and ranks 1..n-1 end;
4. rank 0 checks the answers of the window's jobs against the plain
   reference (``Job.check``), then prints each compared number beside its
   limit on stderr and the result as one JSON line on stdout.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from contextlib import nullcontext
from dataclasses import asdict, dataclass
from pathlib import Path

T0 = time.perf_counter()  # the process's start, as near as Python sees it

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pgen_tpu")
GROUP_TIMEOUT_S = 120  # a rank that died ends the others' collectives after this
CHILD_WAIT_S = 60


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the cell's entries of BENCHMARK.json's end_to_end
    per_layer: list  # and of its per_layer


@dataclass
class Ctx:
    """What a job driver is given."""

    cell: Cell
    seed: int
    device: object  # torch.device of this rank
    rank: int
    world: int
    prefix: Path
    out_dir: Path

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


@dataclass
class Run:
    """What a metric reader (``metrics/<name>.py``: ``read(run)``) is given."""

    cell: Cell
    jobs: int
    window_s: float  # host clock: window start to the end of its last job
    setup_s: float
    stages: list  # rank 0's StageTimer seconds by stage, a dict a job
    least_s: list  # each job's least device time (roofline/)
    ranks: list  # each rank's {"setup_peak_bytes", "window_peak_bytes", "trace"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or
    pgen_tpu (whole names: pgen_tpu_torch is not pgen_tpu)."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def native_loaded() -> bool:
    """Whether the program's C++ runtime (``pgen_tpu_torch.native``) loaded."""
    from pgen_tpu_torch.native import HAVE_NATIVE

    return bool(HAVE_NATIVE)


def load_cell(name: str, bench: Path = ROOT / "BENCHMARK.json") -> Cell:
    spec = json.loads(bench.read_text())
    work = next((w for w in spec["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in {bench}")
    conf = next(c for c in spec["configs"] if c["name"] == work["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{work['traffic']}.json").read_text())

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(name, work["chips"], config, traffic,
                [m for m in spec["end_to_end"] if mine(m)],
                [m for m in spec["per_layer"] if mine(m)])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _set_cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout (the program's own
    build directory is ``build/pgen_tpu_torch`` there already)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))


def _barrier(group) -> None:
    if group is not None:
        import torch.distributed as dist

        dist.barrier(group=group)


def setup_job(cell: Cell, seed: int, dev, rank: int, world: int, workdir: Path, ctl=None):
    """The fileset drawn from the seed (by rank 0, into ``workdir``), the
    card's peak reset, and the cell's job driver on this rank. The timed
    runs and ``readings.py`` both set a cell up through here."""
    import torch

    from benchmark.fileset import make_fileset

    prefix = workdir / "fileset" / "chr22"
    if rank == 0:
        make_fileset(prefix.parent, cell.config["num_variants"], cell.config["num_samples"],
                     seed, dev, cell.traffic.get("plant_pairs", 0),
                     cell.traffic.get("plant_redraw", 0.0))
    if dev.type == "cuda":
        # the peak is the program's from here: the fileset's records were
        # drawn on this card
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    _barrier(ctl)
    ctx = Ctx(cell, seed, dev, rank, world, prefix, workdir / "out")
    ctx.out_dir.mkdir(exist_ok=True)
    return importlib.import_module(f"benchmark.jobs.{cell.traffic['job']}").Job(ctx)


def _rank(cell: Cell, seed: int, seconds: float, trace: bool, device_type: str, rank: int,
          world: int, port: int | None, workdir: Path):
    """Steps 1-3 of the module's docstring on this rank; returns (job, records,
    gathered readings (rank 0; None elsewhere), setup_s, each job's end in
    seconds from the window's start)."""
    import torch

    from benchmark import trace as tr

    cuda = device_type == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    ctl = None
    if world > 1:
        from datetime import timedelta

        import torch.distributed as dist

        kw = {"device_id": dev} if cuda else {}
        dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=GROUP_TIMEOUT_S), **kw)
        # the harness's own messages go over gloo, so that no NCCL kernel
        # of its own lands in the trace
        ctl = dist.new_group(backend="gloo") if cuda else dist.group.WORLD
    try:
        job = setup_job(cell, seed, dev, rank, world, workdir, ctl)
        # the warm-up job, under the profiler when tracing, whose first
        # start sets up its device tracing
        with tr.Window(dev) if trace else nullcontext():
            job.run(-1)
        if cuda:
            torch.cuda.synchronize(dev)
            setup_peak = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        else:
            setup_peak = 0
        _barrier(ctl)

        start = time.perf_counter()
        records, ends, last = [], [], start
        window = tr.Window(dev) if trace else None
        with window or nullcontext():
            while True:
                go = torch.tensor([int(not records or last - start < seconds)])
                if ctl is not None:
                    dist.broadcast(go, src=0, group=ctl)
                if not go.item():
                    break
                with tr.job_range() if trace else nullcontext():
                    records.append(job.run(len(records)))
                last = time.perf_counter()
                ends.append(last - start)
        setup_s = start - T0
        reading = {
            "setup_peak_bytes": setup_peak,
            "window_peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0,
            "trace": window.summary() if trace else None,
        }
        gathered = [reading]
        if ctl is not None:
            gathered = [None] * world if rank == 0 else None
            dist.gather_object(reading, gathered, dst=0, group=ctl)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        return job, records, gathered, setup_s, ends
    finally:
        if world > 1 and dist.is_initialized():
            dist.destroy_process_group()


def _result(cell: Cell, device_type: str, world: int, trace: bool, run: Run, checked: int,
            failed: int, numbers: dict) -> dict:
    import torch

    limits = cell.traffic["limits"]
    correct = failed == 0 and checked > 0 and all(numbers[k] <= limits[k] for k in limits)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = importlib.import_module(f"benchmark.metrics.{m['name']}").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    peaks = [max(r["setup_peak_bytes"], r["window_peak_bytes"]) for r in run.ranks]
    device = {
        "platform": "gpu" if device_type == "cuda" else device_type,
        "kind": torch.cuda.get_device_name(0) if device_type == "cuda" else "cpu",
        "count": world,
        "memory_peak_bytes": max(peaks),
    }
    out = {"correct": correct, "attempted": run.jobs, "failed": failed, "metrics": metrics,
           "device": device}
    if trace:
        traces = [r["trace"] for r in run.ranks]
        device["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        device["window_s"] = traces[0]["window_s"]
        out["breakdown"] = {"device_ops": traces[0]["device_ops"],
                            "idle_gaps": traces[0]["idle_gaps"]}
    # which path assembled the rows: the program's C++ runtime or, where it
    # does not load, its numpy fallback
    out["native_loaded"] = native_loaded()
    out["checked"] = checked
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device_type: str = "cuda",
             child_cmd: list | None = None) -> dict:
    """One run of ``cell`` as rank 0 (steps 1-4); returns the result. Ranks
    1..n-1 run ``child_cmd`` (default: ``run.py`` in rank mode) with
    ``--rank r --world n --port p --workdir w`` appended."""
    _set_cache_dirs()
    world = cell.chips
    workdir = Path(tempfile.mkdtemp(prefix="pgen-bench-"))
    children = []
    try:
        (workdir / "cell.json").write_text(json.dumps(asdict(cell)))
        port = _free_port() if world > 1 else None
        base = child_cmd or [sys.executable, str(HERE / "run.py"), "--workload", cell.name,
                             "--seed", str(seed), "--seconds", str(seconds),
                             "--trace", str(int(trace))]
        for r in range(1, world):
            with open(workdir / f"rank{r}.err", "wb") as err:
                children.append(subprocess.Popen(
                    [*base, "--rank", str(r), "--world", str(world), "--port", str(port),
                     "--workdir", str(workdir)],
                    stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL, stderr=err))
        job, records, gathered, setup_s, ends = _rank(cell, seed, seconds, trace,
                                                          device_type, 0, world, port, workdir)
        _reap(children, workdir)
        run = Run(cell, len(records), ends[-1], setup_s, [r[0] for r in records],
                  [r[1] for r in records], gathered)
        print("job ends, s: " + " ".join(f"{t:.3f}" for t in ends), file=sys.stderr)
        checked, failed, numbers = job.check()
        return _result(cell, device_type, world, trace, run, checked, failed, numbers)
    finally:
        _stop(children)
        shutil.rmtree(workdir, ignore_errors=True)


def child_main(args, device_type: str = "cuda") -> int:
    """Rank ``args.rank`` of a run that rank 0 started (steps 1-3); exits 3,
    as rank 0's ``report`` refuses, if jax, jaxlib, flax or pgen_tpu is
    loaded once the window has closed."""
    _set_cache_dirs()
    workdir = Path(args.workdir)
    cell = Cell(**json.loads((workdir / "cell.json").read_text()))
    _rank(cell, args.seed, args.seconds, bool(args.trace), device_type, args.rank, args.world,
          args.port, workdir)
    found = forbidden_modules()
    if found:  # rank 0 fails the run on this exit code (``_reap``)
        print(f"refused: rank {args.rank} loaded {', '.join(found)}", file=sys.stderr)
        return 3
    return 0


def _reap(children: list, workdir: Path) -> None:
    """Wait for ranks 1..n-1; a rank that failed fails the run, with the end
    of its stderr."""
    for r, p in enumerate(children, start=1):
        rc = p.wait(timeout=CHILD_WAIT_S)
        if rc != 0:
            tail = (workdir / f"rank{r}.err").read_bytes()[-4000:].decode(errors="replace")
            raise RuntimeError(f"rank {r} exited with {rc}:\n{tail}")


def _stop(children: list) -> None:
    for p in children:
        if p.poll() is None:
            p.terminate()
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def report(result: dict) -> int:
    """Print the compared numbers beside their limits as the last lines of
    stderr, then the result as the last line of stdout; refuse (no result,
    exit 3) if jax, jaxlib, flax or pgen_tpu is loaded."""
    found = forbidden_modules()
    if found:
        print(f"refused: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"native runtime loaded: {str(result['native_loaded']).lower()}", file=sys.stderr)
    print(f"jobs checked: {result['checked']} of {result['attempted']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {str(result['correct']).lower()}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def fail(exc: BaseException) -> int:
    traceback.print_exception(exc, file=sys.stderr)
    return 1
