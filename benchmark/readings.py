"""The two readings each limit of a cell's check is set from, on one card:

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,13 [--control]

For each seed, a fresh fileset and one job through the program, then the
job's check (the program's numbers: the lower readings) and, with
``--control``, the check with the control in the program's place (the
reference in the next precision below the configuration's, or with a
guarantee broken: the upper readings). One JSON line a seed. The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def readings(cell: harness.Cell, seed: int, control: bool) -> dict:
    """One seed's readings, on one card: a 4-card cell's job runs as its
    lone rank, which is the control's place too."""
    import torch

    dev = torch.device("cuda", 0)
    workdir = Path(tempfile.mkdtemp(prefix="pgen-readings-"))
    try:
        t0 = time.perf_counter()
        job = harness.setup_job(cell, seed, dev, 0, 1, workdir)
        job.run(0)
        t1 = time.perf_counter()
        out = {"seed": seed, "program": job.check()[2]}
        t2 = time.perf_counter()
        if control:
            out["control"] = job.check(control=True)[2]
        out["seconds"] = {"setup_and_job": t1 - t0, "check": t2 - t1,
                          "control": time.perf_counter() - t2}
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("readings need a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
