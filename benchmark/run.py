"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``'s
``workloads``; ``harness.py`` says what a run does. It needs as many CUDA
cards as the cell names and exits non-zero, printing no result, without
them. The last line of stdout is the result's JSON; the last lines of
stderr are the numbers its correctness was judged by, each beside its
limit. (``--rank``, ``--world``, ``--port`` and ``--workdir`` are for the
ranks 1..n-1 that a run starts on its other cards.)
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402  (sets the set-up clock's start)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        if args.rank:
            return harness.child_main(args)
        cell = harness.load_cell(args.workload)
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{args.workload} needs {cell.chips} CUDA card(s); {have} available",
                  file=sys.stderr)
            return 2
        result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except Exception as exc:  # the run failed: the traceback, and no result
        return harness.fail(exc)
    return harness.report(result)


if __name__ == "__main__":
    sys.exit(main())
