"""A rank 1..n-1 of a CPU test run, with a fault planted first:

    python rank_child.py <job kind> <fault or "none"> <run.py's arguments>

The fault ``loads_jax`` puts a module named ``jax`` into the rank's
``sys.modules``, as a rank whose imports pulled JAX in would.
"""

import sys
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness  # noqa: E402
from benchmark.run import parse  # noqa: E402
from benchmark.tests.faults import plant  # noqa: E402

if __name__ == "__main__":
    kind, fault = sys.argv[1:3]
    if fault == "loads_jax":
        sys.modules["jax"] = types.ModuleType("jax")
    elif fault != "none":
        plant(kind, fault)
    sys.exit(harness.child_main(parse(sys.argv[3:]), device_type="cpu"))
