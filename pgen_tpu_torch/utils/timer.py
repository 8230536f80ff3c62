"""Per-stage wall-clock + bytes-moved counters.

The reference has no profiling at all (SURVEY.md §5); the TPU build reports
wall time and achieved GB/s per pipeline stage so kernel throughput can be
compared against the HBM roofline (BASELINE.md targets).

Copied from ``pgen_tpu/utils/timer.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Stage:
    seconds: float = 0.0
    bytes_moved: int = 0
    calls: int = 0

    @property
    def gbps(self) -> float:
        return self.bytes_moved / self.seconds / 1e9 if self.seconds else 0.0


@dataclass
class StageTimer:
    stages: dict = field(default_factory=dict)

    @contextmanager
    def stage(self, name: str, nbytes: int = 0):
        st = self.stages.setdefault(name, Stage())
        t0 = time.perf_counter()
        try:
            yield st
        finally:
            st.seconds += time.perf_counter() - t0
            st.bytes_moved += nbytes
            st.calls += 1

    def add_bytes(self, name: str, nbytes: int) -> None:
        self.stages.setdefault(name, Stage()).bytes_moved += nbytes

    def report(self) -> str:
        lines = []
        for name, st in self.stages.items():
            line = f"{name}: {st.seconds*1e3:.1f} ms over {st.calls} calls"
            if st.bytes_moved:
                line += f", {st.bytes_moved/1e6:.1f} MB, {st.gbps:.2f} GB/s"
            lines.append(line)
        return "\n".join(lines)
