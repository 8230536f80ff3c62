"""The profiler window of a ``--trace 1`` run and what is read from it.

``Window`` runs ``torch.profiler`` (host and device activity) around the
measured jobs, marks the window with a ``bench:window`` range, each job
with ``job`` and each of the program's StageTimer stages with
``stage:<name>`` (``StageTimer.stage`` is wrapped while the window is
open), and ``summary()`` reduces the trace to:

- ``window_s``: the length of the window;
- ``busy_s``: the time in it with a kernel, copy or memset on this
  process's card;
- ``kernel_s`` / ``nccl_s``: the summed time of kernels other than NCCL's,
  and of NCCL's;
- ``device_ops``: device time by operation, the 10 largest;
- ``idle_gaps``: the card's idle time by the host range it fell in (the
  innermost stage, else ``job`` or the harness between jobs), the 10
  largest.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

TOP = 10


def _on_device(e) -> bool:
    return "CUDA" in str(e.device_type()).upper()


def short_name(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    name = name.removeprefix("void ")
    for sep in ("(", "<"):
        head = name.split(sep, 1)[0].strip()
        if head:
            name = head
    return name


@contextlib.contextmanager
def _stage_ranges():
    """Mark every StageTimer stage with a profiler range ``stage:<name>``."""
    from torch.profiler import record_function

    from pgen_tpu_torch.utils.timer import StageTimer

    inner = StageTimer.stage

    @contextlib.contextmanager
    def stage(self, name, nbytes=0):
        with record_function(f"stage:{name}"), inner(self, name, nbytes) as st:
            yield st

    StageTimer.stage = stage
    try:
        yield
    finally:
        StageTimer.stage = inner


def job_range():
    from torch.profiler import record_function

    return record_function("job")


class Window:
    """The profiler over the measured jobs (see the module's docstring)."""

    def __init__(self, device):
        self.device = device
        self._stack = None
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._stack = contextlib.ExitStack()
        self.prof = self._stack.enter_context(profile(activities=acts))
        self._stack.enter_context(_stage_ranges())
        self._stack.enter_context(record_function("bench:window"))
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
        return self._stack.__exit__(*exc)

    def summary(self) -> dict:
        events = self.prof.profiler.kineto_results.events()
        windows = [e for e in events if e.name() == "bench:window" and not _on_device(e)]
        w0 = windows[-1].start_ns()
        w1 = w0 + windows[-1].duration_ns()
        busy, ops = [], defaultdict(int)
        kernel_ns = nccl_ns = 0
        ranges = []  # (start, end, label) of the host ranges
        # a host range (the harness's, a stage's, torch.distributed's
        # "nccl:*") also leaves a mark of the same name on the device's
        # timeline, which is no work: device events named as a host event
        # are left out
        host_names = {e.name() for e in events if not _on_device(e)}
        for e in events:
            name, start, dur = e.name(), e.start_ns(), e.duration_ns()
            end = start + dur
            if not _on_device(e):
                if name == "job" or name.startswith("stage:"):
                    ranges.append((start, end, name.removeprefix("stage:")))
                continue
            if name in host_names or end <= w0 or start >= w1:
                continue
            start, end = max(start, w0), min(end, w1)
            busy.append((start, end))
            ops[short_name(name)] += end - start
            if not name.startswith(("Memcpy", "Memset")):
                if name.startswith("nccl"):
                    nccl_ns += end - start
                else:
                    kernel_ns += end - start
        busy.sort()
        merged, gaps = [], []
        at = w0
        for start, end in busy:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
                continue
            if start > at:
                gaps.append((at, start))
            merged.append([start, end])
            at = end
        at = max(at, merged[-1][1]) if merged else w0
        if w1 > at:
            gaps.append((at, w1))
        busy_ns = sum(end - start for start, end in merged)
        return {
            "window_s": (w1 - w0) / 1e9,
            "busy_s": busy_ns / 1e9,
            "kernel_s": kernel_ns / 1e9,
            "nccl_s": nccl_ns / 1e9,
            "device_ops": _top((k, v / 1e9) for k, v in ops.items()),
            "idle_gaps": _top(_idle_by_range(gaps, ranges).items()),
        }


def _idle_by_range(gaps, ranges) -> dict:
    """Idle seconds by the host range holding each gap's middle: the
    innermost stage (the one that began last among those holding it), else
    the job, else the harness between jobs."""
    jobs = sorted(r for r in ranges if r[2] == "job")
    stages = sorted(r for r in ranges if r[2] != "job")
    job_starts, stage_starts = [r[0] for r in jobs], [r[0] for r in stages]
    out = defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        j = bisect.bisect_right(job_starts, mid) - 1
        label = "job" if j >= 0 and jobs[j][1] >= mid else "between jobs"
        j = bisect.bisect_right(stage_starts, mid) - 1
        # stages nest only a few deep: a holding stage is among the last few
        for k in range(j, max(j - 8, -1), -1):
            if stages[k][1] >= mid:
                label = stages[k][2]
                break
        out[label] += (g1 - g0) / 1e9
    return out


def _top(items) -> list:
    return [[k, v] for k, v in sorted(items, key=lambda kv: -kv[1])[:TOP]]
