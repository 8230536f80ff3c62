"""The program's spans: host wall time, bytes and kernel launches by stage.

A ``StageTimer`` belongs to one job, one call of an entry such as
``king_table`` or ``pca``. Each ``stage(name, nbytes)`` it opens appends a
``Span`` to ``timer.spans``: the name, start and end in ns of
``time.time_ns()`` (the clock torch.profiler stamps its events with), the
index of its parent (the innermost stage of the same timer still open on
the same thread), the ``nbytes`` it was opened with, and the kernel
launches made while it was the innermost span of its thread
(``book_launch``, which ``kernels.launch`` calls). ``timer.stages`` sums the
spans by name (``Stage``); ``report()`` is what ``--stats`` prints.

While a torch profiler records, each span also opens the profiler range
``stage:<name>``, so that a trace (``cli.py --profile``, the benchmark's
``--trace 1``) puts the host's time down to the same names. ``span(name)``
opens a stage on the innermost timer open on the calling thread, from code
that is handed no timer (the ops), and does nothing without one.
"""

import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

_SPANS_LOCK = threading.Lock()
_OPEN = threading.local()  # .stack: (timer, span index) open on this thread, innermost last


@dataclass
class Stage:
    seconds: float = 0.0
    bytes_moved: int = 0
    calls: int = 0
    self_seconds: float = 0.0  # seconds less the part its child spans cover
    launches: int = 0

    @property
    def gbps(self) -> float:
        return self.bytes_moved / self.seconds / 1e9 if self.seconds else 0.0


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int = 0  # 0 while open
    parent: int | None = None  # index in the timer's spans
    nbytes: int = 0  # as given to stage()
    launches: int = 0  # made while this span was its thread's innermost
    child_ns: int = 0  # the part of it its child spans cover

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def _stack() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


def _profiler_range(name: str):
    """``record_function("stage:<name>")`` while a torch profiler records,
    else None. Imports nothing: without torch loaded, no profiler runs."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return None
    return torch.profiler.record_function(f"stage:{name}")


@dataclass
class StageTimer:
    stages: dict = field(default_factory=dict)
    spans: list = field(default_factory=list)

    @contextmanager
    def stage(self, name: str, nbytes: int = 0):
        st = self.stages.setdefault(name, Stage())
        stack = _stack()
        parent = next((i for t, i in reversed(stack) if t is self), None)
        rng = _profiler_range(name) or nullcontext()
        sp = Span(name, 0, parent=parent, nbytes=nbytes)
        with _SPANS_LOCK:
            index = len(self.spans)
            self.spans.append(sp)
        entry = (self, index)
        stack.append(entry)
        try:
            # stamped next to the range's own start, with nothing allocated
            # between them (a collection there would part the two clocks)
            sp.start_ns = time.time_ns()
            with rng:
                yield st
        finally:
            if stack[-1] is entry:
                stack.pop()
            else:  # a generator left suspended inside a stage, closed late
                stack[:] = [e for e in stack if e is not entry]
            sp.end_ns = time.time_ns()
            ns = sp.end_ns - sp.start_ns
            if parent is not None:
                self.spans[parent].child_ns += ns
            st.seconds += ns / 1e9
            st.self_seconds += (ns - sp.child_ns) / 1e9
            st.bytes_moved += nbytes
            st.calls += 1
            st.launches += sp.launches

    def report(self) -> str:
        """One line a stage, each indented under its parent: the stage all
        its spans sat in, or none (top level) when they sat in several."""
        parents = defaultdict(set)
        for sp in self.spans:
            parents[sp.name].add(None if sp.parent is None else self.spans[sp.parent].name)
        children = defaultdict(list)
        for name in self.stages:
            up = parents.get(name, {None})
            children[next(iter(up)) if len(up) == 1 else None].append(name)
        lines = []

        def walk(name, depth):
            st = self.stages[name]
            line = (f"{'  ' * depth}{name}: {st.seconds*1e3:.1f} ms over {st.calls} calls, "
                    f"self {st.self_seconds*1e3:.1f} ms")
            if st.bytes_moved:
                line += f", {st.bytes_moved/1e6:.1f} MB, {st.gbps:.2f} GB/s"
            if st.launches:
                line += f", {st.launches} launches"
            lines.append(line)
            for child in children[name]:
                walk(child, depth + 1)

        for name in children[None]:
            walk(name, 0)
        return "\n".join(lines)


def span(name: str, nbytes: int = 0):
    """``stage(name, nbytes)`` of the innermost timer open on this thread;
    without one, a context that records nothing (yielding a loose Stage)."""
    stack = _stack()
    if not stack:
        return nullcontext(Stage())
    return stack[-1][0].stage(name, nbytes)


def book_launch() -> None:
    """Count one kernel launch on the innermost span open on this thread."""
    stack = getattr(_OPEN, "stack", None)
    if stack:
        timer, index = stack[-1]
        timer.spans[index].launches += 1
