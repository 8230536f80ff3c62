"""The program's spans (``pgen_tpu_torch/utils/timer.py``): the stages king
and pca open, their nesting and the entry's wall they cover, the shared
clock with torch.profiler, and the thread-local stack that ``span`` and the
launch counter read. CPU only: ``kernels.launch`` needs a card, so the
launch counter is held through the timer's own ``book_launch``."""

import contextlib
import gc
import json
import math
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pgen_tpu_torch.cli import main as port_main
from pgen_tpu_torch.formats.fixtures import ensure_chr22
from pgen_tpu_torch.pipeline.king import king_table
from pgen_tpu_torch.pipeline.mesh_filter import filter_to_vcf_mesh
from pgen_tpu_torch.pipeline.pca import pca
from pgen_tpu_torch.utils import timer as timer_mod
from pgen_tpu_torch.utils.timer import StageTimer, book_launch, span

BLOCK = 1000  # three blocks of the 3,000-variant fileset
KING_PARENTS = {"process_group": None, "metadata_load": None, "predicates": None,
                "gather": None, "king_grams": None, "stage_read": "king_grams",
                "h2d": "king_grams", "kernels": "king_grams", "d2h": "king_grams",
                "kinship": None, "king_select": None, "king_emit": None}
PCA_PARENTS = {"process_group": None, "metadata_load": None, "predicates": None,
               "gather": None, "grm": None, "stage_read": "grm", "h2d": "grm",
               "kernels": "grm", "d2h": "grm", "eigh": None, "emit": None}
# the entry's wall outside its outermost spans: the call, the timer and
# the result around them (the collector held off while it is timed), and
# what a loaded host's scheduler adds to the code between them
WALL_SLACK_S, WALL_SLACK_SHARE = 0.005, 0.05


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    return str(ensure_chr22(d, num_variants=3000, num_samples=40, seed=21))


def _king(prefix, out_dir):
    return king_table(prefix, out_file=str(out_dir / "k.kin0"), device="cpu",
                      min_kinship=0.05, block_variants=BLOCK).timer


def _pca(prefix, out_dir):
    return pca(prefix, k=4, out_prefix=str(out_dir / "pc"), device="cpu",
               block_variants=BLOCK).timer


ENTRIES = {"king": (_king, KING_PARENTS), "pca": (_pca, PCA_PARENTS)}


@contextlib.contextmanager
def _no_collection():
    """The garbage collector held off, so that no collection pause falls
    inside what a test times."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()


def _parent_names(timer) -> dict:
    out = {}
    for sp in timer.spans:
        name = None if sp.parent is None else timer.spans[sp.parent].name
        assert out.setdefault(sp.name, name) == name, sp.name
    return out


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_opens_its_stages_under_their_parents(prefix, tmp_path, entry):
    run, parents = ENTRIES[entry]
    timer = run(prefix, tmp_path)
    assert _parent_names(timer) == parents
    assert list(timer.stages) == list(parents)
    blocks = 3
    assert timer.stages["stage_read"].calls == timer.stages["h2d"].calls == blocks
    assert timer.stages["kernels"].calls == blocks
    assert timer.stages["d2h"].calls == 1
    assert timer.stages["metadata_load"].calls == 1


@pytest.mark.parametrize("entry", ENTRIES)
def test_children_lie_inside_their_parents(prefix, tmp_path, entry):
    timer = ENTRIES[entry][0](prefix, tmp_path)
    for sp in timer.spans:
        assert sp.start_ns <= sp.end_ns
        if sp.parent is not None:
            up = timer.spans[sp.parent]
            assert up.start_ns <= sp.start_ns and sp.end_ns <= up.end_ns, (sp, up)


@pytest.mark.parametrize("entry", ENTRIES)
def test_top_level_spans_cover_the_entry_wall(prefix, tmp_path, entry):
    with _no_collection():
        t0 = time.time_ns()
        timer = ENTRIES[entry][0](prefix, tmp_path)
        wall = (time.time_ns() - t0) / 1e9
    top = [sp for sp in timer.spans if sp.parent is None]
    covered = sum(sp.seconds for sp in top)
    assert covered <= wall, (wall, covered)
    assert wall - covered < max(WALL_SLACK_S, WALL_SLACK_SHARE * wall), (wall, covered)
    assert all(a.end_ns <= b.start_ns for a, b in zip(top, top[1:]))


@pytest.mark.parametrize("entry", ENTRIES)
def test_stage_sums_are_their_spans(prefix, tmp_path, entry):
    timer = ENTRIES[entry][0](prefix, tmp_path)
    for name, st in timer.stages.items():
        mine = [sp for sp in timer.spans if sp.name == name]
        assert st.calls == len(mine)
        assert st.seconds == pytest.approx(sum(sp.seconds for sp in mine), rel=1e-12)
        assert st.bytes_moved == sum(sp.nbytes for sp in mine)
        kids = sum(c.seconds for c in timer.spans
                   if c.parent is not None and timer.spans[c.parent].name == name)
        assert st.self_seconds == pytest.approx(st.seconds - kids, rel=1e-9, abs=1e-9)


def _stage_events(prof) -> dict:
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("stage:") and "CUDA" not in str(e.device_type()).upper():
            out.setdefault(e.name().removeprefix("stage:"), []).append(e.start_ns())
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.parametrize("entry", ENTRIES)
def test_spans_share_the_profiler_clock(prefix, tmp_path, entry):
    """Under torch.profiler every span has its ``stage:<name>`` range,
    starting within 1 ms of the span's own stamp."""
    with _no_collection(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm"):  # the profiler's first range
            pass
        timer = ENTRIES[entry][0](prefix, tmp_path)
    events = _stage_events(prof)
    assert set(events) == set(timer.stages)
    for name in timer.stages:
        starts = sorted(sp.start_ns for sp in timer.spans if sp.name == name)
        assert len(events[name]) == len(starts), name
        for ev, sp in zip(events[name], starts):
            assert abs(ev - sp) < 1_000_000, (name, ev - sp)


def test_no_profiler_range_without_a_profiler(prefix, tmp_path, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    timer = _king(prefix, tmp_path)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _king(prefix, tmp_path)
    assert sorted(entered) == sorted(f"stage:{sp.name}" for sp in traced.spans)
    assert len(traced.spans) == len(timer.spans)


def test_span_without_an_open_timer_records_nothing():
    with span("loose", 7) as st:
        book_launch()
    assert st.calls == 0 and st.seconds == 0.0
    assert timer_mod._stack() == []


def test_span_opens_on_the_innermost_timer_of_its_thread():
    outer, inner = StageTimer(), StageTimer()
    seen = {}

    def reader():
        # another thread: none of the main thread's spans is its parent,
        # and span() there sees only what this thread opened
        with span("nothing"):
            pass
        with outer.stage("read"):
            with span("copy"):
                pass
        seen["stack"] = list(timer_mod._stack())

    with outer.stage("job"):
        with inner.stage("step"):
            with span("deep"):
                pass
        with span("shallow"):
            th = threading.Thread(target=reader)
            th.start()
            th.join(timeout=30)
            assert not th.is_alive()
    assert [(s.name, s.parent) for s in inner.spans] == [("step", None), ("deep", 0)]
    names = {s.name: s for s in outer.spans}
    assert set(names) == {"job", "shallow", "read", "copy"}
    assert names["shallow"].parent == 0 and names["read"].parent is None
    assert outer.spans[names["copy"].parent].name == "read"
    assert seen["stack"] == []


def test_launch_books_on_the_innermost_open_span():
    t = StageTimer()
    book_launch()  # no open span: nothing to count on
    with t.stage("grams"):
        book_launch()
        with span("h2d"):
            book_launch()
            book_launch()
        with span("h2d"):
            pass
    assert [(s.name, s.launches) for s in t.spans] == [("grams", 1), ("h2d", 2), ("h2d", 0)]
    assert t.stages["grams"].launches == 1 and t.stages["h2d"].launches == 2
    lines = t.report().splitlines()
    assert lines[0].startswith("grams: ") and lines[0].endswith(", 1 launches")
    assert lines[1].startswith("  h2d: ") and "over 2 calls" in lines[1]


def test_report_indents_children_and_gives_self_time(prefix, tmp_path):
    timer = _king(prefix, tmp_path)
    lines = timer.report().splitlines()
    assert len(lines) == len(timer.stages)
    grams = lines.index(next(ln for ln in lines if ln.startswith("king_grams: ")))
    assert {ln.split(":")[0] for ln in lines[grams + 1 : grams + 5]} == {
        "  stage_read", "  h2d", "  kernels", "  d2h"}
    st = timer.stages["king_grams"]
    assert f"self {st.self_seconds * 1e3:.1f} ms" in lines[grams]


def test_gt_predicate_counts_stage_apart_from_the_filter_loop(prefix, tmp_path):
    """A device-provider filter with GT_* predicates: the counts' staging
    sits in ``predicates`` as ``count_read`` / ``count_h2d``, and the
    filter loop's ``stage_read`` / ``h2d`` hold its own blocks alone, so
    neither is counted twice and each is reported under one parent."""
    vb = 500
    res = filter_to_vcf_mesh(prefix, var_query="GT_AF > 0.2",
                             sam_query="GT_MISSING_RATE < 0.9",
                             out_file=str(tmp_path / "gt.vcf"), device="cpu",
                             block_variants=vb)
    timer, rec = res.timer, 10  # 40 samples, 2 bits each
    assert 0 < res.num_variants_kept < 3000
    parents = _parent_names(timer)
    assert {k: parents[k] for k in ("count_read", "count_h2d", "stage_read", "h2d")} == {
        "count_read": "predicates", "count_h2d": "predicates", "stage_read": None, "h2d": None}
    blocks = math.ceil(res.num_variants_kept / vb)
    assert timer.stages["stage_read"].calls == timer.stages["h2d"].calls == blocks
    assert timer.stages["h2d"].bytes_moved == blocks * vb * rec
    # the sample counts (GT_MISSING_RATE), then the variant counts (GT_AF),
    # each one block of all 3,000 records
    for name in ("count_read", "count_h2d"):
        assert timer.stages[name].calls == 2
        assert timer.stages[name].bytes_moved == 2 * 3000 * rec
    lines = timer.report().splitlines()
    top = [ln.split(":")[0] for ln in lines if not ln.startswith(" ")]
    assert {"predicates", "stage_read", "h2d"} <= set(top)
    pred = lines.index(next(ln for ln in lines if ln.startswith("predicates: ")))
    assert {ln.split(":")[0] for ln in lines[pred + 1 : pred + 3]} == {
        "  count_read", "  count_h2d"}


def test_report_puts_a_stage_of_several_parents_at_the_top():
    t = StageTimer()
    with t.stage("predicates"):
        with t.stage("h2d"):
            pass
    with t.stage("h2d"):
        pass
    with t.stage("grm"):
        with t.stage("d2h"):
            pass
    assert [ln.split(":")[0] for ln in t.report().splitlines()] == [
        "predicates", "h2d", "grm", "  d2h"]


def test_cli_profile_trace_names_the_stages(tmp_path):
    """--profile's Chrome trace holds the program's stage ranges."""
    prefix = str(ensure_chr22(tmp_path, num_variants=200, num_samples=9, seed=4))
    assert port_main(["filter", prefix, "--provider", "device", "--device", "cpu",
                      "--profile", str(tmp_path / "prof"), "-o", str(tmp_path / "a.vcf")]) == 0
    trace = json.loads((tmp_path / "prof" / "rank0.trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"stage:metadata_load", "stage:predicates", "stage:h2d"} <= names


def test_stage_left_open_in_a_generator_closes_late():
    """A generator suspended inside a stage, and closed after the stage
    around it, leaves the thread's stack empty."""
    t = StageTimer()

    def blocks():
        with t.stage("read"):
            yield 1
            yield 2

    gen = blocks()
    with t.stage("job"):
        next(gen)
    gen.close()
    assert timer_mod._stack() == []
    assert [(s.name, s.parent) for s in t.spans] == [("job", None), ("read", 0)]
    assert all(s.end_ns for s in t.spans)
