"""The share of the traced window in which rank 0's card was idle while the
host was inside a job but in none of the program's spans (the trace's
``job`` idle gap), in %."""

from benchmark.trace import TOP


def read(run):
    t = run.ranks[0]["trace"]
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    gaps = dict(t["idle_gaps"])
    if "job" in gaps:
        return 100.0 * gaps["job"] / t["window_s"]
    # a full list may have left a small ``job`` gap out
    return 0.0 if len(gaps) < TOP else None
