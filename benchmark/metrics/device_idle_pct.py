"""The share of the traced window in which rank 0's card ran no kernel,
copy or memset, in %."""


def read(run):
    t = run.ranks[0]["trace"]
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
